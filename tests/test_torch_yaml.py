"""The port's YAML reader (``config/_yaml.py``) against PyYAML's
``SafeLoader``, as simplesr_tpu.config.yaml_helper uses it: every YAML file
under examples/ parses equal, a table of edge scalars resolves to the same
value and type (YAML 1.1), and what lies outside the subset raises with its
line number. ``dump`` writes documents that read back equal."""

import math
from pathlib import Path

import pytest
import yaml

from simplesr_tpu.config.yaml_helper import _Loader, load_yaml
from simplesr_tpu_torch.config import _yaml
from simplesr_tpu_torch.config import yaml_helper

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = sorted((ROOT / "examples").rglob("*.yaml"))

EDGE_SCALARS = [
    "1.0e-4", "1e-4", "1.0e4", "1.0E-4", "1.0E+4", "6.25e-6", "1e+4", "+1.5e-3", ".5", "1.",
    "0.", "1_0.5", "3.14_15", "-.inf", "+.inf", ".inf", "-.INF", ".NaN", ".nan", "0.1.2",
    "yes", "Yes", "YES", "No", "no", "ON", "on", "off", "Off", "true", "True", "TRUE",
    "false", "tRue", "y", "n", "~", "null", "Null", "NULL", "", "nulL",
    "0", "-0", "+12", "-1", "010", "07", "08", "09.5", "0_7", "0o10", "0x1F", "0xFF_ff",
    "-0x10", "0b101", "+0b11", "0b1_0", "1_000", "1__0", "-1_0", "1:30", "-1:30",
    "190:20:30.15", "abc", "a#b", "x # a comment", "/data/DIV2K/DIV2K_train_HR",
    "./data/results", "block5_conv4", "tcp://localhost:1", "'quoted'", "'it''s'",
    "'a # b'", '"1.0"', '"dq\\t1"', '"\\u00e9\\x41"', "''", '""',
    "[1, 2.0e-1, yes, 'a', [x, ~]]", "[]", "[flip_along_x, flip_along_y, rotate90]",
    "!!python/tuple [96, 96, 3]", "!!python/tuple []",
]


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_same, a, b))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_examples_parse_as_pyyaml(path):
    got = yaml_helper.load_yaml(str(path))
    assert got == load_yaml(str(path))
    assert _yaml.loads(_yaml.dump(got)) == got


def test_edge_scalars_resolve_as_safe_loader():
    for text in EDGE_SCALARS:
        src = f"k: {text}\n"
        got = _yaml.loads(src)["k"]
        ref = yaml.load(src, Loader=_Loader)["k"]
        assert _same(got, ref), (text, got, ref)
        assert _same(_yaml.loads(_yaml.dump({"k": got}))["k"], got), text


def test_block_structures_parse_as_pyyaml():
    src = """# a comment
top:
  - a
  - - nested
    - 2
  - key: 1
    other: [x, y]  # trailing
  -
    late: 3
  - !!python/tuple
    - 4
    - 5
same_indent:
- 1
- two
"quoted key": 'v'
1: one
yes: bool key
empty:
deep:
  deeper:
    deepest: ~
"""
    assert _yaml.loads(src) == yaml.load(src, Loader=_Loader)


@pytest.mark.parametrize("src,line", [
    ("a: 1\nb: 2001-12-14\n", 2), ("a: &x 1\n", 1), ("a: *x\n", 1), ("a: |\n  t\n", 1),
    ("a: {b: 1}\n", 1), ("a: !!str x\n", 1), ("a: b: c\n", 1), ("a: [1, 2\n", 1),
    ("---\na: 1\n", 1), ("a: 1\n  b: 2\n", 2), ("a:\n\tb: 1\n", 2), ("a: 'open\n", 1),
    ("a: 1\nplain line\n", 2), ("a: <<\n", 1), ("a: \"\\q\"\n", 1),
])
def test_outside_the_subset_raises_with_line(src, line):
    with pytest.raises(_yaml.YAMLError) as info:
        _yaml.loads(src)
    assert info.value.line == line
    assert str(info.value).startswith(f"line {line}:")


def test_helpers_match_jax(tmp_path):
    spec = yaml_helper.load_yaml(str(ROOT / "examples/training/srresnet_x4.yaml"))
    assert yaml_helper.load_yaml(spec) is spec
    (loss,) = yaml_helper.init_loss_functions_from_yaml(spec["model"]["generator"])
    assert type(loss).__name__ == "MeanSquaredError"
    with pytest.raises(ValueError, match="unknown loss function"):
        yaml_helper.init_loss_functions_from_yaml({"loss_functions": [{"loss_function": "X"}]})
    with pytest.raises(ValueError, match="unknown augmentation"):
        yaml_helper.init_augmentations({"general": {"augmentations": ["spin"]}})
    conf = {"general": {"resize_filter": "BICUBIC"}}
    assert yaml_helper.prepare_for_evaluation_config(conf)["general"]["resize_filter"] == \
        "bicubic"
    assert yaml_helper.string_to_lib_object("torch.nn", ["Conv2d"]).__name__ == "Conv2d"
    with pytest.raises(ValueError, match="torch namespace"):
        yaml_helper.string_to_lib_object("os", ["path"])
