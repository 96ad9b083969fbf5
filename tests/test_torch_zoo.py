"""The port's model zoo and network interpolation against simplesr_tpu's:
the registry over the committed ``results/`` field by field, ``zoo:`` specs,
and ``interpolate_models`` leaf for leaf with byte-equal files."""

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from simplesr_tpu import zoo as jax_zoo
from simplesr_tpu.tools.interpolate import interpolate_models as jax_interpolate_models
from simplesr_tpu.train.serialization import save_model as jax_save_model
from simplesr_tpu_torch import zoo
from simplesr_tpu_torch.tools import interpolate
from simplesr_tpu_torch.train import load_payload, save_model

ROOT = Path(__file__).resolve().parents[1]
PSNR = ROOT / "results/quality_r4/models/resnet_gen_srresnet_x4_best.msgpack"
GAN = ROOT / "results/quality_r4/models/gan_gen_srgan_x4_final.msgpack"
RRDB = ROOT / "results/quality_r4/models/resnet_gen_rrdb_x4_best.msgpack"


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_registry_matches_jax_field_by_field():
    got = [dataclasses.asdict(e) for e in zoo.list_models()]
    ref = [dataclasses.asdict(e) for e in jax_zoo.list_models()]
    assert len(got) == len(ref) > 10
    assert got == ref
    for name in ("srresnet_x4", "rrdb_x4@quality_r2_x4_deep", "esrgan_lp_x2"):
        assert dataclasses.asdict(zoo.describe(name)) == dataclasses.asdict(jax_zoo.describe(name))
    assert zoo.describe("nothing_x9") is None
    with pytest.raises(KeyError, match="srresnet_x4"):
        zoo.resolve("nothing_x9")
    assert zoo.main([]) == 0


def test_zoo_specs_load(tmp_path):
    entry = zoo.describe("srresnet_x2")
    config, variables = load_payload(f"zoo:{entry.name}")
    ref_config, ref_variables = load_payload(entry.path)
    assert config == ref_config
    for (path, leaf), (_, ref) in zip(_leaves(variables), _leaves(ref_variables)):
        np.testing.assert_array_equal(leaf, ref, err_msg="/".join(path))
    predict = zoo.load("srresnet_x2", device="cpu")
    x = torch.rand((1, 8, 10, 3), generator=torch.Generator().manual_seed(0))
    sr = predict(x)
    assert sr.shape == (1, 16, 20, 3) and torch.isfinite(sr).all()
    torch.testing.assert_close(zoo.load_raw("srresnet_x2", device="cpu")(x), sr,
                               rtol=0, atol=1e-2)  # training form vs serving form at bf16
    assert zoo.main(["--root", str(tmp_path)]) == 1  # an empty registry


@pytest.mark.parametrize("alpha", [0.0, 0.3, 1.0])
def test_interpolation_matches_jax_leaf_for_leaf(alpha, tmp_path):
    cfg, blended = interpolate.interpolate_models(PSNR, GAN, alpha)
    ref_cfg, ref = jax_interpolate_models(str(PSNR), str(GAN), alpha)
    assert cfg == ref_cfg
    got_leaves, ref_leaves = list(_leaves(blended)), list(_leaves(jax.device_get(ref)))
    assert [p for p, _ in got_leaves] == [p for p, _ in ref_leaves]
    for (path, g), (_, r) in zip(got_leaves, ref_leaves):
        assert g.dtype == np.asarray(r).dtype
        np.testing.assert_array_equal(g, np.asarray(r), err_msg="/".join(path))
    save_model(cfg, blended, tmp_path / "port.msgpack")
    jax_save_model(ref_cfg, ref, str(tmp_path / "jax.msgpack"))
    assert (tmp_path / "port.msgpack").read_bytes() == (tmp_path / "jax.msgpack").read_bytes()
    if alpha in (0.0, 1.0):  # the endpoints come back
        _, end = load_payload(PSNR if alpha == 0.0 else GAN)
        for (path, g), (_, e) in zip(sorted(_leaves(blended)), sorted(_leaves(end))):
            np.testing.assert_array_equal(g, e, err_msg="/".join(path))


def test_interpolation_cli_and_mismatched_architectures(tmp_path, capsys):
    outs = interpolate.main(["--psnr", str(PSNR), "--gan", str(GAN), "--alpha", "0.2", "0.8",
                             "--output", str(tmp_path) + "/"])
    assert [Path(o).name for o in outs] == ["gan_gen_srgan_x4_final_a0.2.msgpack",
                                            "gan_gen_srgan_x4_final_a0.8.msgpack"]
    with pytest.raises(ValueError, match="architectures differ"):
        interpolate.interpolate_models(PSNR, RRDB, 0.5)
    with pytest.raises(SystemExit):
        interpolate.main(["--psnr", str(PSNR), "--gan", str(GAN), "--alpha", "1.5",
                          "--output", str(tmp_path / "x.msgpack")])
    tree = {"params": {"a": np.ones(3, np.float32), "step": np.array(3)}}
    other = {"params": {"a": np.zeros(3, np.float32), "step": np.array(7)}}
    blended = interpolate._tree_blend(tree, other, 0.25)
    np.testing.assert_array_equal(blended["params"]["a"], np.full(3, 0.75, np.float32))
    assert blended["params"]["step"] == 7  # a non-float leaf comes from the GAN model
    with pytest.raises(ValueError, match="shape mismatch"):
        interpolate._tree_blend(tree, {"params": {"a": np.ones(4), "step": 1}}, 0.5)
