"""The port's quality gate, GAN smoke and standard-benchmark harness
(``tools/{quality_check,gan_smoke,standard_benchmarks}.py``) on the CPU
against the JAX scripts they port (``scripts/``, loaded from their files):
``bt601_y`` and ``score_pair`` on seeded arrays, ``discover_datasets`` on a
temporary tree, ``evaluate_set`` on both routes with the same float32 model,
the anchors, the exit code without data; few-step tiny runs of the gate and
the GAN smoke with the JAX scripts' printed lines and metric names; and the
SRResNet output conv's initialiser, repaired to flax's."""

import importlib.util
import itertools
import json
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from simplesr_tpu.eval.evaluation import _as_predictor as jax_as_predictor
from simplesr_tpu.train.generator import Generator as JaxGenerator
from simplesr_tpu.train.serialization import save_model as jax_save_model
from simplesr_tpu_torch.eval.evaluation import _as_predictor
from simplesr_tpu_torch.models.srresnet import SRResNet
from simplesr_tpu_torch.tools import gan_smoke, quality_check
from simplesr_tpu_torch.tools import standard_benchmarks as sb

ROOT = Path(__file__).resolve().parents[1]
GALLERY = ROOT / "data/corpus/gallery"
_names = itertools.count()


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}_{next(_names)}",
                                                  ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads a test: the suite's workers share the cores,
    and the bf16 convolutions slow down steeply when oversubscribed."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jsb():
    return _jax_script("standard_benchmarks")


@pytest.fixture(scope="module")
def tiny_x2(tmp_path_factory):
    """A 1-block 8-filter float32 SRResNet x2 saved by the JAX package."""
    gen = JaxGenerator.srresnet(upsample_factor=2, num_blocks=1, num_filters=8,
                                batch_norm=False, dtype=jnp.float32, input_dims=(16, 16))
    path = tmp_path_factory.mktemp("tiny") / "tiny_x2.msgpack"
    jax_save_model(gen.module_config(), gen.variables, str(path))
    return path


def test_bt601_y_and_score_pair_match_jax(jsb):
    """Y in [16, 235] within float32 sums (1e-4); the protocol's PSNR-Y and
    SSIM-Y within 1e-3 dB and 1e-5: both quantise to uint8 first, so the
    inputs to the metrics are the same."""
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (37, 41, 3)).astype(np.float32)
    np.testing.assert_allclose(sb.bt601_y(torch.from_numpy(img)).numpy(),
                               np.asarray(jsb.bt601_y(jnp.asarray(img))), rtol=0, atol=1e-4)
    assert float(sb.bt601_y(torch.ones(2, 2, 3))[0, 0, 0]) == pytest.approx(235.0, abs=1e-3)
    for scale in (2, 4):
        hr = rng.uniform(0, 1, (48, 52, 3)).astype(np.float32)
        sr = np.clip(hr + rng.normal(0, 0.05, hr.shape), -0.1, 1.1).astype(np.float32)
        got = sb.score_pair(torch.from_numpy(sr), torch.from_numpy(hr), scale)
        want = jsb.score_pair(jnp.asarray(sr), jnp.asarray(hr), scale)
        assert got["psnr_y"] == pytest.approx(want["psnr_y"], abs=1e-3)
        assert got["ssim_y"] == pytest.approx(want["ssim_y"], abs=1e-5)
    same = sb.score_pair(torch.from_numpy(img), torch.from_numpy(img), 2)
    assert math.isinf(same["psnr_y"]) and same["ssim_y"] == pytest.approx(1.0, abs=1e-5)


def test_discover_datasets_matches_jax(tmp_path, jsb):
    rng = np.random.default_rng(1)
    for set_dir, names in (("set14", ["a.png", "a_LR.png", "b.BMP", "c.jpg", "notes.txt"]),
                           ("SET5", ["x.png"]), ("Urban100", []), ("other", ["y.png"])):
        (tmp_path / set_dir).mkdir()
        for name in names:
            path = tmp_path / set_dir / name
            if name.endswith(".txt"):
                path.write_text("-")
            else:
                Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).save(
                    path, format={"png": "PNG", "bmp": "BMP", "jpg": "JPEG"}[name[-3:].lower()])
    got = sb.discover_datasets(tmp_path)
    assert got == jsb.discover_datasets(tmp_path)
    assert {k: [p.name for p in v] for k, v in got.items()} == \
        {"Set5": ["x.png"], "Set14": ["a.png", "b.BMP", "c.jpg"]}


def test_exit_code_2_without_data(tmp_path, capsys, jsb):
    assert sb.run(scale=4, data_root=tmp_path / "nope") == 2
    assert "Mount the HR images" in capsys.readouterr().err
    assert sb.main(["--data-root", str(tmp_path / "nope")]) == 2
    assert jsb.run(scale=4, data_root=tmp_path / "nope") == 2


def test_anchors_match_jax(jsb):
    assert sb.ANCHORS_X4 == jsb.ANCHORS_X4 and sb.KNOWN_SETS == jsb.KNOWN_SETS
    for args in (("srresnet_x4", "Set5", 4), ("bicubic", "Set14", 4), ("srresnet_x4", "Set5", 2),
                 ("unknown", "Set5", 4), ("rrdb_x4@quality_r5", "Set14", 4)):
        assert sb._anchor_for(*args) == jsb._anchor_for(*args)


def test_evaluate_set_both_routes_match_jax(tmp_path, tiny_x2, jsb):
    """One image under the threshold, one over it (the tiled route, 128 px
    tiles, 32 px overlap), the same float32 model in both packages: every
    per-image score within 0.01 dB and 1e-4 (the uint8 quantisation can
    flip a pixel on a float32 difference), a BMP read as its PNG is."""
    rng = np.random.default_rng(3)
    imgs = []
    for name, (h, w), fmt in (("small", (60, 76), "PNG"), ("big", (300, 288), "BMP")):
        path = tmp_path / f"{name}.{fmt.lower()}"
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(path, format=fmt)
        imgs.append(path)
    got = sb.evaluate_set(imgs, {"bicubic": None, "m": _as_predictor(tiny_x2, device="cpu")},
                          2, tile_threshold=140, device="cpu")
    want = jsb.evaluate_set(imgs, {"bicubic": None, "m": jax_as_predictor(str(tiny_x2))},
                            2, tile_threshold=140)
    for label in ("bicubic", "m"):
        assert got[label]["images"] == want[label]["images"] == 2
        for a, b in zip(got[label]["per_image"], want[label]["per_image"]):
            assert a["image"] == b["image"]
            assert abs(a["psnr_y"] - b["psnr_y"]) <= 0.01 and abs(a["ssim_y"] - b["ssim_y"]) \
                <= 1e-3 + 1e-4, (label, a, b)  # per-image SSIM-Y is rounded to 3 digits


def test_run_writes_the_reports(tmp_path, tiny_x2):
    (tmp_path / "data" / "Set5").mkdir(parents=True)
    crop = np.asarray(Image.open(GALLERY / "gt_6.png").convert("RGB"))[:64, :80]
    Image.fromarray(crop).save(tmp_path / "data" / "Set5" / "gt_6.bmp")
    out = tmp_path / "out"
    assert sb.main(["--scale", "2", "--models", str(tiny_x2), "--data-root",
                    str(tmp_path / "data"), "--out", str(out), "--device", "cpu"]) == 0
    results = json.loads((out / "STANDARD.json").read_text())
    assert results["scale"] == 2 and list(results["sets"]["Set5"]) == ["bicubic", str(tiny_x2)]
    for row in results["sets"]["Set5"].values():
        assert row["images"] == 1 and math.isfinite(row["psnr_y"]) and 0 < row["ssim_y"] <= 1
    assert "| Set5 | bicubic |" in (out / "STANDARD.md").read_text()


def test_quality_check_tiny_on_the_cpu(capsys):
    """A few steps of the gate: the JAX script's printed lines, a train
    member and the four held-out tiles, finite numbers."""
    out = quality_check.main(steps=2, scale=2, tiny=True, device="cpu")
    printed = capsys.readouterr().out
    assert out["steps"] == 2 and out["train_s"] > 0
    assert list(out["images"]) == ["train-member gt_11.png x2"] + [
        f"held-out {n}.png (unseen) x2" for n in ("gt_1", "gt_10", "gt_13", "gt_6")]
    line = re.compile(r"^(train-member|held-out) .*: model PSNR [\d.]+ SSIM -?[\d.]+ \| "
                      r"bicubic PSNR [\d.]+ SSIM [\d.]+ \| (BEATS|BELOW)_BICUBIC$", re.M)
    assert len(line.findall(printed)) == 5
    for row in out["images"].values():
        assert all(math.isfinite(v) for k, v in row.items() if k != "heldout")
    assert quality_check._parse_cli(["100", "4", "--device", "cpu"]) == \
        {"steps": 100, "scale": 4, "tiny": False, "device": "cpu"}


def test_gan_smoke_tiny_on_the_cpu(capsys):
    """A few GAN steps: the JAX script's metric names and verdict line."""
    out = gan_smoke.main(steps=3, tiny=True, device="cpu")
    printed = capsys.readouterr().out
    assert set(out["generator"]) >= {"generator_loss", "adversarial_loss"}
    assert set(out["discriminator"]) == {"discriminator_loss", "discriminator_accuracy",
                                         "SR_accuracy", "HR_accuracy"}
    assert all(math.isfinite(v) for v in [*out["generator"].values(),
                                          *out["discriminator"].values()])
    assert printed.strip().splitlines()[-1] == ("GAN_STABLE" if out["stable"] else
                                                "GAN_UNSTABLE")
    assert gan_smoke.CROP_SOURCE.endswith("gallery/gt_11.png")


def test_srresnet_output_conv_init_is_flax_lecun_normal():
    """The JAX SRResNet's 9 x 9 output conv keeps flax's default init,
    lecun_normal (a normal truncated at 2 sigma with variance 1 / fan_in);
    the port drew it glorot-uniform, 1.38x the spread. Both spreads within
    3 % of each other (35,000 draws each), and the truncation."""
    torch.manual_seed(0)
    w = SRResNet(upsample_factor=2, num_filters=64, num_res_blocks=1, batch_norm=False,
                 dtype=torch.float32).out.weight.detach().numpy()
    ref = np.asarray(jax.nn.initializers.lecun_normal()(jax.random.key(0), (9, 9, 64, 3)))
    assert w.shape == (3, 64, 9, 9)
    assert w.std() == pytest.approx(ref.std(), rel=0.03)
    bound = 2 * math.sqrt(1 / (9 * 9 * 64)) / 0.87962566103423978
    assert np.abs(w).max() <= bound and np.abs(ref).max() <= bound * (1 + 1e-6)
