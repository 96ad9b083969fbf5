"""The port's JPEG-noise campaign (``tools/jpg_noise_campaign.py``) on the
CPU against the JAX script it ports, ``scripts/jpg_noise_campaign.py``,
loaded from its file: staging, ``epoch_degrade`` and ``val_degrade``,
``libjpeg_degrade_01`` (the JAX side through PIL, the port through its own
encoder and decoder), ``evaluate``'s rows and ``domain_gap`` with the
committed round-4 noise model and its control on a 64 px crop of a
held-out tile, ``_write_markdown`` byte-equal on the committed round-4
results, and a tiny campaign's ``RESULTS_jpg.json`` read back by both
zoos."""

import importlib.util
import itertools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from simplesr_tpu import zoo as jax_zoo
from simplesr_tpu.train import Generator as JaxGenerator
from simplesr_tpu_torch import zoo
from simplesr_tpu_torch.train import Generator

ROOT = Path(__file__).resolve().parents[1]
GALLERY = ROOT / "data/corpus/gallery"
JPG_RQ = ROOT / "results/quality_r4/models/resnet_gen_srresnet_jpg_rq_x2_best.msgpack"
CTL = ROOT / "results/quality_r4/models/resnet_gen_srresnet_ctl_x2_best.msgpack"
LEVEL = 1.0 / 255.0
# evaluate's rows, rounded to 3 / 3 / 4 digits, of the same bf16 model in
# both packages on the same inputs: bf16 convolution sums in another order
# (measured on this crop: at most 0.006 dB of PSNR, 0.016 dB of PSNR-Y and
# 2e-4 of SSIM; the bounds allow about twice that)
ROW_PSNR_TOL = 0.03
ROW_SSIM_TOL = 5e-4
# domain_gap's input PSNR, rounded to 2 digits: the two DCT models differ by
# at most a level at under 1e-3 of the values (test_torch_pipeline.py)
GAP_INPUT_TOL = 0.02
_names = itertools.count()


def _load(path, prefix):
    spec = importlib.util.spec_from_file_location(f"{prefix}_{next(_names)}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_campaign():
    return _load(ROOT / "scripts/jpg_noise_campaign.py", "jax_jpg_campaign")


def port_campaign():
    module = _load(ROOT / "simplesr_tpu_torch/tools/jpg_noise_campaign.py", "port_jpg_campaign")
    module.DEVICE = "cpu"
    return module


@pytest.fixture(autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _window_crops(images, num_crops, patch_size):
    """Stands in for both packages' batch_random_crops (their random
    streams differ): a fixed walk of windows."""
    img = np.asarray(images[0])
    ph, pw = patch_size
    tops = [(k * 37) % (img.shape[0] - ph + 1) for k in range(num_crops)]
    lefts = [(k * 53) % (img.shape[1] - pw + 1) for k in range(num_crops)]
    return np.stack([img[t:t + ph, l:l + pw] for t, l in zip(tops, lefts)])


def test_stage_dataset_matches_jax(tmp_path):
    """The same corpus, crops and split through both: the counts (48 crops
    at least an image, an image below the crop skipped, batches trimmed),
    HR exactly and LR within the resize's float32 sums (2e-6 on [0, 1]).
    The crop draw is stubbed in both (their random streams differ) and the
    augmented copies left out (the same reason; the JAX script's vmap over
    split keys is ``quality_campaign._augmented``)."""
    small = np.asarray(Image.open(GALLERY / "gt_3.png").convert("RGB"))[:20, :20]
    Image.fromarray(small).save(tmp_path / "small.png")
    imgs = {"gt_16": str(GALLERY / "gt_16.png"), "small": str(tmp_path / "small.png"),
            "gt_15": str(GALLERY / "gt_15.png")}
    jq, pq = jax_campaign(), port_campaign()
    for q in (jq, pq):
        q.TRAIN_IMGS, q.AUGS, q.CROP = dict(imgs), [], 32
    jq.batch_random_crops = lambda key, images, num_crops, patch_size: jnp.asarray(
        _window_crops(images, num_crops, patch_size))
    pq.batch_random_crops = lambda gen, images, num_crops, patch_size: torch.from_numpy(
        _window_crops(images.cpu(), num_crops, patch_size))
    (jlr, jhr), (jlv, jhv) = jq.stage_dataset(crops_per_mpix=1, val_crops_per_img=10)
    (plr, phr), (plv, phv) = pq.stage_dataset(crops_per_mpix=1, val_crops_per_img=10)
    assert plr.shape == tuple(jlr.shape) == (96, 16, 16, 3)
    assert phr.shape == tuple(jhr.shape) == (96, 32, 32, 3)
    assert plv.shape == tuple(jlv.shape) == (16, 16, 16, 3)
    np.testing.assert_array_equal(phr.numpy(), np.asarray(jhr))
    np.testing.assert_array_equal(phv.numpy(), np.asarray(jhv))
    np.testing.assert_allclose(plr.numpy(), np.asarray(jlr), rtol=0, atol=2e-6)
    np.testing.assert_allclose(plv.numpy(), np.asarray(jlv), rtol=0, atol=2e-6)


def _within_a_level(got, want):
    """Both on the 8-bit grid (x / 255, which XLA computes as a product):
    a level apart at most, and at under 1e-3 of the values."""
    got, want = np.asarray(got), np.asarray(want)
    levels = np.abs(np.round(got * 255.0) - np.round(want * 255.0))
    assert np.abs(got - want).max() <= LEVEL + 1e-6 and levels.max() <= 1 \
        and (levels > 0).mean() <= 1e-3, (levels.max(), (levels > 0).mean())


def test_epoch_and_val_degrade_match_jax():
    """Each crop's fresh quality U[30, 95) (the port's draw, given to the
    JAX degrade crop by crop), chunked; and the validation's fixed
    30 / 50 / 75 / 90 cycle. The DCT models agree within a level at under
    1e-3 of the values, the bound test_torch_pipeline.py measured."""
    jq, pq = jax_campaign(), port_campaign()
    rng = np.random.default_rng(3)
    lr = rng.uniform(0, 1, (20, 16, 16, 3)).astype(np.float32)
    got = pq.epoch_degrade(torch.Generator().manual_seed(11), torch.from_numpy(lr), chunk=8)
    gen = torch.Generator().manual_seed(11)
    qs = torch.cat([pq.epoch_qualities(gen, n) for n in (8, 8, 4)]).numpy()
    assert qs.min() >= 30.0 and qs.max() < 95.0 and len(set(qs.tolist())) == 20
    want = jax.vmap(jq.jpeg_degrade)(jnp.asarray(lr), jnp.asarray(qs))
    assert got.shape == lr.shape
    _within_a_level(got.numpy(), want)
    _within_a_level(pq.val_degrade(torch.from_numpy(lr)).numpy(),
                    jq.val_degrade(jnp.asarray(lr)))


def test_libjpeg_degrade_01_equals_pil():
    jq, pq = jax_campaign(), port_campaign()
    lr = np.random.default_rng(4).uniform(0, 1, (21, 35, 3)).astype(np.float32)
    for q in (30, 50, 75, 90):
        want = jq.libjpeg_degrade_01(lr, q)
        for x in (lr, torch.from_numpy(lr)):
            got = pq.libjpeg_degrade_01(x, q)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    """A 64 px crop of the held-out tile gt_6."""
    path = tmp_path_factory.mktemp("probe") / "probe.png"
    Image.fromarray(np.asarray(Image.open(GALLERY / "gt_6.png").convert("RGB"))
                    [100:164, 150:214]).save(path)
    return path


class _Generate:
    def __init__(self, fn):
        self.generate = fn


def test_evaluate_and_domain_gap_match_jax(probe):
    """The committed round-4 noise model and its control (bf16, 16 x 64)
    through both campaigns' evaluate on the crop, the JAX side degraded
    through PIL and the port through its own encoder (the same bytes):
    every row within ROW_*_TOL, and domain_gap's input PSNR within
    GAP_INPUT_TOL and its output PSNR within ROW_PSNR_TOL."""
    jq, pq = jax_campaign(), port_campaign()
    for q in (jq, pq):
        q.EVAL_TRAIN_IMGS, q.HELDOUT_IMGS = {}, {"probe": str(probe)}
    jmodels = [JaxGenerator.srresnet(upsample_factor=2, pretrained_model_path=str(p))
               for p in (JPG_RQ, CTL)]
    pmodels = [Generator.srresnet(2, pretrained_model_path=p, device="cpu") for p in (JPG_RQ, CTL)]
    want = jq.domain_gap(jmodels[0], jq.evaluate(*jmodels, {}))
    got = pq.domain_gap(pmodels[0], pq.evaluate(*pmodels, {}))
    rows, want_rows = got["images"]["probe"], want["images"]["probe"]
    assert list(rows) == list(want_rows) == ["heldout", "30", "50", "75", "90", "clean"]
    assert rows["heldout"] is True
    for q in ("30", "50", "75", "90", "clean"):
        assert list(rows[q]) == ["noise_trained", "clean_control", "bicubic"]
        for col, m in rows[q].items():
            w = want_rows[q][col]
            assert list(m) == list(w) == ["psnr", "psnr_y", "ssim"]
            assert abs(m["psnr"] - w["psnr"]) <= ROW_PSNR_TOL, (q, col, m, w)
            assert abs(m["psnr_y"] - w["psnr_y"]) <= ROW_PSNR_TOL, (q, col, m, w)
            assert abs(m["ssim"] - w["ssim"]) <= ROW_SSIM_TOL, (q, col, m, w)
    # the noise model removes what it was trained on: it beats the control
    assert rows["30"]["noise_trained"]["psnr"] > rows["30"]["clean_control"]["psnr"]
    gap, want_gap = got["domain_gap"]["probe"], want["domain_gap"]["probe"]
    assert list(gap) == list(want_gap) == ["30", "50", "75", "90"]
    for q, r in gap.items():
        w = want_gap[q]
        assert abs(r["input_dct_vs_libjpeg_psnr"] - w["input_dct_vs_libjpeg_psnr"]) \
            <= GAP_INPUT_TOL, (q, r, w)
        for k in ("out_psnr_on_libjpeg", "out_psnr_on_dct"):
            assert abs(r[k] - w[k]) <= ROW_PSNR_TOL, (q, k, r, w)


def test_missing_image_skipped_by_name(probe, capsys):
    pq = port_campaign()
    pq.EVAL_TRAIN_IMGS, pq.HELDOUT_IMGS = {}, {"absent": str(probe.parent / "absent.png")}
    identity = _Generate(lambda lr: torch.as_tensor(lr))
    assert pq.evaluate(identity, identity, {})["images"] == {}
    assert pq.domain_gap(identity, {})["domain_gap"] == {}
    assert "skipping absent" in capsys.readouterr().out


def test_write_markdown_is_byte_equal(tmp_path):
    results = json.loads((ROOT / "results/quality_r4/RESULTS_jpg.json").read_text())
    out = {}
    for q, sub in ((jax_campaign(), "jax"), (port_campaign(), "port")):
        q.OUT_DIR = str(tmp_path / sub)
        Path(q.OUT_DIR).mkdir()
        q._write_markdown(results)
        out[sub] = (Path(q.OUT_DIR) / "RESULTS_jpg.md").read_bytes()
    assert out["port"] == out["jax"]
    assert b"## DCT-kernel vs libjpeg domain gap (held-out)" in out["port"]


def test_tiny_campaign_results_read_back_by_both_zoos(tmp_path, probe):
    """``main(fast=True)`` on two small training tiles with 32 px crops:
    both models saved under the JAX script's names, RESULTS_jpg.json in
    the round-4 schema, RESULTS_jpg.md as the JAX script renders the same
    results, and both zoos' held-out metrics of each recipe equal."""
    pq = port_campaign()
    assert pq._parse_cli(["--fast", "--out", str(tmp_path / "r4"), "--device", "cpu"]) == \
        {"fast": True}
    pq.CROP = 32
    pq.TRAIN_IMGS = {k: str(GALLERY / f"{k}.png") for k in ("gt_16", "gt_15")}
    pq.EVAL_TRAIN_IMGS = {"gt_16": pq.TRAIN_IMGS["gt_16"]}
    pq.HELDOUT_IMGS = {"probe": str(probe)}
    results = pq.main(fast=True)
    out = tmp_path / "r4"
    saved = json.loads((out / "RESULTS_jpg.json").read_text())
    assert saved == json.loads(json.dumps(results))
    assert list(saved) == ["scale", "quality_range", "corpus_images", "images", "domain_gap"]
    assert saved["quality_range"] == [30.0, 95.0] and saved["corpus_images"] == 2
    assert [saved["images"][k]["heldout"] for k in ("gt_16", "probe")] == [False, True]
    assert sorted(p.name for p in (out / "models").iterdir()) == [
        "resnet_gen_srresnet_ctl_x2_best.msgpack", "resnet_gen_srresnet_jpg_rq_x2_best.msgpack"]
    jq = jax_campaign()
    jq.OUT_DIR = str(tmp_path / "jax_md")
    Path(jq.OUT_DIR).mkdir()
    jq._write_markdown(saved)
    assert (out / "RESULTS_jpg.md").read_bytes() == \
        (Path(jq.OUT_DIR) / "RESULTS_jpg.md").read_bytes()
    for recipe in ("srresnet_jpg_rq", "srresnet_ctl"):
        got = zoo._heldout_metrics(out, recipe)
        assert got and got == jax_zoo._heldout_metrics(out, recipe), recipe
        assert got["heldout_images"] == 1
    assert zoo._heldout_metrics(out, "srresnet_jpg_rq")["degraded_inputs"] is True
