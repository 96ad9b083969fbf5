"""The port's quality campaign (``tools/quality_campaign.py``) on the CPU
against the JAX script it ports, ``scripts/quality_campaign.py``, loaded
from its file: ``_pairs``, ``_full_image_sr`` and ``evaluate``'s row with
LP on a gallery crop (a 2-block 16-filter float32 generator, the JAX
model's weights carried over by the shared model file), ``build_model
--tiny`` for all eight architectures, ``_parse_cli``, and
``_write_markdown`` byte-equal on two committed campaigns. Port only: the
corpus split, the flagship re-scored on gt_6 against its RESULTS.json row
at the bounds phase 16 holds the card to, and a few-step tiny campaign."""

import importlib.util
import itertools
import json
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from simplesr_tpu.train.generator import Generator as JaxGenerator
from simplesr_tpu.train.serialization import load_model as jax_load_model
from simplesr_tpu.train.serialization import save_model as jax_save_model
from simplesr_tpu_torch.train import Generator
from simplesr_tpu_torch.train.serialization import load_model

import chip_smoke

ROOT = Path(__file__).resolve().parents[1]
GALLERY = ROOT / "data/corpus/gallery"
FLAGSHIP = ROOT / "results/quality_fastrecipe/models/resnet_gen_srresnet_x4_best.msgpack"
_names = itertools.count()


def _load(path, prefix):
    """A fresh copy of a module from its file (its globals at their
    defaults)."""
    spec = importlib.util.spec_from_file_location(f"{prefix}_{next(_names)}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_campaign():
    return _load(ROOT / "scripts/quality_campaign.py", "jax_quality_campaign")


def port_campaign():
    module = _load(ROOT / "simplesr_tpu_torch/tools/quality_campaign.py",
                   "port_quality_campaign")
    module.DEVICE = "cpu"
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
def tiny_x2(tmp_path_factory):
    """A 2-block 16-filter float32 SRResNet x2 saved by the JAX package, as
    both campaigns' srresnet stage (their LP extractor)."""
    gen = JaxGenerator.srresnet(upsample_factor=2, num_blocks=2, num_filters=16,
                                batch_norm=False, dtype=jnp.float32, input_dims=(48, 48))
    path = tmp_path_factory.mktemp("tiny") / "resnet_gen_srresnet_x2_best.msgpack"
    jax_save_model(gen.module_config(), gen.variables, str(path))
    return path


def test_pairs_match_jax():
    """LR by the antialiased bicubic resize, HR to [-1, 1]; float32 sums of
    a separable resize in another order: 2e-6 on [0, 1]."""
    jq, pq = jax_campaign(), port_campaign()
    img = np.asarray(Image.open(GALLERY / "gt_3.png").convert("RGB"), np.float32)
    crops = np.stack([img[t:t + 96, l:l + 96] for t, l in ((0, 0), (11, 97), (128, 250))])
    jlr, jhr = jq._pairs(jnp.asarray(crops))
    plr, phr = pq._pairs(torch.from_numpy(crops))
    assert plr.shape == (3, 48, 48, 3) and plr.dtype == phr.dtype == torch.float32
    np.testing.assert_allclose(plr.numpy(), np.asarray(jlr), rtol=0, atol=2e-6)
    np.testing.assert_allclose(phr.numpy(), np.asarray(jhr), rtol=0, atol=1e-7)


class _Generate:
    """A model with ``generate``, as the campaigns' evaluate takes one."""

    def __init__(self, fn):
        self.generate = fn


def test_full_image_sr_and_evaluate_row_match_jax(tmp_path, tiny_x2):
    """The same float32 model through both packages on a gallery crop: the
    four images of ``_full_image_sr`` within float32 conv sums (1e-4 on
    [-1, 1]) and every number of the row, with LP, within one step of its
    rounding (3 / 3 / 4 / 5 digits)."""
    crop = np.asarray(Image.open(GALLERY / "gt_6.png").convert("RGB"))[40:141, 60:191]
    src = tmp_path / "crop.png"
    Image.fromarray(crop).save(src)
    jq, pq = jax_campaign(), port_campaign()
    for q, sub in ((jq, "jax"), (pq, "port")):
        (tmp_path / sub / "models").mkdir(parents=True)
        (tmp_path / sub / "models" / tiny_x2.name).write_bytes(tiny_x2.read_bytes())
        q.OUT_DIR, q.EVAL_TRAIN_IMGS, q.HELDOUT_IMGS = str(tmp_path / sub), {}, {"crop": str(src)}
    jmodule, jvars = jax_load_model(str(tiny_x2))
    jmodel = _Generate(lambda lr: jmodule.apply(jvars, lr, train=False))
    module = load_model(tiny_x2, device="cpu")

    def generate(lr):
        with torch.no_grad():
            return module(lr)

    pmodel = _Generate(generate)
    img = crop.astype(np.float32) / 255.0
    for got, want in zip(pq._full_image_sr(pmodel, img), jq._full_image_sr(jmodel, img)):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    prow = pq.evaluate(pmodel, "srresnet", {})["srresnet"]["crop"]
    jrow = jq.evaluate(jmodel, "srresnet", {})["srresnet"]["crop"]
    assert prow["heldout"] is jrow["heldout"] is True
    steps = {"psnr": 1e-3, "psnr_y": 1e-3, "ssim": 1e-4, "lp": 1e-5}
    for tag in ("model", "bicubic"):
        assert set(prow[tag]) == set(jrow[tag]) == set(steps)
        for k, step in steps.items():
            assert abs(prow[tag][k] - jrow[tag][k]) <= step * 1.0001, (tag, k, prow, jrow)


ARCHS = ["srresnet", "srresnet128", "rrdb", "rrdb_wide", "srgan", "srgan_lp", "esrgan",
         "esrgan_lp"]


class _Net:
    """Stands in for a JAX network whose eager ``init`` would compile for
    seconds on the CPU; it records the network's arguments."""

    def __init__(self, **kw):
        self.kw = kw

    def init(self, *args, **kw):
        return {}


def _recorded(module, monkeypatch):
    """Record the ``SRModel`` keyword arguments of ``module``'s build_model."""
    calls = []
    monkeypatch.setattr(module, "SRModel", lambda **kw: calls.append(kw) or kw)
    return calls


def _schedule(lr):
    """A learning-rate schedule's values around its boundaries, in float32
    (optax's schedule may give float32 arrays, the port's Python floats)."""
    return [float(np.float32(lr(step))) for step in (0, 50, 51, 75, 76, 100)] \
        if callable(lr) else lr


def test_build_model_tiny_matches_jax(tmp_path, tiny_x2, monkeypatch):
    """Each architecture's tiny stage builds the same SRModel: the model
    type, the generator's module_config and loss metric names, the
    optimizers and schedule, the critic's kind, smoothing and width, and
    for the LP stages the calibrated loss weight (float32 sums: rtol
    1e-4). The JAX networks' parameter init is stubbed (it compiles for
    many seconds per architecture here); its Generator and Discriminator
    wrappers are the real ones."""
    import simplesr_tpu.train.discriminator as jax_disc
    import simplesr_tpu.train.generator as jax_gen

    monkeypatch.setattr(jax_gen, "build_generator_model", lambda **kw: _Net(**kw))
    monkeypatch.setattr(jax_disc, "DiscriminatorNet", _Net)
    jq, pq = jax_campaign(), port_campaign()
    jcalls, pcalls = _recorded(jq, monkeypatch), _recorded(pq, monkeypatch)
    rng = np.random.default_rng(0)
    lr = rng.uniform(0, 1, (2, 48, 48, 3)).astype(np.float32)
    hr = rng.uniform(-1, 1, (2, 96, 96, 3)).astype(np.float32)
    for arch in ARCHS:
        lp = arch.endswith("_lp")
        kw = dict(lp_extractor=str(tiny_x2)) if lp else {}
        jq.build_model(arch, str(tmp_path / f"j_{arch}"), 8, 100, tiny=True,
                       lp_calib=(jnp.asarray(lr), jnp.asarray(hr)) if lp else None, **kw)
        pq.build_model(arch, str(tmp_path / f"p_{arch}"), 8, 100, tiny=True,
                       lp_calib=(torch.from_numpy(lr), torch.from_numpy(hr)) if lp else None,
                       **kw)
        j, p = jcalls[-1], pcalls[-1]
        assert p["model_type"] == j["model_type"] == ("gan" if "gan" in arch else "resnet")
        jg, pg = j["generator"], p["generator"]
        assert pg.module_config() == jg.module_config(), arch
        assert list(pg.batch_metrics().metrics) == list(jg.batch_metrics().metrics), arch
        for key in ("generator_optimizer", "discriminator_optimizer", "paired_ways",
                    "resnet_checkpoint", "distill"):
            assert p.get(key) == j.get(key), (arch, key)
        for key in ("generator_optimizer_config", "discriminator_optimizer_config"):
            assert {k: _schedule(v) for k, v in (p.get(key) or {}).items()} == \
                {k: _schedule(v) for k, v in (j.get(key) or {}).items()}, (arch, key)
        if j["model_type"] == "gan":
            jd, pd = j["discriminator"], p["discriminator"]
            for attr in ("_relativistic", "_label_smoothing", "_smoothing_offset",
                         "_input_dims"):
                assert getattr(pd, attr) == getattr(jd, attr), (arch, attr)
            assert list(pd.batch_metrics().metrics) == list(jd.batch_metrics().metrics)
            assert pd.model().ConvLayer_0.conv.out_channels == jd._module.kw["num_filters"]
        if lp:
            (jlp,) = [f for f in jg.loss_functions() if hasattr(f, "feature_scale")]
            (plp,) = [f for f in pg._loss_functions if hasattr(f, "feature_scale")]
            assert plp.loss_weight == pytest.approx(jlp.loss_weight, rel=1e-4), arch
    with pytest.raises(ValueError):
        pq.build_model("vgg", str(tmp_path), 8, 100)


def _argvs(tmp_path):
    teacher = tmp_path / "teacher.msgpack"
    teacher.write_bytes(b"")
    return [[], ["--fast"], ["--tiny"], ["--scale", "4"], ["--scale", "3"],
            ["--scale", "8", "--crop", "192", "--batch", "8"],
            ["--scale", "4", "--crop", "130"], ["--paired", "1"], ["--paired", "3"],
            ["--paired", "2", "--remat", "--rrdb-blocks", "16", "--epochs", "5"],
            ["--distill", f"{teacher}:0.5"], ["--distill", str(teacher)],
            ["--distill", str(tmp_path / "absent.msgpack")],
            ["--pixel", "srresnet,rrdb_wide", "--gan", "srgan:r2:srresnet,esrgan:out:rrdb"],
            ["--pixel", "none", "--gan", "none"], ["--gan", "srgan"],
            ["--no-gallery-corpus"], ["--legacy-holdout"], ["--out", str(tmp_path / "o")]]


GLOBALS = ("SCALE", "CROP", "BATCH", "RRDB_BLOCKS", "MAX_EPOCHS", "REMAT", "DISTILL", "PAIRED")


def test_parse_cli_matches_jax(tmp_path):
    """Each argv gives the same kwargs and globals, or the same SystemExit.
    Where they differ by design: OUT_DIR's default lies under the
    git-ignored runs/ (its name is the JAX script's), and without a
    checkout of the reference neither package's reference images exist, so
    the gallery part of the corpus is compared."""
    for argv in _argvs(tmp_path):
        jq, pq = jax_campaign(), port_campaign()
        try:
            want = jq._parse_cli(list(argv))
        except SystemExit as e:
            with pytest.raises(SystemExit) as got:
                pq._parse_cli(list(argv))
            assert str(got.value) == str(e), argv
            continue
        assert pq._parse_cli(list(argv)) == want, argv
        for name in GLOBALS:
            assert getattr(pq, name) == getattr(jq, name), (argv, name)
        if "--out" in argv:
            assert pq.OUT_DIR == jq.OUT_DIR
        else:
            assert Path(pq.OUT_DIR).name == Path(jq.OUT_DIR).name
            assert Path(pq.OUT_DIR).parent == ROOT / "runs"
        for corpus in ("TRAIN_IMGS", "HELDOUT_IMGS"):
            gallery = {k: v for k, v in getattr(jq, corpus).items() if k.startswith("gt_")}
            assert getattr(pq, corpus) == gallery, (argv, corpus)
    pq = port_campaign()
    pq.DEVICE = "cuda"
    assert pq._parse_cli(["--device", "cpu"]) == {"fast": False, "tiny": False}
    assert pq.DEVICE == "cpu"


@pytest.mark.parametrize("campaign", ["quality_fastrecipe", "quality_r5"])
def test_write_markdown_is_byte_equal(tmp_path, campaign):
    results = json.loads((ROOT / "results" / campaign / "RESULTS.json").read_text())
    out = {}
    for q, sub in ((jax_campaign(), "jax"), (port_campaign(), "port")):
        q.SCALE, q.OUT_DIR = results["scale"], str(tmp_path / sub / campaign)
        Path(q.OUT_DIR).mkdir(parents=True)
        q._write_markdown(results)
        out[sub] = (Path(q.OUT_DIR) / "RESULTS.md").read_bytes()
    assert out["port"] == out["jax"]
    assert b"| srresnet | gt_6 (held-out) | model |" in out["port"]


def test_corpus_split_never_trains_on_a_heldout_tile(tmp_path, monkeypatch):
    pq = port_campaign()
    train, heldout, members = pq.corpus_split(reference=tmp_path / "absent")
    assert len(train) == 12 and sorted(heldout) == sorted(pq.HELDOUT_GALLERY)
    assert not set(train) & set(heldout) and members == {"gt_11": train["gt_11"]}
    ref = tmp_path / "reference"
    ref.mkdir()
    train, heldout, members = pq.corpus_split(reference=ref)
    assert list(members) == ["div2k_0004", "div2k_0006", "lena"]
    assert {"baboon", "comic"} <= set(heldout) and not set(train) & set(heldout)
    # stage_dataset reads the training images and nothing else
    read = []
    monkeypatch.setattr(pq, "read_img", lambda p: read.append(p) or np.zeros((100, 100, 3),
                                                                             np.float32))
    (lr, hr), (lr_v, hr_v) = pq.stage_dataset(crops_per_mpix=1, val_crops_per_img=1)
    assert sorted(read) == sorted(pq.TRAIN_IMGS.values())
    assert not set(read) & set(pq.HELDOUT_IMGS.values())
    assert lr.shape == (12 * 48 * 4, 48, 48, 3) and hr.shape == (12 * 48 * 4, 96, 96, 3)
    assert lr_v.shape[0] == 0  # 12 validation crops make no batch of 16


def test_flagship_rescored_on_gt6_within_the_phase16_bounds():
    """The flagship through the port's evaluate on the CPU against its
    RESULTS.json row (the JAX campaign's, on a TPU in bf16), at the bounds
    ``chip_smoke.py`` phase 16 holds the card to."""
    pq = port_campaign()
    pq.SCALE, pq.OUT_DIR = 4, str(ROOT / "results/quality_fastrecipe")
    pq.EVAL_TRAIN_IMGS, pq.HELDOUT_IMGS = {}, {"gt_6": str(GALLERY / "gt_6.png")}
    gen = Generator.srresnet(4, pretrained_model_path=FLAGSHIP, device="cpu")
    got = pq.evaluate(gen, "srresnet", {})["srresnet"]["gt_6"]
    want = json.loads((ROOT / "results/quality_fastrecipe/RESULTS.json").read_text()
                      )["srresnet"]["gt_6"]
    for tag in ("model", "bicubic"):
        for k in ("psnr", "psnr_y"):
            assert abs(got[tag][k] - want[tag][k]) <= chip_smoke.RESCORE_PSNR_TOL, (tag, k)
        assert abs(got[tag]["ssim"] - want[tag]["ssim"]) <= chip_smoke.RESCORE_SSIM_TOL, tag
        assert abs(got[tag]["lp"] - want[tag]["lp"]) <= \
            chip_smoke.RESCORE_LP_REL_TOL * want[tag]["lp"], tag


def test_tiny_campaign_end_to_end(tmp_path):
    """``main --tiny`` with ``--crop 32`` on one training tile, a pixel
    stage and its GAN stage: finite numbers under the JAX script's keys,
    its file names, and a RESULTS.md equal to the JAX script's rendering of
    the same results."""
    crop = np.asarray(Image.open(GALLERY / "gt_6.png").convert("RGB"))[:96, :120]
    Image.fromarray(crop).save(tmp_path / "probe.png")
    pq = port_campaign()
    pq._parse_cli(["--crop", "32", "--out", str(tmp_path / "quality_tiny")])
    pq.DEVICE = "cpu"
    pq.TRAIN_IMGS = {"gt_16": str(GALLERY / "gt_16.png")}
    pq.EVAL_TRAIN_IMGS = dict(pq.TRAIN_IMGS)
    pq.HELDOUT_IMGS = {"probe": str(tmp_path / "probe.png")}
    results = pq.main(fast=True, tiny=True, pixel_archs=("srresnet",),
                      gan_pairs=(("srgan", "srresnet"), ("esrgan", "rrdb")))
    saved = json.loads((tmp_path / "quality_tiny/RESULTS.json").read_text())
    assert saved == results
    assert list(saved) == ["scale", "train_imgs", "heldout_imgs", "srresnet", "srgan"]
    for label in ("srresnet", "srgan"):
        assert list(saved[label]) == ["gt_16", "probe"]
        for name, row in saved[label].items():
            assert row["heldout"] is (name == "probe")
            for tag in ("model", "bicubic"):
                assert list(row[tag]) == ["psnr", "psnr_y", "ssim", "lp"]
                assert all(math.isfinite(v) for v in row[tag].values())
    models = sorted(p.name for p in (tmp_path / "quality_tiny/models").iterdir())
    assert models == ["gan_gen_srgan_x2_final.msgpack", "resnet_gen_srresnet_x2_best.msgpack"]
    assert (tmp_path / "quality_tiny/galleries/srgan/probe_half_0.png").is_file()
    md = (tmp_path / "quality_tiny/RESULTS.md").read_bytes()
    jq = jax_campaign()
    jq.OUT_DIR = str(tmp_path / "jax" / "quality_tiny")
    Path(jq.OUT_DIR).mkdir(parents=True)
    jq._write_markdown(saved)
    assert md == (Path(jq.OUT_DIR) / "RESULTS.md").read_bytes()
