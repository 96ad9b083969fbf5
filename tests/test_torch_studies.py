"""The port's two studies on the CPU against the JAX scripts they port,
loaded from their files: ``tools/ensemble_study.py`` (the x8 self-ensemble's
rows of each of the five committed models on a 64 px crop of a held-out
tile) and ``tools/ema_study.py`` (the per-epoch record of raw and EMA
held-out PSNR and its summary: both scripts' real GAN stage, from the same
generator file and the same critic weights, for a few float32 steps), then
each port's own run end to end."""

import functools
import importlib.util
import itertools
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import simplesr_tpu.train as jax_train
from simplesr_tpu.train.generator import Generator as JaxGenerator
from simplesr_tpu.train.serialization import save_model as jax_save_model
from simplesr_tpu_torch.tools import ema_study, ensemble_study
from simplesr_tpu_torch.train import Discriminator

ROOT = Path(__file__).resolve().parents[1]
GALLERY = ROOT / "data/corpus/gallery"
SRRESNET_X2 = ROOT / "results/quality_r2/models/resnet_gen_srresnet_x2_best.msgpack"
# the ensemble study's rows, unrounded, of the same bf16 model in both
# packages: bf16 convolutions sum in another order. srresnet_x2 measured on
# this crop 7e-4 dB of PSNR and PSNR-Y and 6e-5 of SSIM; the 128-filter
# SRResNets and the RRDBs (wider or deeper bf16 stacks) up to 0.0104 dB
# (rrdb_wide_x2's PSNR-Y) and 3.2e-4 (rrdb_x4's SSIM).
ENS_TOL = {"srresnet_x2": (0.01, 5e-4), "srresnet128_x2": (0.03, 1e-3),
           "rrdb_wide_x2": (0.03, 1e-3), "srresnet128_x4": (0.03, 1e-3),
           "rrdb_x4": (0.03, 1e-3)}
# the EMA record of a float32 model in both packages: float32 sums
EMA_PSNR_TOL = 1e-3
EMA_SSIM_TOL = 1e-5
_names = itertools.count()


def _load(path, prefix):
    spec = importlib.util.spec_from_file_location(f"{prefix}_{next(_names)}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    """A 64 px crop of the held-out tile gt_6."""
    path = tmp_path_factory.mktemp("probe") / "probe.png"
    Image.fromarray(np.asarray(Image.open(GALLERY / "gt_6.png").convert("RGB"))
                    [100:164, 150:214]).save(path)
    return path


@pytest.mark.parametrize("name", list(ensemble_study.MODELS))
def test_ensemble_rows_match_jax(name, probe, monkeypatch):
    path, scale = ensemble_study.MODELS[name]
    jes = _load(ROOT / "scripts/ensemble_study.py", "jax_ensemble_study")
    assert jes.MODELS[name] == (path, scale)
    jes.HELDOUT = [str(probe)]
    monkeypatch.setattr(ensemble_study, "HELDOUT", [str(probe)])
    (want,) = jes.eval_model(str(ROOT / path), scale)
    (got,) = ensemble_study.eval_model(ROOT / path, scale, device="cpu")
    psnr_tol, ssim_tol = ENS_TOL[name]
    assert list(got) == list(want) and got["probe"] == want["probe"] == "probe.png"
    for k in ("psnr_plain", "psnr_y_plain", "psnr_ens", "psnr_y_ens", "dpsnr"):
        assert abs(got[k] - want[k]) <= psnr_tol, (k, got, want)
    for k in ("ssim_plain", "ssim_ens"):
        assert abs(got[k] - want[k]) <= ssim_tol, (k, got, want)
    assert got["dpsnr"] > 0  # the ensemble gains on this crop in both


def test_rrdb_x4_file_predates_the_trunk_skip():
    """Why the study's rrdb_x4 (results/quality_r2_x4_deep) lands about 10
    dB below bicubic in both packages (its rows above agree with the JAX
    script's): the file was trained before the RRDB trunk gained its
    scaled inner skip, which both packages' RRDBNet now apply. Without that
    skip it serves at bicubic's level, as its RESULTS.json measured."""
    ref = _load(ROOT / "ensemble_reference.py", "ensemble_reference")
    rows = ref.pre_fix_trunk(ROOT / ensemble_study.MODELS["rrdb_x4"][0], crop=128)
    assert sorted(rows) == sorted(ref.HELDOUT)
    for tile, r in rows.items():
        assert r["today"] < r["bicubic"] - 5.0, (tile, r)
        assert r["pre_fix"] > r["bicubic"] - 1.0, (tile, r)


def test_ensemble_study_main_on_the_cpu(tmp_path, probe, monkeypatch, capsys):
    """The report as the JAX script lays it out, a missing model skipped by
    name, the cost timed with the host clock on the CPU (small here)."""
    monkeypatch.setattr(ensemble_study, "HELDOUT", [str(probe), str(tmp_path / "absent.png")])
    monkeypatch.setattr(ensemble_study, "MODELS", {
        "srresnet_x2": (str(SRRESNET_X2.relative_to(ROOT)), 2),
        "absent_x4": ("results/absent/models/none.msgpack", 4)})
    monkeypatch.setattr(ensemble_study, "measure_cost", functools.partial(
        ensemble_study.measure_cost, batch=1, lr_hw=16, runs=1))
    report = ensemble_study.main(["--out", str(tmp_path / "out"), "--device", "cpu"])
    saved = json.loads((tmp_path / "out/ENSEMBLE.json").read_text())
    assert saved == report and list(saved) == ["models", "cost"]
    assert list(saved["models"]) == ["srresnet_x2"] and len(saved["models"]["srresnet_x2"]) == 1
    cost = saved["cost"]
    assert cost["model"] == "srresnet_x2" and cost["timer"] == "host_clock"
    assert cost["cost_factor"] == pytest.approx(cost["ensemble_ms"] / cost["plain_ms"])
    assert cost["plain_mpix_s"] > 0 and cost["ensemble_mpix_s"] > 0
    out = capsys.readouterr().out
    assert "skip absent_x4" in out and "skip probe" in out


@pytest.fixture(scope="module")
def tiny_x2(tmp_path_factory):
    """A 2-block 16-filter float32 SRResNet x2 saved by the JAX package: the
    studies' pretrained generator."""
    gen = JaxGenerator.srresnet(upsample_factor=2, num_blocks=2, num_filters=16,
                                batch_norm=False, dtype=jnp.float32, input_dims=(16, 16))
    path = tmp_path_factory.mktemp("tiny") / "resnet_gen_srresnet_x2_best.msgpack"
    jax_save_model(gen.module_config(), gen.variables, str(path))
    return path


def test_ema_record_matches_jax(tmp_path, tiny_x2, probe, monkeypatch):
    """Both scripts' real GAN stage (SRModel with the EMA shadow, Adam,
    MSE and the adversarial term) from the same pretrained float32
    generator and the same critic weights (the JAX critic's initial
    variables carried into the port's), on the same 4 staged pairs, one
    batch an epoch, for 3 epochs: the per-epoch raw and EMA PSNR and SSIM
    within float32 sums, and the summary. The critic is the standard one
    at 8 filters in float32 with label smoothing off (its label noise
    comes from each package's own generator); the arguments the scripts
    pass are checked. A decay of 0.5 keeps the shadow far from both the
    raw weights and the pretrained ones, so that its update is tested."""
    rng = np.random.default_rng(0)
    lr = rng.uniform(0, 1, (4, 16, 16, 3)).astype(np.float32)
    hr = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    critics = {}
    jax_critic = jax_train.Discriminator

    class JaxCritic:
        @staticmethod
        def initialize_standard(**kw):
            critics["jax_args"] = kw
            critic = jax_critic.initialize_standard(
                num_filters=8, input_dims=kw["input_dims"], dtype=jnp.float32)
            critics["jax"] = jax.device_get(critic.variables)  # before a step donates them
            return critic

    class PortCritic:
        @staticmethod
        def initialize_standard(**kw):
            critics["port_args"] = kw
            critic = Discriminator.initialize_standard(
                num_filters=8, input_dims=kw["input_dims"], dtype="float32", device=kw["device"])
            critic.set_variables(critics["jax"])
            return critic

    jqc = _load(ROOT / "scripts/quality_campaign.py", "jax_quality_campaign")
    jqc.CROP, jqc.BATCH, jqc.HELDOUT_IMGS = 32, 4, {"probe": str(probe)}
    jqc.stage_dataset = lambda: ((jnp.asarray(lr), jnp.asarray(hr)), None)
    monkeypatch.setitem(sys.modules, "quality_campaign", jqc)
    monkeypatch.setattr(jax_train, "Discriminator", JaxCritic)
    jema = _load(ROOT / "scripts/ema_study.py", "jax_ema_study")
    jema.PRETRAINED = str(tiny_x2)
    args = ["--epochs", "3", "--decay", "0.5"]
    jema.main(args + ["--out", str(tmp_path / "jax")])
    want = json.loads((tmp_path / "jax/EMA.json").read_text())

    qc = ema_study.qc
    monkeypatch.setattr(qc, "CROP", 32)
    monkeypatch.setattr(qc, "BATCH", 4)
    monkeypatch.setattr(qc, "HELDOUT_IMGS", {"probe": str(probe)})
    monkeypatch.setattr(qc, "stage_dataset", lambda: (
        (torch.from_numpy(lr), torch.from_numpy(hr)), None))
    monkeypatch.setattr(ema_study, "Discriminator", PortCritic)
    monkeypatch.setattr(ema_study, "PRETRAINED", str(tiny_x2))
    got = ema_study.main(args + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    assert json.loads((tmp_path / "port/EMA.json").read_text()) == got

    study_args = {"label_smoothing": True, "smoothing_offset": 0.2, "input_dims": (32, 32)}
    assert critics["jax_args"] == study_args
    assert critics["port_args"] == {**study_args, "device": "cpu"}
    for key in ("decay", "epochs", "recipe"):
        assert got[key] == want[key]
    assert got["decay"] == 0.5 and [h["epoch"] for h in got["history"]] == [1, 2, 3]
    for g, w in zip(got["history"], want["history"]):
        for which in ("raw", "ema"):
            assert list(g[which]) == list(w[which]) == ["probe"]
            assert abs(g[which]["probe"]["psnr"] - w[which]["probe"]["psnr"]) <= EMA_PSNR_TOL
            assert abs(g[which]["probe"]["ssim"] - w[which]["probe"]["ssim"]) <= EMA_SSIM_TOL
    for k, v in got["summary"]["probe"].items():
        assert abs(v - want["summary"]["probe"][k]) <= EMA_PSNR_TOL, k
    # the steps move the weights, and the shadow lags them by many tolerances
    first, last = (h["raw"]["probe"]["psnr"] for h in (want["history"][0], want["history"][-1]))
    assert abs(last - first) > 20 * EMA_PSNR_TOL
    for h in want["history"]:
        assert abs(h["raw"]["probe"]["psnr"] - h["ema"]["probe"]["psnr"]) > 20 * EMA_PSNR_TOL


def test_ema_study_tiny_on_the_cpu(tmp_path, tiny_x2, probe, monkeypatch):
    """The real GAN stage for 2 epochs on one small tile with 32 px crops:
    finite scores, the EMA shadow behind the raw weights, EMA.json."""
    qc = ema_study.qc
    monkeypatch.setattr(qc, "CROP", 32)
    monkeypatch.setattr(qc, "TRAIN_IMGS", {"gt_16": str(GALLERY / "gt_16.png")})
    monkeypatch.setattr(qc, "HELDOUT_IMGS", {"probe": str(probe)})
    monkeypatch.setattr(ema_study, "PRETRAINED", str(tiny_x2))
    report = ema_study.main(["--epochs", "2", "--out", str(tmp_path), "--device", "cpu"])
    assert json.loads((tmp_path / "EMA.json").read_text()) == report
    assert len(report["history"]) == 2
    last = report["history"][-1]
    assert all(np.isfinite([last[w]["probe"]["psnr"], last[w]["probe"]["ssim"]]).all()
               for w in ("raw", "ema"))
    assert last["raw"]["probe"]["psnr"] != last["ema"]["probe"]["psnr"]
    assert set(report["summary"]["probe"]) == {"raw_mean", "raw_std", "ema_mean", "ema_std",
                                               "final_raw", "final_ema"}
