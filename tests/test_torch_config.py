"""The port's ConfigUtil against simplesr_tpu's: every training example
(paths pointed at the gallery) gives the same attributes, except the
timestamped run name and the TensorBoard writers, and the same save-dir
tree; resume directories resolve alike; ``from_yaml`` builds the run on the
CPU where the port can train the example (the GAN ones in GAN mode) and
raises NotImplementedError, naming its ROADMAP.md item, where it cannot
(the paired production and distillation examples build since the training
surface was ported)."""

import os
from pathlib import Path

import pytest

from simplesr_tpu.config import ConfigUtil as JaxConfigUtil
from simplesr_tpu.config.yaml_helper import load_yaml as jax_load_yaml
from simplesr_tpu_torch.config import ConfigUtil
from simplesr_tpu_torch.config.yaml_helper import load_yaml
from simplesr_tpu_torch.data import DataPipeline
from simplesr_tpu_torch.train import SRModel

ROOT = Path(__file__).resolve().parents[1]
GALLERY = str(ROOT / "data/corpus/gallery")
TRAINING = sorted((ROOT / "examples/training").glob("*.yaml"))
# examples whose run the port builds: every one since the parallel layer
PORTED = {"minimal_example.yaml", "srresnet128_x4.yaml", "srresnet_denoise_x2.yaml",
          "srresnet_x4.yaml", "esrgan_x4.yaml", "srgan_x4.yaml", "srresnet_distill_x4.yaml",
          "srresnet_x4_paired_production.yaml", "rrdb_deep_scaled_x4.yaml"}


def _general(path, results):
    spec = load_yaml(str(path))
    assert spec == jax_load_yaml(str(path))
    general = dict(spec["general"])
    general.pop("operation")
    general.update(train_data_paths=GALLERY, results_save_path=str(results))
    if "validation_data_path" in general:
        general["validation_data_path"] = GALLERY
    return spec, general


def _relative(conf):
    """The config's attributes with its save path factored out."""
    out = {}
    for k, v in vars(conf).items():
        if "summary_writer" in k or k == "save_dir_name":
            continue
        if isinstance(v, str) and v.startswith(conf.save_path):
            v = "<save>" + v[len(conf.save_path):]
        out[k] = v
    return out


def _tree(root):
    """The save dir's paths; a TensorBoard event file counts under its name
    without the time and host."""
    return sorted(os.path.relpath(os.path.join(d, "events.out.tfevents" if "tfevents" in x
                                               else x), root)
                  for d, dirs, files in os.walk(root) for x in dirs + files)


@pytest.mark.parametrize("path", TRAINING, ids=lambda p: p.name)
def test_training_config_matches_jax(path, tmp_path):
    _, general = _general(path, tmp_path / "r")
    ref = JaxConfigUtil.training_config(**dict(general, results_save_path=str(tmp_path / "j")))
    got = ConfigUtil.training_config(**general)
    assert _relative(got) == _relative(ref)
    assert _tree(got.save_path) == _tree(ref.save_path)
    assert os.readlink(Path(got.save_path).parent / "latest") == got.save_dir_name


@pytest.mark.parametrize("path", TRAINING, ids=lambda p: p.name)
def test_from_yaml_builds_or_names_the_item(path, tmp_path, monkeypatch, caplog):
    """Every example builds on the CPU. One process is one device: with
    ``fsdp`` it warns and trains replicated, as the JAX package does with one
    device visible."""
    monkeypatch.chdir(ROOT)  # the distillation example names its teacher relative to the repo
    spec, general = _general(path, tmp_path)
    spec["general"] = dict(general, operation="training")
    assert path.name in PORTED
    if path.name in PORTED:
        conf, pipeline, model = ConfigUtil.from_yaml(spec, device="cpu")
        assert isinstance(pipeline, DataPipeline) and isinstance(model, SRModel)
        assert pipeline.device.type == model.device.type == "cpu"
        gan = "discriminator" in spec["model"]
        assert model.model_type == ("gan" if gan else "resnet") and conf.operation == "training"
        assert (model.discriminator_wrapper() is not None) == gan
        assert (model.ema_parameters is not None) == bool(general.get("ema_decay"))
        assert pipeline.train_imgs and pipeline.crop_size == tuple(general["crop_size"])
        assert model._paired_ways == (general.get("paired_train") or 1)
        assert (model._distill is not None) == ("distill" in general)
        assert model._mesh is None and model._zero is None
        warned = "fsdp: true requested but only one device is visible" in caplog.text
        assert warned == bool(general.get("fsdp"))


def test_paired_train_raises_naming_its_item(tmp_path):
    """Ported since: ``paired_train: 2`` builds the paired mode (no longer
    raising), which trains the trunk kernel's forward as the same recipe
    without the key does."""
    spec, general = _general(ROOT / "examples/training/srresnet_x4_paired_production.yaml",
                             tmp_path)
    spec["general"] = dict(general, operation="training")
    _, _, model = ConfigUtil.from_yaml(spec, device="cpu")
    assert model._paired_ways == 2 and model.generator().uses_trunk_kernel
    del spec["general"]["paired_train"]
    _, _, model = ConfigUtil.from_yaml(spec, device="cpu")
    assert model._paired_ways == 1 and model.generator().uses_trunk_kernel


def test_resume_dir_resolution_matches_jax(tmp_path):
    runs = tmp_path / "training"
    for name in ("20260101-000000", "20260102-000000"):
        (runs / name / "checkpoints").mkdir(parents=True)
    (runs / "no_ckpt").mkdir()
    os.symlink("20260102-000000", runs / "latest")
    cases = [True, "latest", "LATEST", "20260101-000000", str(runs / "20260101-000000"),
             "no_ckpt", "missing", str(tmp_path / "elsewhere" / "x"), 3]
    for resume in cases:
        outcomes = []
        for cls in (ConfigUtil, JaxConfigUtil):
            try:
                outcomes.append(cls._resolve_resume_dir(str(tmp_path), resume))
            except ValueError as e:
                outcomes.append(type(e))
        assert outcomes[0] == outcomes[1], resume
    assert ConfigUtil._resolve_resume_dir(str(tmp_path), True) == "20260102-000000"


def test_evaluation_config_and_deepcopy_match_jax(tmp_path):
    import copy

    kw = dict(data_paths=GALLERY, test_originals_path=None, model_paths=["m.msgpack"],
              scale=2, batch_size=1)
    got = ConfigUtil.evaluation_config(results_save_path=str(tmp_path / "t"), **kw)
    ref = JaxConfigUtil.evaluation_config(results_save_path=str(tmp_path / "j"), **kw)
    assert _relative(got) == _relative(ref)
    train = ConfigUtil.training_config(GALLERY, 1, 2, 4, results_save_path=str(tmp_path))
    clone = copy.deepcopy(train)
    assert clone.epoch_train_summary_writer is None
    assert clone.save_path == train.save_path and clone.crop_size == train.crop_size
