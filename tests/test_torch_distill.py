"""The port's distillation (simplesr_tpu_torch/train/distill.py) and
SRModel's distill mode against simplesr_tpu's: spec validation error for
error, the loss terms on the same outputs, and SGD trajectories of a
distilled student in ResNet and in GAN mode from the same weights (the
teacher's flax variables carried over by train/convert.py). Float32; the
trajectories and metrics at the trainer tests' bounds (parameters atol 1e-5,
metrics rel 1e-4)."""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplesr_tpu import losses as jax_losses
from simplesr_tpu.train import Generator as JaxGenerator
from simplesr_tpu.train import SRModel as JaxSRModel
from simplesr_tpu.train import build_distiller as jax_build_distiller
from simplesr_tpu.train.discriminator import Discriminator as JaxDiscriminator
from simplesr_tpu.train.serialization import save_model as jax_save_model
from simplesr_tpu_torch import losses
from simplesr_tpu_torch.config import ConfigUtil, _yaml
from simplesr_tpu_torch.models import build_generator_model
from simplesr_tpu_torch.train import (Discriminator, Generator, SRModel, build_distiller,
                                      from_flax_variables)
from simplesr_tpu_torch.train.serialization import save_model

ROOT = Path(__file__).resolve().parents[1]
GALLERY = str(ROOT / "data/corpus/gallery")
DISTILL_RECIPE = ROOT / "examples/training/srresnet_distill_x4.yaml"
STEPS = 3


def _cfg(root):
    class Cfg:
        model_dir = str(root / "models")
        checkpoint_dir = str(root / "checkpoints")
        early_stop_metric = "psnr"
        early_stop_patience = 100
        epoch_train_summary_writer = None
        batch_train_summary_writer = None
        epoch_validation_summary_writer = None
        batch_validation_summary_writer = None
    return Cfg


def _teacher(scale=2, seed=7):
    """A 12-wide float32 JAX SRResNet teacher, (flax module, variables), and
    the port's module for the same weights."""
    g = JaxGenerator.srresnet(upsample_factor=scale, num_blocks=1, num_filters=12,
                              batch_norm=False, dtype=jnp.float32, input_dims=(8, 8), seed=seed)
    variables = jax.device_get(g.variables)
    port = build_generator_model(scale, num_blocks=1, num_filters=12, batch_norm=False,
                                 dtype="float32", device="cpu")
    return (g.model(), variables), port, variables


def _batches(count, seed=0, scale=2):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32),
             rng.uniform(-1, 1, (2, 8 * scale, 8 * scale, 3)).astype(np.float32))
            for _ in range(count)]


def _flat(variables):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(variables)}


def _floats(history):
    return {k: [float(v) for v in vs] for k, vs in history.items()}


@pytest.mark.parametrize("spec", [
    "unknown", "no_model", "bad_loss", "zero_weight", "negative_weight", "not_a_spec",
    "list"])
def test_spec_validation_matches_jax(spec):
    jax_pair, port, variables = _teacher()
    specs = {"unknown": lambda pair: {"model": pair, "wieght": 2.0},
             "no_model": lambda pair: {"weight": 1.0},
             "bad_loss": lambda pair: {"model": pair, "loss": "huber"},
             "zero_weight": lambda pair: {"model": pair, "weight": 0.0},
             "negative_weight": lambda pair: {"model": pair, "weight": -1.0},
             "not_a_spec": lambda pair: 42,
             "list": lambda pair: [pair]}
    with pytest.raises(ValueError) as want:
        jax_build_distiller(specs[spec](jax_pair))
    with pytest.raises(ValueError) as got:
        build_distiller(specs[spec]((port, variables)), device="cpu")
    if spec in ("not_a_spec", "list"):  # the message holds the spec's repr
        assert str(got.value).split(":")[0] == str(want.value).split(":")[0]
    else:
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("loss", ["mae", "mse"])
@pytest.mark.parametrize("weight", [1.0, 0.5])
def test_loss_terms_match_jax(loss, weight):
    jax_pair, port, variables = _teacher()
    want_d = jax_build_distiller({"model": jax_pair, "loss": loss, "weight": weight})
    got_d = build_distiller({"model": (port, variables), "loss": loss, "weight": weight},
                            device="cpu")
    assert (got_d.weight, got_d.loss) == (want_d.weight, want_d.loss)
    lr, _ = _batches(1)[0]
    sr = np.random.default_rng(5).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    want_term, want_m = want_d.loss_terms(jnp.asarray(sr), jnp.asarray(lr))
    got_term, got_m = got_d.loss_terms(torch.from_numpy(sr), torch.from_numpy(lr))
    assert got_m.keys() == want_m.keys()
    assert ("weighted_distillation_loss" in got_m) == (weight != 1.0)
    np.testing.assert_allclose(float(got_term), float(want_term), rtol=1e-6)
    for k in want_m:
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]), rtol=1e-6, err_msg=k)


def test_teacher_is_frozen_and_the_callers_module_untouched(tmp_path):
    _, port, variables = _teacher()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    gen = Generator.srresnet(2, num_blocks=1, num_filters=8, batch_norm=False,
                             dtype="float32", device="cpu")
    model = SRModel("resnet", gen, "SGD", {"learning_rate": 0.05}, config=_cfg(tmp_path),
                    device="cpu", distill=(port, variables))
    teacher = model._distill.teacher
    assert teacher is not port and not teacher.training
    model.before_epoch()
    for lr, hr in _batches(2):
        model.train_step(lr, hr)
        model.after_train_batch()
    assert all(p.grad is None and not p.requires_grad for p in teacher.parameters())
    assert all(torch.equal(before[k], v) for k, v in port.state_dict().items())


def _resnet_pair(tmp_path, distill_weight):
    jax_pair, port, variables = _teacher()
    jgen = JaxGenerator.srresnet(upsample_factor=2, num_blocks=1, num_filters=8,
                                 batch_norm=False, dtype=jnp.float32, input_dims=(8, 8))
    init = str(tmp_path / "init.msgpack")
    jax_save_model(jgen.module_config(), jgen.variables, init)
    gen = Generator.srresnet(2, num_blocks=1, num_filters=8, batch_norm=False,
                             dtype="float32", pretrained_model_path=init, device="cpu")
    opt = ("SGD", {"learning_rate": 0.05})
    jax_model = JaxSRModel("resnet", jgen, *opt, config=_cfg(tmp_path / "jax"),
                           async_checkpointing=False,
                           distill={"model": jax_pair, "weight": distill_weight})
    model = SRModel("resnet", gen, *opt, config=_cfg(tmp_path / "port"), device="cpu",
                    distill={"model": (port, variables), "weight": distill_weight})
    return jax_model, model


def _gan_pair(tmp_path):
    """SRGAN (MSE + adversarial 1e-3, the standard critic) x2 with a distill
    weight of 0.5."""
    jax_pair, port, variables = _teacher()

    def gen_losses(lib):
        return [lib.MeanSquaredError(), lib.AdversarialLoss(weighted=True, loss_weight=1e-3)]

    arch = dict(num_blocks=1, num_filters=8, batch_norm=False)
    jgen = JaxGenerator(2, "srresnet", gen_losses(jax_losses), dtype=jnp.float32,
                        input_dims=(8, 8), **arch)
    init = str(tmp_path / "init.msgpack")
    jax_save_model(jgen.module_config(), jgen.variables, init)
    gen = Generator(2, "srresnet", gen_losses(losses), dtype="float32",
                    pretrained_model_path=init, device="cpu", **arch)
    jdisc = JaxDiscriminator.initialize_standard(num_filters=8, input_dims=(16, 16),
                                                 dtype=jnp.float32)
    disc = Discriminator.initialize_standard(num_filters=8, input_dims=(16, 16),
                                             dtype="float32", device="cpu")
    disc.set_variables(jax.device_get(jdisc.variables))
    opt = ("SGD", {"learning_rate": 0.05})
    jax_model = JaxSRModel("gan", jgen, *opt, jdisc, *opt, config=_cfg(tmp_path / "jax"),
                           async_checkpointing=False, distill={"model": jax_pair, "weight": 0.5})
    model = SRModel("gan", gen, *opt, disc, *opt, config=_cfg(tmp_path / "port"), device="cpu",
                    distill={"model": (port, variables), "weight": 0.5})
    return jax_model, model


@pytest.mark.parametrize("mode", ["resnet_weight_1", "resnet_weight_0.5", "gan"])
def test_distilled_trajectory_matches_jax(tmp_path, mode):
    """3 SGD steps and a validation step: the student's parameters to atol
    1e-5, every train and validation batch metric (the distillation terms
    and the overwritten generator_loss among them) to rel 1e-4."""
    if mode == "gan":
        jax_model, model = _gan_pair(tmp_path)
    else:
        jax_model, model = _resnet_pair(tmp_path, float(mode.rsplit("_", 1)[1]))
    batches = _batches(STEPS + 1)
    for m in (jax_model, model):
        m.before_epoch()
        for lr, hr in batches[:STEPS]:
            m.train_step(lr, hr)
            m.after_train_batch()
        m.validation_step(*batches[-1])
        m.after_validation_batch()
    ref = _flat({"params": jax_model.state.g_params})
    got = _flat(model.generator_wrapper().variables)
    assert ref.keys() == got.keys()
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5, err_msg=k)
    ref_h, got_h = jax_model.histories(), model.histories()
    assert "distillation_loss" in got_h["train_batch"]
    for part in ("train_batch", "valid_batch"):
        assert ref_h[part].keys() == got_h[part].keys(), part
        for k, v in _floats(ref_h[part]).items():
            np.testing.assert_allclose(_floats(got_h[part])[k], v, rtol=1e-4, atol=1e-7,
                                       err_msg=(part, k))


def test_teacher_file_scale_mismatch_raises(tmp_path):
    teacher = build_generator_model(4, num_blocks=1, num_filters=8, batch_norm=False,
                                    dtype="float32", device="cpu")
    path = str(tmp_path / "teacher_x4.msgpack")
    from simplesr_tpu_torch.train import to_flax_variables
    config = dict(upsample_factor=4, architecture="srresnet", num_blocks=1, num_filters=8,
                  batch_norm=False, dtype="float32")
    save_model(config, to_flax_variables(teacher.state_dict()), path)
    with pytest.raises(ValueError, match="x4 .*x2"):
        build_distiller(path, student_upsample_factor=2, device="cpu")
    d = build_distiller(path, student_upsample_factor=4, device="cpu")
    assert d.weight == 1.0 and d.loss == "mae"
    gen = Generator.srresnet(2, num_blocks=1, num_filters=8, batch_norm=False,
                             dtype="float32", device="cpu")
    with pytest.raises(ValueError, match="x4 .*x2"):
        SRModel("resnet", gen, "SGD", {"learning_rate": 0.1}, config=_cfg(tmp_path),
                device="cpu", distill=path)


def test_distill_recipe_from_yaml_distills(tmp_path, monkeypatch):
    """examples/training/srresnet_distill_x4.yaml as written (its RRDB
    teacher file, its weight and loss), with its data, results and student
    width cut for the CPU: SRModel.init distills, in training and in
    validation."""
    monkeypatch.chdir(ROOT)  # the recipe names its teacher relative to the repo
    spec = _yaml.load(DISTILL_RECIPE)
    assert spec["general"]["distill"]["weight"] == 0.5
    spec["general"].update(train_data_paths=GALLERY, results_save_path=str(tmp_path),
                           crop_size=(16, 16, 3), num_crops=1, batch_size=2, random_seed=0)
    spec["model"]["generator"].update(num_blocks=1, num_filters=8, dtype="float32")
    conf, pipeline, model = ConfigUtil.from_yaml(spec, device="cpu")
    assert conf.distill == spec["general"]["distill"]
    teacher = model._distill.teacher
    assert type(teacher).__name__ == "RRDBNet" and model._distill.loss == "mae"
    lr, hr = next(iter(pipeline.train_batch_generator()))
    model.before_epoch()
    model.train_step(lr, hr)
    model.validation_step(lr, hr)
    train = model.generator_wrapper().epoch_metrics(train=True).results()
    valid = model.generator_wrapper().epoch_metrics(train=False).results()
    for metrics in (train, valid):
        assert np.isfinite(metrics["distillation_loss"])
        assert metrics["weighted_distillation_loss"] == pytest.approx(
            0.5 * metrics["distillation_loss"], rel=1e-6)
    assert all(p.grad is None for p in teacher.parameters())
    assert os.path.isdir(conf.save_path)
