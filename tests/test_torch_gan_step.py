"""The port's SRModel in GAN mode against simplesr_tpu's, from the same
initial weights (the JAX generator's through a model file, the JAX
critic's variables carried over) on the same seeded batches: SRGAN
(SRResNet, MSE + adversarial, the standard critic) and ESRGAN (RRDB,
L1 + relativistic adversarial + pre-activation VGG54, the relativistic
critic), 3 SGD steps and a validation step each, float32, label smoothing
off. Checked: the generator's and the critic's parameters, the critic's
running statistics, every batch metric, the validation metrics."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplesr_tpu import losses as jax_losses
from simplesr_tpu.models.vgg import init_vgg_params as jax_init_vgg
from simplesr_tpu.train import Generator as JaxGenerator
from simplesr_tpu.train import SRModel as JaxSRModel
from simplesr_tpu.train.discriminator import Discriminator as JaxDiscriminator
from simplesr_tpu.train.serialization import save_model as jax_save_model
from simplesr_tpu_torch import losses
from simplesr_tpu_torch.train import Discriminator, Generator, SRModel

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


def _losses(kind, lib, vgg_params):
    if kind == "srgan":
        return [lib.MeanSquaredError(), lib.AdversarialLoss(weighted=True, loss_weight=1e-3)]
    return [lib.MeanAbsoluteError(weighted=True, loss_weight=1e-2),
            lib.RaAdversarialLoss(weighted=True, loss_weight=5e-3),
            lib.VGGLoss("block5_conv4", after_activation=False, vgg_params=vgg_params)]


def _gan_pair(tmp_path, kind):
    arch = "srresnet" if kind == "srgan" else "rrdb"
    vgg = jax.device_get(jax_init_vgg("vgg19")) if kind == "esrgan" else None
    arch_kw = dict(num_blocks=2, num_filters=16 if kind == "srgan" else 8, batch_norm=False)
    jgen = JaxGenerator(4, arch, _losses(kind, jax_losses, vgg), dtype=jnp.float32,
                        input_dims=(8, 8), **arch_kw)
    init = str(tmp_path / "init.msgpack")
    jax_save_model(jgen.module_config(), jgen.variables, init)
    gen = Generator(4, arch, _losses(kind, losses, vgg), dtype="float32",
                    pretrained_model_path=init, device="cpu", **arch_kw)
    factory = "initialize_standard" if kind == "srgan" else "initialize_relativistic"
    jdisc = getattr(JaxDiscriminator, factory)(num_filters=8, input_dims=(32, 32),
                                               dtype=jnp.float32)
    disc = getattr(Discriminator, factory)(num_filters=8, input_dims=(32, 32), dtype="float32",
                                           device="cpu")
    disc.set_variables(jax.device_get(jdisc.variables))
    opt = ("SGD", {"learning_rate": 0.05})
    jax_model = JaxSRModel("gan", jgen, *opt, jdisc, *opt, config=_cfg(tmp_path / "jax"),
                           async_checkpointing=False)
    model = SRModel("gan", gen, *opt, disc, *opt, config=_cfg(tmp_path / "port"), device="cpu")
    return jax_model, model


def _batches(count, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32),
             rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)) for _ in range(count)]


def _flat(variables):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(variables)}


def _floats(history):
    return {k: [float(v) for v in vs] for k, vs in history.items()}


@pytest.mark.parametrize("kind", ["srgan", "esrgan"])
def test_gan_trajectory_matches_jax(tmp_path, kind):
    """3 SGD steps and a validation step. Generator and critic parameters
    and the critic's running statistics to 1e-5 (float32 convolutions and
    the VGG's, summed in another order, through three updates); every batch
    and validation metric to rel 1e-4."""
    jax_model, model = _gan_pair(tmp_path, kind)
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
    ref = _flat({"params": jax_model.state.d_params, "batch_stats": jax_model.state.d_batch_stats})
    got = _flat(model.discriminator_wrapper().variables)
    assert ref.keys() == got.keys()
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5, err_msg=k)

    ref_h, got_h = jax_model.histories(), model.histories()
    for part in ("train_batch", "valid_batch"):
        assert ref_h[part].keys() == got_h[part].keys(), part
        for k, v in _floats(ref_h[part]).items():
            np.testing.assert_allclose(_floats(got_h[part])[k], v, rtol=1e-4, atol=1e-7,
                                       err_msg=(part, k))
    keys = set(got_h["train_batch"])
    assert {"discriminator_accuracy", "SR_accuracy", "HR_accuracy", "generator_loss"} <= keys
    assert ("discriminator_loss" if kind == "srgan" else "ra_discriminator_loss") in keys
    assert model.step == STEPS and model.optimizer.count == STEPS
    assert model.discriminator_optimizer.count == STEPS
    text = model.formatted_epoch_metrics()
    assert "Discriminator" in text and text.count("discriminator_accuracy") == 2


def test_discriminator_statistics_move_in_the_discriminator_branch_only(tmp_path):
    """One step moves the critic's running statistics exactly twice (SR,
    then HR, as the JAX package's discriminator branch); the generator
    branch, which shares those forwards, adds no third and fourth move.
    A stand-alone critic given the same two batches in training mode ends
    with the same statistics."""
    _, model = _gan_pair(tmp_path, "srgan")
    lr, hr = _batches(1)[0]
    disc = model.discriminator_wrapper().model()
    twin = copy.deepcopy(disc).train()
    with torch.no_grad():
        sr = model.generator()(torch.from_numpy(lr)).float()
        twin(sr)
        twin(torch.from_numpy(hr))
    model.train_step(lr, hr)
    for (name, a), b in zip(disc.named_buffers(), twin.buffers()):
        if name.endswith("running_mean") or name.endswith("running_var"):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7, msg=name)
