"""The port's SRModel state against simplesr_tpu's: the EMA shadow and
``generate(ema=True)``, gradient accumulation with a non-finite micro-batch,
the warm start from a ResNet run's checkpoint with a matching and a
mismatched optimizer, checkpoints and resume with the critic's state, and
the GAN model files' names and bytes. Float32 SRGAN (SRResNet, MSE +
adversarial, the standard critic) at 2 blocks x 16 filters, 32 x 32 HR."""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplesr_tpu import losses as jax_losses
from simplesr_tpu.train import Generator as JaxGenerator
from simplesr_tpu.train import SRModel as JaxSRModel
from simplesr_tpu.train.discriminator import Discriminator as JaxDiscriminator
from simplesr_tpu.train.optimizers import piecewise_constant_decay as jax_piecewise
from simplesr_tpu.train.serialization import save_model as jax_save_model
from simplesr_tpu_torch import losses
from simplesr_tpu_torch.train import Discriminator, Generator, SRModel
from simplesr_tpu_torch.train.optimizers import piecewise_constant_decay

SGD = {"learning_rate": 0.05, "momentum": 0.9}


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


def _generators(tmp_path, arch="srresnet", gan=True):
    """A JAX generator and the port's from its model file; MSE, and the
    adversarial loss when ``gan``."""
    arch_kw = dict(num_blocks=2, num_filters=16 if arch == "srresnet" else 8, batch_norm=False)

    def stack(lib):
        extra = [lib.AdversarialLoss(weighted=True, loss_weight=1e-3)] if gan else []
        return [lib.MeanSquaredError()] + extra

    jgen = JaxGenerator(4, arch, stack(jax_losses), dtype=jnp.float32, input_dims=(8, 8),
                        **arch_kw)
    init = str(tmp_path / f"init_{arch}.msgpack")
    os.makedirs(tmp_path, exist_ok=True)
    jax_save_model(jgen.module_config(), jgen.variables, init)
    gen = Generator(4, arch, stack(losses), dtype="float32", pretrained_model_path=init,
                    device="cpu", **arch_kw)
    return jgen, gen


def _critics():
    jdisc = JaxDiscriminator.initialize_standard(num_filters=8, input_dims=(32, 32),
                                                 dtype=jnp.float32)
    disc = Discriminator.initialize_standard(num_filters=8, input_dims=(32, 32),
                                             dtype="float32", device="cpu")
    disc.set_variables(jax.device_get(jdisc.variables))
    return jdisc, disc


def _gan_pair(tmp_path, arch="srresnet", opt=None, jax_opt=None, **model_kw):
    jgen, gen = _generators(tmp_path, arch)
    jdisc, disc = _critics()
    opt = opt or ("SGD", dict(SGD))
    jax_opt = jax_opt or ("SGD", dict(SGD))
    jax_model = JaxSRModel("gan", jgen, *jax_opt, jdisc, "SGD", dict(SGD),
                           config=_cfg(tmp_path / "jax"), async_checkpointing=False,
                           **model_kw.pop("jax_kw", model_kw))
    model = SRModel("gan", gen, *opt, disc, "SGD", dict(SGD), config=_cfg(tmp_path / "port"),
                    device="cpu", **model_kw)
    return jax_model, model


def _batches(count, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32),
             rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)) for _ in range(count)]


def _flat(variables):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(variables)}


def _close(got, ref, atol=1e-5, nan=False):
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=atol, err_msg=k, equal_nan=nan)


def _ema_variables(model):
    module = model.generator()
    state = module.state_dict()
    state.update(dict(zip([n for n, _ in module.named_parameters()], model.ema_parameters)))
    from simplesr_tpu_torch.train.convert import to_flax_variables

    return to_flax_variables(state)


def test_ema_matches_jax(tmp_path):
    """ema_decay 0.9 over 3 steps (momentum SGD): the shadow to 1e-5 of
    JAX's, generate(ema=True) to 1e-5, validation on the shadow with
    ema_eval, and after_training's ``_best`` and ``_best_ema`` files, the
    EMA one differing from the raw one."""
    jax_model, model = _gan_pair(tmp_path, ema_decay=0.9, ema_eval=True)
    batches = _batches(4)
    for m in (jax_model, model):
        m.before_epoch()
        for lr, hr in batches[:3]:
            m.train_step(lr, hr)
            m.after_train_batch()
        m.validation_step(*batches[3])
        m.after_validation_batch()
    _close(_flat(_ema_variables(model)), _flat({"params": jax_model.state.g_ema_params}))
    x = batches[3][0]
    np.testing.assert_allclose(model.generate(x, ema=True).numpy(),
                               np.asarray(jax_model.generate(x, ema=True)), rtol=0, atol=1e-5)
    assert not torch.equal(model.generate(x, ema=True), model.generate(x))
    for k, v in jax_model.histories()["valid_batch"].items():
        assert float(model.histories()["valid_batch"][k][0]) == pytest.approx(float(v[0]),
                                                                               rel=1e-4), k
    for m in (jax_model, model):
        m.after_epoch()
        m.after_training()
    names = sorted(os.listdir(tmp_path / "port" / "models"))
    assert names == sorted(os.listdir(tmp_path / "jax" / "models")) == \
        ["gan_gen_1.msgpack", "gan_gen_best.msgpack", "gan_gen_best_ema.msgpack"]
    raw, ema = ((tmp_path / "port" / "models" / f"gan_gen_best{p}.msgpack").read_bytes()
                for p in ("", "_ema"))
    assert raw != ema
    with pytest.raises(ValueError):
        SRModel("gan", model.generator_wrapper(), "SGD", dict(SGD), model.discriminator_wrapper(),
                "SGD", device="cpu").generate(x, ema=True)


def test_grad_accum_matches_jax(tmp_path):
    """grad_accum_steps=2 with EMA 0.5 over 5 micro-batches, the third one
    (right after the first update) non-finite: it is dropped before the
    accumulator and counts no micro-step, so updates land after micro-batches
    2 and 5. Parameters, shadow and critic to 1e-5 of JAX's (the critic's
    running statistics are NaN in both after the NaN batch), the optimizers'
    counts equal to the updates applied."""
    jax_model, model = _gan_pair(tmp_path, grad_accum_steps=2, ema_decay=0.5)
    batches = _batches(5, seed=1)
    lr, hr = batches[2]
    hr = hr.copy()
    hr[0, 0, 0, 0] = np.nan
    batches[2] = (lr, hr)
    counts = []
    for i, (lr, hr) in enumerate(batches):
        for m in (jax_model, model):
            m.train_step(lr, hr)
        counts.append(model.optimizer.count)
        _close(_flat(_ema_variables(model)), _flat({"params": jax_model.state.g_ema_params}))
    assert counts == [0, 1, 1, 1, 2]
    assert model.discriminator_optimizer.count == 2 and model.step == 5
    assert model.optimizer.total_notfinite == 1
    _close(_flat(model.generator_wrapper().variables), _flat({"params": jax_model.state.g_params}))
    _close(_flat(model.discriminator_wrapper().variables),
           _flat({"params": jax_model.state.d_params,
                  "batch_stats": jax_model.state.d_batch_stats}), nan=True)


def _pretrain(tmp_path, jax_lr, lr):
    """A ResNet-mode run of the GAN's generator in both packages, momentum
    SGD for 2 steps, then after_epoch: a checkpoint at step 2, psnr 20."""
    jgen, gen = _generators(tmp_path / "pre", gan=False)
    jax_model = JaxSRModel("resnet", jgen, "SGD", dict(SGD, learning_rate=jax_lr),
                           config=_cfg(tmp_path / "pre" / "jax"), async_checkpointing=False)
    model = SRModel("resnet", gen, "SGD", dict(SGD, learning_rate=lr),
                    config=_cfg(tmp_path / "pre" / "port"), device="cpu")
    for m in (jax_model, model):
        m.before_epoch()
        for lr_b, hr_b in _batches(2, seed=2):
            m.train_step(lr_b, hr_b)
            m.after_train_batch()
        m._valid_epoch_metrics.ensure("psnr")(torch.tensor(20.0))
    jax_model._valid_epoch_metrics.ensure("psnr")(jnp.asarray(20.0))
    jax_model.after_epoch()
    model.after_epoch()
    return jax_model, model


@pytest.mark.parametrize("matching,ema", [(True, None), (False, None), (True, 0.5)],
                         ids=["matching", "schedule_vs_constant", "ema_in_one_run"])
def test_resnet_checkpoint_warm_start_matches_jax(tmp_path, matching, ema, caplog):
    """The GAN generator warm-starts from the ResNet run's checkpoint
    directory: parameters bit-equal to the ResNet run's, its step and best
    metric, the EMA shadow at the restored parameters. The momentum trace
    comes along only when the optimizers have one structure (a constant
    rate on both sides) and EMA is on in both runs or in neither, as the
    JAX package's one-template restore behaves; otherwise the port warns and
    starts fresh. One GAN step after the warm start agrees with JAX's to
    1e-5 in every case, so the trace was kept or dropped as there."""
    const, sched = 0.05, ([100], [0.05, 0.01])
    jax_pre, pre = _pretrain(tmp_path, const if matching else jax_piecewise(*sched),
                             const if matching else piecewise_constant_decay(*sched))
    ckpt, jax_ckpt = (os.path.join(m._checkpoint_dir, "resnet") for m in (pre, jax_pre))
    with caplog.at_level(logging.WARNING, logger="simple_sr"):
        jax_model, model = _gan_pair(tmp_path, ema_decay=ema, resnet_checkpoint=ckpt,
                                     jax_kw=dict(ema_decay=ema, resnet_checkpoint=jax_ckpt))
    carried = matching and ema is None
    port_warnings = [r for r in caplog.records if "simplesr_tpu_torch" in r.pathname]
    assert bool(port_warnings) == (not carried)
    for k, v in _flat(pre.generator_wrapper().variables).items():
        np.testing.assert_array_equal(_flat(model.generator_wrapper().variables)[k], v)
    _close(_flat(model.generator_wrapper().variables), _flat({"params": jax_model.state.g_params}))
    assert model.step == 2 == int(jax_model.state.step)
    assert model.best_metric == 20.0 == float(jax_model.state.best_metric)
    if ema is not None:
        assert all(torch.equal(a, b) for a, b in zip(model.ema_parameters,
                                                     model.generator().parameters()))
    assert model.optimizer.count == (2 if carried else 0)
    lr, hr = _batches(1, seed=3)[0]
    for m in (jax_model, model):
        m.train_step(lr, hr)
    _close(_flat(model.generator_wrapper().variables), _flat({"params": jax_model.state.g_params}))


def test_warm_start_refuses_orbax_and_empty_directories(tmp_path):
    _, gen = _generators(tmp_path)
    _, disc = _critics()
    orbax = tmp_path / "orbax" / "resnet"
    (orbax / "2").mkdir(parents=True)
    empty = tmp_path / "empty"
    empty.mkdir()
    for directory, match in ((orbax, "orbax"), (empty, "no checkpoint")):
        with pytest.raises(ValueError, match=match):
            SRModel("gan", gen, "SGD", dict(SGD), disc, "SGD", dict(SGD),
                    resnet_checkpoint=str(directory), device="cpu")


def test_checkpoint_and_resume_carry_the_critic(tmp_path):
    """A GAN run with EMA, accumulation and smoothed labels saves its resume
    point after an epoch; a new SRModel of the same config resumes it
    (generator, critic parameters and statistics, both optimizers with
    their accumulators and NaN guards, the shadow, the step and the random
    stream that draws the labels) and its next step equals the first run's,
    bit for bit. Restoring the best checkpoint restores the critic too."""
    kw = dict(ema_decay=0.9, grad_accum_steps=2)

    def build(root):
        _, gen = _generators(root)
        disc = Discriminator.initialize_standard(label_smoothing=True, smoothing_offset=0.2,
                                                 num_filters=8, input_dims=(32, 32),
                                                 dtype="float32", device="cpu")
        return SRModel("gan", gen, "Adam", {"learning_rate": 1e-3}, disc, "Adam",
                       {"learning_rate": 1e-3}, config=_cfg(tmp_path / "run"), device="cpu",
                       **kw)

    batches = _batches(5, seed=4)
    first = build(tmp_path / "a")
    first.before_epoch()
    for lr, hr in batches[:3]:
        first.train_step(lr, hr)
        first.after_train_batch()
    first.after_epoch()
    saved_disc = {k: v.clone() for k, v in first.discriminator_wrapper().model().state_dict()
                  .items()}
    first.train_step(*batches[3])

    second = build(tmp_path / "b")
    assert second.resume_training() == 1 and second.step == 3
    for k, v in second.discriminator_wrapper().model().state_dict().items():
        assert torch.equal(v, saved_disc[k]), k
    assert second.optimizer.inner.mini_step == 1
    second.train_step(*batches[3])
    for part in (lambda m: m.generator(), lambda m: m.discriminator_wrapper().model()):
        for (k, x), y in zip(part(first).state_dict().items(),
                             part(second).state_dict().values()):
            assert torch.equal(x, y), k
    assert all(torch.equal(x, y) for x, y in zip(first.ema_parameters, second.ema_parameters))

    first._restore_latest_checkpoint()
    for k, v in first.discriminator_wrapper().model().state_dict().items():
        assert torch.equal(v, saved_disc[k]), k
    path = tmp_path / "run" / "checkpoints" / "gan" / "step_3.pt"
    state = torch.load(path, weights_only=True)
    assert {"d_params", "d_optimizer", "ema", "optimizer_structure"} <= set(state)


@pytest.mark.parametrize("arch", ["srresnet", "rrdb"])
def test_gan_model_files_equal_flax_bytes(tmp_path, arch):
    """save_model of a GAN model writes ``gan_gen_<postfix>.msgpack`` with
    the bytes that the JAX package writes for the same weights, raw and EMA
    (the shadow starts at the parameters)."""
    jax_model, model = _gan_pair(tmp_path, arch=arch, ema_decay=0.99)
    for postfix, ema in (("x", False), ("x_ema", True)):
        ref = jax_model.save_model(str(tmp_path / "jax_files"), postfix=postfix, ema=ema)
        got = model.save_model(str(tmp_path / "port_files"), postfix=postfix, ema=ema)
        assert os.path.basename(got) == os.path.basename(ref) == f"gan_gen_{postfix}.msgpack"
        with open(got, "rb") as a, open(ref, "rb") as b:
            assert a.read() == b.read()
