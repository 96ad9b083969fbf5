"""The port's SRModel (ResNet mode) against simplesr_tpu's, driven through the
same lifecycle on the same batches from the same initial weights: SGD
trajectories, histories, model files, checkpoints and early stopping."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplesr_tpu.train import Generator as JaxGenerator
from simplesr_tpu.train import SRModel as JaxSRModel
from simplesr_tpu.train.serialization import load_model as jax_load_model
from simplesr_tpu.train.serialization import save_model as jax_save_model
from simplesr_tpu_torch.core.ranges import normalize_01, normalize_11
from simplesr_tpu_torch.data.png import read_png
from simplesr_tpu_torch.ops.resize import resize
from simplesr_tpu_torch.train import Generator, SRModel, to_flax_variables

GALLERY = sorted((Path(__file__).resolve().parents[1] / "data/corpus/gallery").glob("*.png"))
HR = 24
EPOCHS, STEPS = 2, 3


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


def _batches(count, batch=2):
    """HR crops of 24 x 24 from the gallery PNGs (port's read_png), HR in
    [-1, 1]; LR by the port's bicubic resize, in [0, 1]."""
    out = []
    for i in range(count):
        crops = []
        for j in range(batch):
            img = torch.from_numpy(read_png(GALLERY[(2 * i + j) % len(GALLERY)]))
            top, left = 17 * i + 5 * j, 23 * i + 11 * j
            crops.append(img[top:top + HR, left:left + HR].float())
        hr = torch.stack(crops)
        lr = resize(normalize_01(hr), (HR // 4, HR // 4), method="bicubic", antialias=True)
        out.append((lr.numpy(), normalize_11(hr).numpy()))
    return out


def _pair(tmp_path, num_filters, dtype, jax_dtype, config=None, **model_kw):
    """A JAX SRModel and a port SRModel over the same initial weights (the
    JAX generator's, through a model file)."""
    jax_gen = JaxGenerator.srresnet(upsample_factor=4, num_blocks=2, num_filters=num_filters,
                                    batch_norm=False, dtype=jax_dtype, input_dims=(6, 6))
    init = str(tmp_path / "init.msgpack")
    jax_save_model(jax_gen.module_config(), jax_gen.variables, init)
    gen = Generator.srresnet(4, num_blocks=2, num_filters=num_filters, batch_norm=False,
                             dtype=dtype, pretrained_model_path=init, device="cpu")
    config = config or {"learning_rate": 0.05}
    jax_model = JaxSRModel("resnet", jax_gen, "SGD", dict(config),
                           config=_cfg(tmp_path / "jax"), async_checkpointing=False, **model_kw)
    model = SRModel("resnet", gen, "SGD", dict(config), config=_cfg(tmp_path / "port"),
                    device="cpu", **model_kw)
    return jax_model, model


def _flat(variables):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(variables)}


def _floats(history):
    return {k: [float(v) for v in vs] for k, vs in history.items()}


def test_sgd_training_matches_jax(tmp_path):
    """Float32, 16 filters, 2 blocks, x4, batch 2: 3 SGD steps, a validation
    step and after_epoch, twice, then after_training. Parameters and every
    history value agree to 1e-5 (float32 convolutions summed in another
    order); the model files have the same names, and the port's ``_best``
    loads in JAX bit-equal to the port's parameters."""
    jax_model, model = _pair(tmp_path, 16, "float32", jnp.float32)
    batches = _batches(EPOCHS * STEPS + 1)
    for epoch in range(EPOCHS):
        for m in (jax_model, model):
            m.before_epoch()
            for lr, hr in batches[epoch * STEPS:(epoch + 1) * STEPS]:
                m.train_step(lr, hr)
                m.after_train_batch()
            m.validation_step(*batches[-1])
            m.after_validation_batch()
            m.after_epoch()
    for m in (jax_model, model):
        m.after_training()

    jax_params = _flat({"params": jax_model.state.g_params})
    port_params = _flat({"params": to_flax_variables(model.generator().state_dict())["params"]})
    assert jax_params.keys() == port_params.keys()
    for k, v in jax_params.items():
        np.testing.assert_allclose(port_params[k], v, rtol=0, atol=1e-5, err_msg=k)

    ref, got = jax_model.histories(), model.histories()
    assert ref.keys() == got.keys()
    for part in ref:
        assert ref[part].keys() == got[part].keys(), part
        for k, v in _floats(ref[part]).items():
            np.testing.assert_allclose(_floats(got[part])[k], v, rtol=1e-5, err_msg=(part, k))
    assert len(got["train_batch"]["generator_loss"]) == EPOCHS * STEPS
    assert model.step == int(jax_model.state.step)  # the best checkpoint's, restored
    assert model.best_metric == pytest.approx(float(jax_model.state.best_metric), rel=1e-5)

    names = sorted(p.name for p in (tmp_path / "port" / "models").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax" / "models").iterdir())
    assert names == ["resnet_gen_1.msgpack", "resnet_gen_2.msgpack", "resnet_gen_best.msgpack"]
    _, best = jax_load_model(str(tmp_path / "port" / "models" / "resnet_gen_best.msgpack"))
    for k, v in _flat(best).items():
        np.testing.assert_array_equal(v, port_params[k])


def test_bf16_width_64_step_through_the_trunk_function(tmp_path):
    """bf16, 64 filters: the trunk goes through TrunkFunction (the plain
    version on the CPU). One SGD step's loss agrees to rel 2e-2: flax rounds
    the trunk to bf16 at other points than the port's trunk (after the conv,
    again after the bias and the PReLU)."""
    jax_model, model = _pair(tmp_path, 64, "bfloat16", jnp.bfloat16)
    assert model.generator().uses_trunk_kernel
    lr, hr = _batches(1)[0]
    for m in (jax_model, model):
        m.train_step(lr, hr)
    ref = jax_model.generator_wrapper().batch_metrics()["generator_loss"].result()
    got = model.generator_wrapper().batch_metrics()["generator_loss"].result()
    assert got == pytest.approx(ref, rel=2e-2)
    assert model.optimizer.count == 1


def test_nonfinite_step_is_dropped(tmp_path):
    """As optax.apply_if_finite in the JAX SRModel: the step counts, the
    update does not, and the optimizer's count (the schedule's step) stays."""
    gen = Generator.srresnet(4, num_blocks=1, num_filters=8, batch_norm=False, device="cpu")
    model = SRModel("resnet", gen, "Adam", config=_cfg(tmp_path), device="cpu")
    lr, hr = _batches(1)[0]
    hr = hr.copy()
    hr[0, 0, 0, 0] = np.nan
    before = {k: v.clone() for k, v in model.generator().state_dict().items()}
    model.train_step(lr, hr)
    assert all(torch.equal(before[k], v) for k, v in model.generator().state_dict().items())
    assert model.step == 1
    assert model.optimizer.count == 0 and model.optimizer.notfinite_count == 1
    model.train_step(*_batches(1)[0])
    assert model.optimizer.count == 1 and model.optimizer.notfinite_count == 0


def test_early_stop_restores_the_best_checkpoint(tmp_path):
    """A metric that only falls after the first epoch: patience 2 stops the
    run after epoch 3, and the parameters come back to epoch 1's, which the
    checkpoint holds (keep 5, the port's own torch.save files)."""
    scores = iter([3.0, 2.0, 1.0, 0.5])

    def score(hr, sr):
        return torch.full((hr.shape[0],), next(scores))

    gen = Generator.srresnet(4, num_blocks=1, num_filters=8, batch_norm=False, seed=1,
                             device="cpu")
    model = SRModel("resnet", gen, "SGD", {"learning_rate": 0.1}, image_metrics={"score": score},
                    early_stop_metric="score", early_stop_patience=2,
                    config=_cfg(tmp_path), device="cpu")
    lr, hr = _batches(1)[0]
    epochs = 0
    while not model.stop_early():
        model.before_epoch()
        model.train_step(lr, hr)
        model.after_train_batch()
        model.after_epoch()
        epochs += 1
        if epochs == 1:
            best = {k: v.clone() for k, v in gen.model().state_dict().items()}
    assert epochs == 3
    assert model.histories()["train_epoch"]["score"] == [3.0, 2.0, 1.0]
    assert all(torch.equal(best[k], v) for k, v in gen.model().state_dict().items())
    assert model.step == 1 and model.best_metric == 3.0
    step, path = model.latest_checkpoint()
    assert step == 1 and Path(path).parent == tmp_path / "checkpoints" / "resnet"


def test_checkpoints_keep_five(tmp_path):
    gen = Generator.srresnet(2, num_blocks=1, num_filters=8, batch_norm=False, device="cpu")
    model = SRModel("resnet", gen, "Adam", config=_cfg(tmp_path), device="cpu")
    lr = np.random.default_rng(0).uniform(0, 1, (1, 6, 6, 3)).astype(np.float32)
    for _ in range(7):
        model.train_step(lr, np.zeros((1, 12, 12, 3), np.float32))
        model._save_checkpoint()
    files = sorted(p.name for p in (tmp_path / "checkpoints" / "resnet").iterdir())
    assert files == [f"step_{i}.pt" for i in (3, 4, 5, 6, 7)]


def test_constructor_checks_and_unported_options(tmp_path):
    gen = Generator.srresnet(2, num_blocks=1, num_filters=8, batch_norm=False, device="cpu")
    with pytest.raises(ValueError):
        SRModel("bogus", gen, device="cpu")
    with pytest.raises(ValueError):
        SRModel("resnet", None, device="cpu")
    with pytest.raises(ValueError):
        SRModel("gan", gen, "Adam", device="cpu")
    with pytest.raises(ValueError):
        SRModel("resnet", gen, grad_accum_steps=0, device="cpu")
    with pytest.raises(ValueError):
        SRModel("resnet", gen, ema_decay=1.5, device="cpu")
    # the parallel layer: a mesh is a DeviceMesh; tensor and pipeline
    # parallelism need their mesh axis (the JAX package's ValueErrors)
    with pytest.raises(TypeError, match="DeviceMesh"):
        SRModel("resnet", generator=gen, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="'model' axis"):
        SRModel("resnet", generator=gen, device="cpu", tensor_parallel=True)
    with pytest.raises(ValueError, match="'stage' axis"):
        SRModel("resnet", generator=gen, device="cpu", pipeline_parallel=True)
    # ported since: distillation (a spec without a teacher is refused as the
    # JAX package refuses it), paired training, the GAN mode, the warm start,
    # EMA and gradient accumulation
    with pytest.raises(ValueError, match="needs a 'model'"):
        SRModel("resnet", generator=gen, device="cpu", distill={"teacher": "x"})
    assert SRModel("resnet", generator=gen, device="cpu", paired_ways=2)._paired_ways == 2
    from simplesr_tpu_torch.train import Discriminator
    from simplesr_tpu_torch.train.optimizers import MultiSteps

    disc = Discriminator.initialize_standard(num_filters=8, input_dims=(8, 8), device="cpu")
    assert SRModel("gan", gen, discriminator=disc, discriminator_optimizer="Adam",
                   device="cpu").discriminator_wrapper() is disc
    empty = tmp_path / "no_run" / "resnet"
    empty.mkdir(parents=True)
    with pytest.raises(ValueError, match="no checkpoint"):
        SRModel("resnet", gen, resnet_checkpoint=str(empty), device="cpu")
    x = np.zeros((1, 4, 4, 3), np.float32)
    ema = SRModel("resnet", gen, ema_decay=0.999, device="cpu")
    assert torch.equal(ema.generate(x, ema=True), ema.generate(x))
    assert isinstance(SRModel("resnet", gen, grad_accum_steps=2, device="cpu").optimizer.inner,
                      MultiSteps)
    model = SRModel("resnet", gen, config=_cfg(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="ema_decay"):
        model.generate(x, ema=True)
    # writers and resume are ported: nothing to resume yet, then a resume point
    assert model.resume_training() is None
    model.save_resume_point()
    assert model.resume_training() == 0 and model.step == 0
    SRModel("resnet", gen, batch_train_summary_writer=None, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            SRModel("resnet", gen)
