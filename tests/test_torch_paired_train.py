"""SRModel's paired mode (``paired_ways``, YAML ``paired_train``) against
simplesr_tpu's, on the same seeded inputs and the same weights (flax's,
carried over by train/convert.py). The JAX package trains that mode on its
packed layout (simplesr_tpu/train/paired.py); the port trains the standard
forward, which computes the same function: these tests hold the port's
forward and gradients to the JAX packed ones, and its paired SRModel to the
JAX paired SRModel's trajectory, trimming and guards.

Tolerances: float32 forwards and gradients agree to 1e-5 (the packed and
the unpacked layouts sum each conv in another order, as do the two
packages); SGD trajectories to the trainer tests' atol 1e-5. At bf16 every
activation is rounded to 8 significant bits (a relative step of 2**-8 =
3.9e-3), and the two layouts and the two packages round sums of other
orders, so single values of the [-1, 1] output may differ by a few bf16
steps of the pre-tanh value (4e-3 each near 1): BF16_MAX_ABS bounds the
largest difference at a few such steps and BF16_MEAN_ABS the mean one. Both
lie far above what this 8-wide model shows (max 5e-7: its short sums round
alike) and far below a wrong layout (a swapped stream moves the output by
tenths).
"""

import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplesr_tpu.models.srresnet import SRResNet as JaxSRResNet
from simplesr_tpu.train import Generator as JaxGenerator
from simplesr_tpu.train import SRModel as JaxSRModel
from simplesr_tpu.train.paired import paired_train_apply as jax_paired_train_apply
from simplesr_tpu.train.serialization import save_model as jax_save_model
from simplesr_tpu_torch.config import ConfigUtil, _yaml
from simplesr_tpu_torch.models import build_generator_model
from simplesr_tpu_torch.train import Generator, SRModel, from_flax_variables, to_flax_variables

ROOT = Path(__file__).resolve().parents[1]
GALLERY = str(ROOT / "data/corpus/gallery")
PRODUCTION = ROOT / "examples/training/srresnet_x4_paired_production.yaml"
TOL = 1e-5
BF16_MAX_ABS = 2e-2
BF16_MEAN_ABS = 2e-3


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


def _pair(scale=2, blocks=2, filters=8, dtype="float32", seed=0, remat=False):
    """A JAX SRResNet with its parameters and the port's module with the
    same weights (PReLU slopes drawn away from 0 so that they matter)."""
    jdt = getattr(jnp, dtype)
    module = JaxSRResNet(upsample_factor=scale, num_filters=filters, num_res_blocks=blocks,
                         batch_norm=False, dtype=jdt, remat=remat)
    x0 = jnp.zeros((2, 8, 8, 3))
    variables = jax.device_get(module.init(jax.random.key(seed), x0, train=True))
    rng = np.random.default_rng(seed)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, v: rng.uniform(0.05, 0.3, v.shape).astype(np.float32)
        if "alpha" in jax.tree_util.keystr(p) else np.asarray(v), variables)
    port = build_generator_model(scale, num_blocks=blocks, num_filters=filters,
                                 batch_norm=False, dtype=dtype, device="cpu")
    port.load_state_dict(from_flax_variables(port, variables))
    return module, variables["params"], port


def _inputs(b, hw, seed=1):
    return np.random.default_rng(seed).uniform(0, 1, (b, hw, hw, 3)).astype(np.float32)


@pytest.mark.parametrize("scale", [2, 4])
@pytest.mark.parametrize("ways", [2, 4])
def test_forward_matches_jax(scale, ways):
    """The port's train forward in paired mode (the module's own) against
    JAX's packed one."""
    module, params, port = _pair(scale=scale)
    x = _inputs(4, 8)
    want = np.asarray(jax_paired_train_apply(module, ways)(params, jnp.asarray(x)))
    got = port(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (4, 8 * scale, 8 * scale, 3)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("remat", [False, True])
def test_gradients_match_jax_packed(remat):
    """Every parameter's gradient through the port's forward against JAX's
    packed gradients (``remat`` recomputes JAX's packed blocks)."""
    module, params, port = _pair(scale=2, remat=remat)
    x = _inputs(4, 8)
    y = np.random.default_rng(7).uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
    paired = jax_paired_train_apply(module, 2)
    jax_grads = jax.grad(lambda p: jnp.mean((paired(p, jnp.asarray(x)) - y) ** 2))(params)
    jax_grads = to_flax_variables(from_flax_variables(port, {"params": jax.device_get(
        jax_grads)}))["params"]
    torch.mean((port(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).backward()
    got = to_flax_variables({k: p.grad for k, p in port.named_parameters()})["params"]
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v)
                      for k, v in jax.tree_util.tree_leaves_with_path(t)}
    got, jax_grads = flat(got), flat(jax_grads)
    assert got.keys() == jax_grads.keys() and len(got) > 10
    for k in got:
        np.testing.assert_allclose(got[k], jax_grads[k], atol=TOL, rtol=TOL, err_msg=k)


def test_bf16_forward_within_its_bound():
    module, params, port = _pair(scale=4, filters=8, dtype="bfloat16")
    x = _inputs(4, 8)
    jax_out = np.asarray(jax_paired_train_apply(module, 2)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    diff = np.abs(got - jax_out)
    assert diff.max() < BF16_MAX_ABS and diff.mean() < BF16_MEAN_ABS, diff.max()


def _models(tmp_path, paired_ways=2, config=None):
    """A JAX and a port SRModel (x2, 1 block, 8 filters, float32, SGD) from
    the same initial weights."""
    jax_gen = JaxGenerator.srresnet(upsample_factor=2, num_blocks=1, num_filters=8,
                                    batch_norm=False, dtype=jnp.float32, input_dims=(8, 8))
    init = str(tmp_path / "init.msgpack")
    jax_save_model(jax_gen.module_config(), jax_gen.variables, init)
    gen = Generator.srresnet(2, num_blocks=1, num_filters=8, batch_norm=False,
                             dtype="float32", pretrained_model_path=init, device="cpu")
    config = config or {"learning_rate": 0.05}
    jax_model = JaxSRModel("resnet", jax_gen, "SGD", dict(config), config=_cfg(tmp_path / "jax"),
                           async_checkpointing=False, paired_ways=paired_ways)
    model = SRModel("resnet", gen, "SGD", dict(config), config=_cfg(tmp_path / "port"),
                    device="cpu", paired_ways=paired_ways)
    return jax_model, model


def test_sr_model_paired_sgd_trajectory_matches_jax(tmp_path):
    jax_model, model = _models(tmp_path)
    rng = np.random.default_rng(3)
    for m in (jax_model, model):
        m.before_epoch()
    for _ in range(3):
        lr = rng.uniform(0, 1, (4, 8, 8, 3)).astype(np.float32)
        hr = rng.uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
        for m in (jax_model, model):
            m.train_step(lr, hr)
            m.after_train_batch()
    want = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(jax_model.state.g_params)}
    got = to_flax_variables(model.generator().state_dict())["params"]
    got = {jax.tree_util.keystr(k): np.asarray(v)
           for k, v in jax.tree_util.tree_leaves_with_path(got)}
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL, err_msg=k)
    ref = [float(v) for v in jax_model.histories()["train_batch"]["generator_loss"]]
    out = [float(v) for v in model.histories()["train_batch"]["generator_loss"]]
    np.testing.assert_allclose(out, ref, rtol=TOL)
    assert model.step == int(jax_model.state.step) == 3


def test_uneven_batches_trimmed_or_skipped(tmp_path, caplog):
    _, model = _models(tmp_path)
    rng = np.random.default_rng(1)
    lr = rng.uniform(0, 1, (3, 8, 8, 3)).astype(np.float32)
    hr = rng.uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32)
    with caplog.at_level(logging.WARNING, logger="simple_sr"):
        model.train_step(lr, hr)
    assert model.step == 1 and "trimming uneven batch 3 -> 2" in caplog.text
    with caplog.at_level(logging.WARNING, logger="simple_sr"):
        model.train_step(lr[:1], hr[:1])
    assert model.step == 1 and "skipping batch of 1" in caplog.text
    model.validation_step(lr, hr)  # the standard layout: odd batches pass


def test_guards_raise(tmp_path):
    """The JAX package's guards, raised by the SRModel constructor."""
    def model(gen, ways=2):
        return SRModel("resnet", gen, "SGD", {"learning_rate": 0.1}, config=_cfg(tmp_path),
                       device="cpu", paired_ways=ways)

    bn = Generator.srresnet(2, num_blocks=1, num_filters=8, batch_norm=True, device="cpu")
    with pytest.raises(ValueError, match="batch_norm"):
        model(bn)
    rrdb = Generator.rrdb(2, num_blocks=1, num_filters=8, device="cpu")
    with pytest.raises(TypeError, match="plain SRResNet"):
        model(rrdb)
    gen = Generator.srresnet(2, num_blocks=1, num_filters=8, batch_norm=False,
                             dtype="float32", device="cpu")
    for kw in ({"tensor_parallel": True}, {"pipeline_parallel": True}):
        with pytest.raises(ValueError, match="mutually exclusive"):
            SRModel("resnet", gen, "SGD", {"learning_rate": 0.1}, config=_cfg(tmp_path),
                    device="cpu", paired_ways=2, **kw)
    with pytest.raises(ValueError, match="ways must be >= 2"):
        model(gen, 1)
    assert model(gen, "2")._paired_ways == 2


def test_production_recipe_builds_a_paired_model(tmp_path):
    """The production recipe as written (``paired_train: 2``), its data,
    results and generator width cut for the CPU: ``SRModel.init`` builds the
    paired mode, which trains the module's own forward."""
    spec = _yaml.load(PRODUCTION)
    assert spec["general"]["paired_train"] == 2
    spec["general"].update(train_data_paths=GALLERY, results_save_path=str(tmp_path),
                           crop_size=(16, 16, 3), num_crops=1, random_seed=0)
    spec["model"]["generator"].update(num_blocks=1, num_filters=8, dtype="float32")
    conf, pipeline, model = ConfigUtil.from_yaml(spec, device="cpu")
    assert conf.paired_train == 2 and model._paired_ways == 2
    lr, hr = next(iter(pipeline.train_batch_generator()))
    assert lr.shape[0] == 16
    module = model.generator()
    state = {k: v.clone() for k, v in module.state_dict().items()}
    model.train_step(lr, hr)
    assert model.step == 1
    assert any(not torch.equal(state[k], v) for k, v in module.state_dict().items())
