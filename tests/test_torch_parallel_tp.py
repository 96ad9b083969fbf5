"""The port's tensor parallelism on 4 gloo ranks of the CPU against the JAX
package's on a 4-device slice of the 8-device CPU mesh
(tests/parallel/test_tensor.py and test_tp_training.py): SRResNet's and
RRDB's forwards on a model axis and on dp x tp, their gradients, the
refusals, and SRModel(tensor_parallel=True) training. The RRDB and GAN
training runs and the pure-TP run with an odd batch are held against the
port on one process (the GAN's smoothed labels come from torch's
generator); SRResNet's dp x tp training against the JAX SRModel. All ranks
run once, in the module's fixture (tests/_ranks_tp.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _ranks import assert_close, start_ranks
from simplesr_tpu.parallel import DATA_AXIS, MODEL_AXIS
from simplesr_tpu.parallel import make_mesh as jax_make_mesh
from simplesr_tpu.parallel import tp_apply as jax_tp_apply
from simplesr_tpu.train import Generator as JaxGenerator
from simplesr_tpu.train import SRModel as JaxSRModel
from simplesr_tpu.train.serialization import load_model as jax_load_model
from simplesr_tpu_torch.parallel import tp_param_specs
from simplesr_tpu_torch.train import Discriminator, Generator
from simplesr_tpu_torch.train.serialization import save_model

WORLD = 4
FWD = dict(rtol=1e-5, atol=1e-5)     # tests/parallel/test_tensor.py:38
GRAD = dict(rtol=1e-4, atol=1e-6)    # tests/parallel/test_tensor.py:69
TRAIN = dict(rtol=1e-4, atol=1e-6)   # tests/parallel/test_tp_training.py:68


@pytest.fixture(scope="module", autouse=True)
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(0)
    inputs = {"x": rng.uniform(0, 1, (2, 12, 12, 3)).astype(np.float32),
              "x4": rng.uniform(0, 1, (4, 12, 12, 3)).astype(np.float32),
              "xg": rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32),
              "train_batch": (rng.uniform(0, 1, (4, 8, 8, 3)).astype(np.float32),
                              rng.uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32))}
    gens = {"srresnet": Generator.srresnet(4, num_blocks=3, num_filters=16, batch_norm=False,
                                           dtype="float32", seed=3, device="cpu"),
            "rrdb": Generator.rrdb(4, num_blocks=2, num_dense_blocks=2, num_convs=3,
                                   num_filters=16, dtype="float32", seed=4, device="cpu"),
            "srresnet_train": Generator.srresnet(2, num_blocks=2, num_filters=8,
                                                 batch_norm=False, dtype="float32", seed=5,
                                                 device="cpu"),
            "rrdb_train": Generator.rrdb(2, num_blocks=1, num_dense_blocks=2, num_convs=2,
                                         num_filters=8, dtype="float32", seed=6, device="cpu")}
    for name, gen in gens.items():
        inputs[name] = str(root / f"{name}.msgpack")
        save_model(gen.module_config(), gen.variables, inputs[name])
    inputs["disc"] = Discriminator.initialize_standard(
        num_filters=8, input_dims=(16, 16), dtype="float32", device="cpu").variables
    return inputs, start_ranks("_ranks_tp", "body", WORLD, root / "ranks", inputs), root


def _jax(path):
    module, variables = jax_load_model(path)
    return module, variables["params"]


def _mesh(axes):
    return jax_make_mesh(axes, devices=jax.devices()[:WORLD])


def test_tp_param_specs_match_jax(setup):
    """The port's split dims, in flax's layouts, are the JAX specs."""
    from simplesr_tpu.parallel import tp_param_specs as jax_specs
    from simplesr_tpu_torch.train.convert import _flax_path
    from simplesr_tpu_torch.parallel.fsdp import _flax_dims
    from simplesr_tpu_torch.train.serialization import load_model

    inputs, _, _ = setup
    for arch in ("srresnet", "rrdb"):
        jmodule, _ = _jax(inputs[arch])
        leaves = jax.tree_util.tree_flatten_with_path(
            jax_specs(jmodule), is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
        want = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(s)
                for path, s in leaves}
        module = load_model(inputs[arch], device="cpu")
        for name, spec in tp_param_specs(module).items():
            p = dict(module.named_parameters())[name]
            dims = _flax_dims(p.dim())
            flax_spec = [None] * p.dim()
            for d, axis in enumerate(spec):
                if axis:
                    flax_spec[dims.index(d)] = axis
            while flax_spec and flax_spec[-1] is None:
                flax_spec.pop()
            jspec = list(want["/".join(_flax_path(name, p.dim())[1])])
            while jspec and jspec[-1] is None:
                jspec.pop()
            assert flax_spec == jspec, (arch, name)


def test_tp_training_matches_jax_dp_tp(setup, tmp_path):
    inputs, ranks, _ = setup
    jm = _jax_train_model(inputs, tmp_path, _mesh({DATA_AXIS: 2, MODEL_AXIS: 2}), True)
    for _ in range(2):
        jm.train_step(*inputs["train_batch"])
    want = {"params": jax.device_get(jm.state.g_params)}
    for out in ranks:
        assert_close(out["train_srresnet"], want, **TRAIN)


@pytest.mark.parametrize("arch", ["srresnet", "rrdb"])
def test_tp_forward_matches_jax_tp(setup, arch):
    inputs, ranks, _ = setup
    module, params = _jax(inputs[arch])
    want = np.asarray(jax.jit(jax_tp_apply(module, _mesh({MODEL_AXIS: WORLD})))(
        params, jnp.asarray(inputs["x"])))
    assert want.shape == (2, 48, 48, 3)
    for out in ranks:
        np.testing.assert_allclose(out[f"{arch}_fwd"], want, **FWD)


@pytest.mark.parametrize("arch", ["srresnet", "rrdb"])
def test_tp_composes_with_data_axis(setup, arch):
    inputs, ranks, _ = setup
    module, params = _jax(inputs[arch])
    mesh = _mesh({DATA_AXIS: 2, MODEL_AXIS: 2})
    want = np.asarray(jax.jit(jax_tp_apply(module, mesh, batch_axis=DATA_AXIS))(
        params, jnp.asarray(inputs["x4"])))
    for out in ranks:
        np.testing.assert_allclose(out[f"{arch}_dptp"], want, **FWD)


@pytest.mark.parametrize("arch", ["srresnet", "rrdb"])
def test_tp_gradients_match_jax_tp(setup, arch):
    inputs, ranks, _ = setup
    module, params = _jax(inputs[arch])
    f = jax_tp_apply(module, _mesh({MODEL_AXIS: WORLD}))
    x = jnp.asarray(inputs["xg"])
    want = jax.jit(jax.grad(lambda p: jnp.mean(f(p, x) ** 2)))(params)
    for out in ranks:
        assert_close({"params": out[f"{arch}_grads"]["params"]}, {"params": want}, **GRAD)


def test_tp_rejects_bad_configs(setup):
    _, ranks, _ = setup
    for out in ranks:
        e = out["errors"]
        assert "divisible" in e["filters"]
        assert "batch_norm" in e["batch_norm"]
        assert "growth width" in e["growth"]
        assert e["wide_shape"] == (1, 32, 32, 3)
        assert "'model' axis" in e["no_model_axis"]


def _jax_train_model(inputs, root, mesh, tp):
    module, variables = jax_load_model(inputs["srresnet_train"])
    gen = JaxGenerator.srresnet(upsample_factor=2, num_blocks=2, num_filters=8,
                                batch_norm=False, dtype=jnp.float32, input_dims=(8, 8),
                                pretrained_model=(module, variables))
    from _ranks_dp import cfg
    return JaxSRModel("resnet", gen, "SGD", {"learning_rate": 1e-2}, config=cfg(root),
                      mesh=mesh, tensor_parallel=tp, async_checkpointing=False)


def _single(inputs, root, arch="srresnet", **kw):
    import _ranks_tp
    return _ranks_tp.run_model(inputs, root, None, arch, **kw)


def test_rrdb_tp_training_matches_one_process(setup, tmp_path):
    inputs, ranks, _ = setup
    import _ranks_dp
    want = _ranks_dp.variables(_single(inputs, tmp_path, "rrdb").generator())
    for out in ranks:
        assert_close(out["train_rrdb"], want, **TRAIN)


def test_tp_only_mesh_takes_an_odd_batch_whole(setup, tmp_path):
    inputs, ranks, _ = setup
    import _ranks_dp
    odd = tuple(a[:3] for a in inputs["train_batch"])
    want = _ranks_dp.variables(_single(inputs, tmp_path, steps=1, batch=odd).generator())
    for out in ranks:
        assert_close(out["train_odd"], want, **TRAIN)


def test_tp_gan_training_matches_one_process(setup, tmp_path):
    inputs, ranks, _ = setup
    import _ranks_dp
    m = _single(inputs, tmp_path, gan=True, seed=5)
    for out in ranks:
        assert_close(out["train_gan"]["g"], _ranks_dp.variables(m.generator()), **TRAIN)
        assert_close(out["train_gan"]["d"],
                     _ranks_dp.variables(m.discriminator_wrapper().model()), **TRAIN)


def test_tp_validation_and_generate(setup):
    _, ranks, _ = setup
    for out in ranks:
        assert np.isfinite(out["valid_loss"])
        assert out["generate_shape"] == (4, 16, 16, 3)
