"""The port's pipeline parallelism on 4 gloo ranks of the CPU against the
JAX package's on a 4-device slice of the 8-device CPU mesh
(tests/parallel/test_pipeline_parallel.py and test_pp_training.py): the
staged forward for several microbatch counts and on dp x pp, its gradients,
the refusals, and SRModel(pipeline_parallel=True) training. All ranks run
once, in the module's fixture (tests/_ranks_pp.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _ranks import assert_close, start_ranks
from simplesr_tpu.parallel import DATA_AXIS, STAGE_AXIS
from simplesr_tpu.parallel import make_mesh as jax_make_mesh
from simplesr_tpu.parallel import pipeline_apply as jax_pipeline_apply
from simplesr_tpu.train import Generator as JaxGenerator
from simplesr_tpu.train import SRModel as JaxSRModel
from simplesr_tpu.train.serialization import load_model as jax_load_model
from simplesr_tpu_torch.train import Generator
from simplesr_tpu_torch.train.serialization import save_model

WORLD = 4
FWD = dict(rtol=1e-6, atol=1e-6)    # tests/parallel/test_pipeline_parallel.py:36
GRAD = dict(rtol=1e-4, atol=1e-7)   # tests/parallel/test_pipeline_parallel.py:67
TRAIN = dict(rtol=1e-4, atol=1e-6)  # tests/parallel/test_pp_training.py:71


@pytest.fixture(scope="module", autouse=True)
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("pp")
    rng = np.random.default_rng(0)
    inputs = {"x": rng.uniform(0, 1, (4, 10, 10, 3)).astype(np.float32),
              "x2": rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32),
              "xg": rng.uniform(0, 1, (4, 8, 8, 3)).astype(np.float32)}
    for n in (8, 4):
        inputs[f"batch{n}"] = (rng.uniform(0, 1, (n, 8, 8, 3)).astype(np.float32),
                               rng.uniform(-1, 1, (n, 16, 16, 3)).astype(np.float32))
    for name, blocks in (("gen", 8), ("train_gen", 4)):
        g = Generator.srresnet(2, num_blocks=blocks, num_filters=8, batch_norm=False,
                               dtype="float32", seed=blocks, device="cpu")
        inputs[name] = str(root / f"{name}.msgpack")
        save_model(g.module_config(), g.variables, inputs[name])
    return inputs, start_ranks("_ranks_pp", "body", WORLD, root / "ranks", inputs), root


def _mesh(axes):
    return jax_make_mesh(axes, devices=jax.devices()[:WORLD])


def test_pipeline_gradients_match_jax(setup):
    inputs, ranks, _ = setup
    module, variables = jax_load_model(inputs["gen"])
    f = jax_pipeline_apply(module, _mesh({STAGE_AXIS: 4}), 2)
    x = jnp.asarray(inputs["xg"])
    want = jax.jit(jax.grad(lambda p: jnp.mean(f(p, x) ** 2)))(variables["params"])
    for out in ranks:
        assert_close({"params": out["grads"]["params"]}, {"params": want}, **GRAD)


@pytest.mark.parametrize("key,axes,m,x", [
    ("fwd_4", {STAGE_AXIS: 4}, 4, "x"), ("fwd_2", {STAGE_AXIS: 4}, 2, "x"),
    ("fwd_dp", {DATA_AXIS: 2, STAGE_AXIS: 2}, 2, "x"),
    ("fwd_1", {DATA_AXIS: 2, STAGE_AXIS: 2}, 1, "x2")])
def test_pipeline_matches_jax_pipeline(setup, key, axes, m, x):
    inputs, ranks, _ = setup
    module, variables = jax_load_model(inputs["gen"])
    mesh = _mesh(axes)
    batch_axis = DATA_AXIS if DATA_AXIS in axes else None
    want = np.asarray(jax.jit(jax_pipeline_apply(module, mesh, m, batch_axis=batch_axis))(
        variables["params"], jnp.asarray(inputs[x])))
    for out in ranks:
        np.testing.assert_allclose(out[key], want, **FWD)


def test_pipeline_rejects_bad_configs(setup):
    _, ranks, _ = setup
    for out in ranks:
        e = out["errors"]
        assert "divisible" in e["blocks"] and "divisible" in e["indivisible"]
        assert "batch_norm" in e["batch_norm"]
        assert "not divisible by microbatches" in e["microbatches"]
        assert "'stage' axis" in e["no_stage_axis"]
        assert "mutually exclusive" in e["exclusive"]


def _jax_model(inputs, root, mesh, microbatches=None):
    module, variables = jax_load_model(inputs["train_gen"])
    gen = JaxGenerator.srresnet(upsample_factor=2, num_blocks=4, num_filters=8,
                                batch_norm=False, dtype=jnp.float32, input_dims=(8, 8),
                                pretrained_model=(module, variables))
    from _ranks_dp import cfg
    return JaxSRModel("resnet", gen, "SGD", {"learning_rate": 1e-2}, config=cfg(root),
                      mesh=mesh, pipeline_parallel=mesh is not None,
                      pipeline_microbatches=microbatches, async_checkpointing=False)


@pytest.mark.parametrize("m", [2, 4])
def test_pp_training_matches_jax_dp_pp(setup, tmp_path, m):
    inputs, ranks, _ = setup
    jm = _jax_model(inputs, tmp_path, _mesh({DATA_AXIS: 2, STAGE_AXIS: 2}), m)
    for _ in range(2):
        jm.train_step(*inputs["batch8"])
    want = {"params": jax.device_get(jm.state.g_params)}
    for out in ranks:
        assert_close(out[f"train_{m}"], want, **TRAIN)


def test_pp_only_mesh_and_the_config_factory(setup, tmp_path):
    """A pure stage mesh takes the batch whole (microbatches default to the
    stage count); ``pipeline_parallel: 4`` in a config builds a data x stage
    mesh. Both against the JAX SRModel on one device."""
    inputs, ranks, _ = setup
    single = _jax_model(inputs, tmp_path, None)
    single.train_step(*inputs["batch4"])
    want = {"params": jax.device_get(single.state.g_params)}
    factory = _jax_model(inputs, tmp_path / "f", None)
    factory.train_step(*inputs["batch8"])
    for out in ranks:
        assert_close(out["train_only"], want, **TRAIN)
        assert out["factory"]["mesh"] == {"data": 1, "stage": 4}
        assert_close(out["factory"]["vars"],
                     {"params": jax.device_get(factory.state.g_params)}, **TRAIN)


def test_pp_validation_and_generate(setup):
    _, ranks, _ = setup
    for out in ranks:
        assert np.isfinite(out["valid_loss"])
        assert out["generate_shape"] == (8, 16, 16, 3)
