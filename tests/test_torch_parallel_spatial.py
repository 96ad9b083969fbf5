"""The port's spatially-sharded inference on 4 gloo ranks of the CPU
against the JAX package's on a 4-device slice of the 8-device CPU mesh
(tests/parallel/test_spatial_exactness.py and test_parallel.py): the halo
exchange, a local model (exact), SRResNet and its polyphase serving form
(both packages with zero outer halos), the batched 2-D mesh, and the
refusals. All ranks run once, in the module's fixture
(tests/_ranks_spatial.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _ranks import start_ranks
from simplesr_tpu.models.polyphase import polyphase_model as jax_polyphase_model
from simplesr_tpu.parallel import DATA_AXIS, SPATIAL_AXIS
from simplesr_tpu.parallel import make_mesh as jax_make_mesh
from simplesr_tpu.parallel import spatial_sharded_apply as jax_spatial
from simplesr_tpu.parallel import spatial_sharded_apply_batched as jax_spatial_batched
from simplesr_tpu.train.serialization import load_model as jax_load_model
from simplesr_tpu_torch.train import Generator
from simplesr_tpu_torch.train.serialization import save_model

WORLD = 4
EXACT = dict(atol=2e-5, rtol=1e-4)  # tests/parallel/test_spatial_exactness.py:35
POLY = dict(atol=1e-3, rtol=1e-3)   # tests/parallel/test_spatial_exactness.py:60


@pytest.fixture(scope="module", autouse=True)
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("spatial")
    rng = np.random.default_rng(0)
    inputs = {"ring": rng.uniform(size=(32, 4, 3)).astype(np.float32),
              "blur_img": rng.uniform(size=(64, 16, 3)).astype(np.float32),
              "img": rng.uniform(0, 1, (128, 32, 3)).astype(np.float32),
              "imgs": rng.uniform(0, 1, (4, 128, 32, 3)).astype(np.float32)}
    gen = Generator.srresnet(2, num_blocks=1, num_filters=8, batch_norm=False, dtype="float32",
                             seed=7, device="cpu")
    inputs["gen"] = str(root / "gen.msgpack")
    save_model(gen.module_config(), gen.variables, inputs["gen"])
    return inputs, start_ranks("_ranks_spatial", "body", WORLD, root / "ranks", inputs)


def _jax_model(path):
    module, variables = jax_load_model(path)
    return module, variables, lambda x: module.apply(variables, x, train=False)


def _jit(fn, x):
    """``fn(x)`` as one compiled program (the same numbers as eager
    dispatch, op by op, in a tenth of the time)."""
    return np.asarray(jax.jit(fn)(x))


def test_srresnet_spatial_matches_jax_spatial(setup):
    inputs, ranks = setup
    _, _, apply = _jax_model(inputs["gen"])
    mesh = jax_make_mesh({SPATIAL_AXIS: WORLD}, devices=jax.devices()[:WORLD])
    img = jnp.asarray(inputs["img"])
    want = _jit(lambda x: jax_spatial(apply, x, mesh, scale=2, halo=16), img)
    direct = _jit(apply, img[None])[0]
    m = 32
    for out in ranks:
        assert out["srresnet"].shape == want.shape == (256, 64, 3)
        np.testing.assert_allclose(out["srresnet"], want, **EXACT)   # borders included
        np.testing.assert_allclose(out["srresnet"][m:-m], direct[m:-m], **EXACT)


def test_halo_exchange_ring(setup):
    inputs, ranks = setup
    x, rows = inputs["ring"], 32 // WORLD
    for rank, out in enumerate(ranks):
        strip = out["halo"]
        assert strip.shape == (rows + 4, 4, 3)
        top = x[rank * rows - 2:rank * rows] if rank else np.zeros((2, 4, 3), np.float32)
        bottom = x[(rank + 1) * rows:(rank + 1) * rows + 2] if rank < WORLD - 1 \
            else np.zeros((2, 4, 3), np.float32)
        np.testing.assert_array_equal(strip[:2], top)
        np.testing.assert_array_equal(strip[2:-2], x[rank * rows:(rank + 1) * rows])
        np.testing.assert_array_equal(strip[-2:], bottom)


def test_spatial_exact_for_a_local_model(setup):
    inputs, ranks = setup
    import _ranks_spatial
    import torch
    direct = _ranks_spatial.blur_up(torch.from_numpy(inputs["blur_img"])[None])[0].numpy()
    for out in ranks:
        assert out["local"].shape == direct.shape == (128, 32, 3)
        np.testing.assert_allclose(out["local"][4:-4], direct[4:-4], atol=1e-6)


def test_polyphase_spatial_matches_jax(setup):
    inputs, ranks = setup
    module, variables, _ = _jax_model(inputs["gen"])
    poly, pvars = jax_polyphase_model(module, variables)
    mesh = jax_make_mesh({SPATIAL_AXIS: WORLD}, devices=jax.devices()[:WORLD])
    want = _jit(lambda x: jax_spatial(lambda y: poly.apply(pvars, y, train=False), x, mesh,
                                      scale=2, halo=16), jnp.asarray(inputs["img"]))
    for out in ranks:
        np.testing.assert_allclose(out["polyphase"], want, **POLY)


def test_batched_2d_mesh_matches_jax(setup):
    inputs, ranks = setup
    _, _, apply = _jax_model(inputs["gen"])
    mesh = jax_make_mesh({DATA_AXIS: 2, SPATIAL_AXIS: WORLD // 2}, devices=jax.devices()[:WORLD])
    want = _jit(lambda x: jax_spatial_batched(apply, x, mesh, scale=2, halo=16),
                jnp.asarray(inputs["imgs"]))
    for out in ranks:
        assert out["batched"].shape == want.shape == (4, 256, 64, 3)
        np.testing.assert_allclose(out["batched"], want, **EXACT)


def test_indivisible_sizes_raise(setup):
    _, ranks = setup
    for out in ranks:
        assert "image height 30 not divisible" in out["errors"]["height"]
        assert "batch 3 not divisible" in out["errors"]["batch"]
        assert "image height 31 not divisible" in out["errors"]["batched_height"]
