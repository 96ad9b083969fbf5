"""The port's SREngine against the JAX package's: its routing by
``tile_threshold`` (an image whose shorter side lies in (1000, 2000] is
tiled at 500 and batched whole at 2000) and its device mesh (one replica a
device, the batch split across them; here a mesh of two ``cpu`` entries,
against the JAX engine on a 2-device slice of the 8-device CPU mesh)."""

import jax
import numpy as np
import pytest

from simplesr_tpu.parallel import make_mesh as jax_make_mesh
from simplesr_tpu.tools.serve import SREngine as JaxSREngine
from simplesr_tpu_torch.eval import evaluation
from simplesr_tpu_torch.parallel import make_mesh
from simplesr_tpu_torch.tools import serve
from simplesr_tpu_torch.train import Generator
from simplesr_tpu_torch.train.serialization import save_model

TOL = dict(rtol=1e-4, atol=1e-5)  # float32 model, both packages' serving form


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    gen = Generator.srresnet(2, num_blocks=1, num_filters=8, batch_norm=False, dtype="float32",
                             seed=11, device="cpu")
    path = str(tmp_path_factory.mktemp("engine") / "m.msgpack")
    save_model(gen.module_config(), gen.variables, path)
    return path


@pytest.fixture(scope="module")
def big():
    # shorter side 1016: over the tiled route's 1000, under 2000
    return np.random.default_rng(0).uniform(0, 1, (1016, 1032, 3)).astype(np.float32)


def _serve(engine, *imgs):
    try:
        return [engine.upscale(img) for img in imgs]
    finally:
        engine.close()


@pytest.mark.parametrize("threshold", [500, 2000])
def test_tile_threshold_routes_as_the_jax_engine(threshold, model_path, big, monkeypatch):
    want = _serve(JaxSREngine(model_path, 2, tile_threshold=threshold), big)[0]
    tiled = []
    inner = evaluation.tiled_apply
    monkeypatch.setattr(evaluation, "tiled_apply",
                        lambda *a, **k: (tiled.append(1), inner(*a, **k))[1])
    # at 500 the tiled route, its tiles split over a mesh of two replicas
    mesh = make_mesh(devices=["cpu", "cpu"]) if threshold == 500 else None
    got = _serve(serve.SREngine(model_path, 2, tile_threshold=threshold, mesh=mesh,
                                device="cpu"), big)[0]
    assert got.shape == want.shape == (2032, 2064, 3)
    assert bool(tiled) == (threshold == 500)  # untiled, batched whole, at 2000
    np.testing.assert_allclose(got, want, **TOL)


def test_a_mesh_of_two_devices_splits_the_batch(model_path):
    rng = np.random.default_rng(1)
    imgs = [rng.uniform(0, 1, (20, 24, 3)).astype(np.float32) for _ in range(3)]
    jmesh = jax_make_mesh(devices=jax.devices()[:2])
    want = _serve(JaxSREngine(model_path, 2, mesh=jmesh), *imgs)

    engine = serve.SREngine(model_path, 2, max_batch=1, mesh=make_mesh(devices=["cpu", "cpu"]),
                            device="cpu")
    assert engine.batch_sizes() == [2] and engine.max_batch == 2  # at least one a replica
    calls = []
    for i, (device, predict) in enumerate(engine._replicas):
        engine._replicas[i] = (device, lambda x, i=i, p=predict: (calls.append(
            (i, int(x.shape[0]))), p(x))[1])
    got = _serve(engine, *imgs)
    assert {i for i, _ in calls} == {0, 1} and all(n == 1 for _, n in calls)
    one = _serve(serve.SREngine(model_path, 2, device="cpu"), *imgs)
    for g, o, w in zip(got, one, want):
        np.testing.assert_array_equal(g, o)  # the split changes no number
        np.testing.assert_allclose(g, w, **TOL)
