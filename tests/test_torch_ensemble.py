"""The port's x8 geometric self-ensemble against simplesr_tpu's: the
dihedral transforms bit for bit, the ensembled predictor of the same saved
model (float32, the serving form of both packages) on a batch and on the
overlap-tiled route, and its two predictor calls."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplesr_tpu.eval.evaluation import _as_predictor as jax_as_predictor
from simplesr_tpu.eval.evaluation import _upscale as jax_upscale
from simplesr_tpu.ops import ensemble as jax_ensemble
from simplesr_tpu.train.generator import Generator
from simplesr_tpu.train.serialization import save_model as jax_save_model
from simplesr_tpu_torch.eval.evaluation import _as_predictor, _upscale
from simplesr_tpu_torch.ops import ensemble

# the same float32 products summed in another order, averaged over 8
ENSEMBLE_TOL = 1e-5
# the tiled route: the same, through 64 tiles stitched (as
# tests/test_torch_slice.py holds the plain tiled route)
TILED_TOL = 1e-4


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    """A 1-block, 4-filter float32 SRResNet x2 saved by simplesr_tpu."""
    gen = Generator.srresnet(upsample_factor=2, num_blocks=1, num_filters=4,
                             batch_norm=False, dtype=jnp.float32, input_dims=(16, 16))
    path = str(tmp_path_factory.mktemp("models") / "tiny.msgpack")
    jax_save_model(gen.module_config(), gen.variables, path)
    return path


@pytest.mark.parametrize("k", range(8))
def test_dihedral_transforms_are_bit_equal_and_invert(k):
    x = np.random.default_rng(k).normal(size=(2, 5, 7, 3)).astype(np.float32)
    for arr in (x, x[0]):  # NHWC and HWC
        got = ensemble.dihedral_transform(torch.from_numpy(arr), k)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jax_ensemble.dihedral_transform(arr, k)))
        back = ensemble.dihedral_inverse(got, k)
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jax_ensemble.dihedral_inverse(jnp.asarray(got.numpy()), k)))
        np.testing.assert_array_equal(back.numpy(), arr)
    with pytest.raises(ValueError):
        ensemble.dihedral_transform(torch.from_numpy(x), 8)
    with pytest.raises(ValueError):
        ensemble.dihedral_inverse(torch.from_numpy(x), -1)


@pytest.mark.parametrize("transforms", [None, (0, 4)])
def test_self_ensemble_matches_jax(model_path, transforms):
    x = np.random.default_rng(1).uniform(0, 1, (2, 9, 12, 3)).astype(np.float32)
    port = _as_predictor(model_path, device="cpu")
    ref = jax_ensemble.self_ensemble(jax_as_predictor(model_path), jnp.asarray(x), transforms)
    got = ensemble.self_ensemble(port, torch.from_numpy(x), transforms)
    assert got.dtype == torch.float32 and got.shape == (2, 18, 24, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ENSEMBLE_TOL)
    if transforms is None:
        wrapped = _as_predictor(model_path, ensemble=True, device="cpu")(torch.from_numpy(x))
        np.testing.assert_array_equal(wrapped.numpy(), got.numpy())
        # the mean of the eight outputs computed one by one
        one_by_one = torch.stack([ensemble.dihedral_inverse(
            port(ensemble.dihedral_transform(torch.from_numpy(x), k)), k) for k in range(8)])
        np.testing.assert_allclose(got.numpy(), one_by_one.mean(0).numpy(), rtol=0,
                                   atol=ENSEMBLE_TOL)


def test_duplicates_raise_and_two_calls_per_ensemble():
    shapes = []

    def counting(x):
        shapes.append(tuple(x.shape))
        return x.repeat_interleave(2, 1).repeat_interleave(2, 2)

    x = torch.rand((3, 5, 7, 3))
    with pytest.raises(ValueError, match="duplicate"):
        ensemble.self_ensemble(counting, x, (0, 4, 0))
    out = ensemble.ensemble_predictor(counting)(x)
    assert shapes == [(12, 5, 7, 3), (12, 7, 5, 3)]  # the even and the odd group
    # an equivariant predictor: the mean of 8 equal values, summed in float32
    torch.testing.assert_close(out, counting(x), rtol=0, atol=1e-6)
    shapes.clear()
    ensemble.self_ensemble(counting, x, (0, 4))
    assert shapes == [(6, 5, 7, 3)]


def test_tiled_ensemble_matches_jax(model_path):
    """An LR image over 1000 x 1000 goes through the overlap-tiled route, the
    ensemble per tile, in both packages."""
    lr = np.random.default_rng(2).uniform(0, 1, (1001, 1003, 3)).astype(np.float32)
    got = _upscale(_as_predictor(model_path, ensemble=True, device="cpu"),
                   torch.from_numpy(lr)[None], 2)
    ref = jax_upscale(jax_as_predictor(model_path, ensemble=True), jnp.asarray(lr)[None], 2)
    assert got.shape == (1, 2002, 2006, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=TILED_TOL)
