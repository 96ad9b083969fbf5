"""The port's SRResNet forward against flax ``apply`` of simplesr_tpu, with
the same weights carried over by ``from_flax_variables`` and the same
numpy inputs. The JAX side runs eagerly on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplesr_tpu.models import SRResNet as FlaxSRResNet
from simplesr_tpu.ops.shuffle import depth_to_space as jax_d2s
from simplesr_tpu.ops.shuffle import space_to_depth as jax_s2d
from simplesr_tpu.train.serialization import load_model as jax_load_model
from simplesr_tpu_torch.models import build_generator_model
from simplesr_tpu_torch.ops.shuffle import depth_to_space, space_to_depth
from simplesr_tpu_torch.train import from_flax_variables, load_model, load_payload

FLAGSHIP = "results/quality_fastrecipe/models/resnet_gen_srresnet_x4_best.msgpack"
BN_MODEL = "models/resnet_gen_1.msgpack"
WIDE_MODEL = "results/quality_r5/models/resnet_gen_srresnet128_x4_best.msgpack"


def _randomised(variables, rng):
    """Random PReLU slopes, biases and BatchNorm statistics, so that none of
    them is an identity."""
    def visit(path, leaf):
        name = path[-1].key
        if name in ("alpha", "bias"):
            return jnp.asarray(rng.uniform(-0.3, 0.3, leaf.shape), leaf.dtype)
        if name == "mean":
            return jnp.asarray(rng.normal(0, 0.2, leaf.shape), leaf.dtype)
        if name in ("var", "scale"):
            return jnp.asarray(rng.uniform(0.5, 1.5, leaf.shape), leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(visit, variables)


def _port(variables, device="cpu", **config):
    module = build_generator_model(**config, device=device)
    module.load_state_dict(from_flax_variables(module, jax.device_get(variables)))
    return module


def _run(module, x):
    with torch.inference_mode():
        return module(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("scale", [2, 4, 8])
@pytest.mark.parametrize("batch_norm", [False, True])
def test_float32_forward_matches_flax(scale, batch_norm):
    rng = np.random.default_rng(scale + 10 * batch_norm)
    x = rng.uniform(0, 1, (2, 10, 12, 3)).astype(np.float32)
    flax_model = FlaxSRResNet(upsample_factor=scale, num_filters=16, num_res_blocks=2,
                              batch_norm=batch_norm, dtype=jnp.float32)
    variables = _randomised(flax_model.init(jax.random.key(0), jnp.asarray(x)), rng)
    ref = np.asarray(flax_model.apply(variables, jnp.asarray(x), train=False))
    got = _run(_port(variables, upsample_factor=scale, num_blocks=2, num_filters=16,
                     batch_norm=batch_norm, dtype="float32"), x)
    assert got.shape == ref.shape == (2, 10 * scale, 12 * scale, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)  # f32 sums in another order


def test_flagship_weights_in_float32_match_flax():
    """Full width and depth, no bf16 rounding: the weights' layout is exact."""
    config, variables = load_payload(FLAGSHIP)
    _, jax_variables = jax_load_model(FLAGSHIP)
    config = {**config, "dtype": "float32"}
    x = np.random.default_rng(3).uniform(0, 1, (1, 12, 16, 3)).astype(np.float32)
    flax_model = FlaxSRResNet(upsample_factor=4, num_filters=64, num_res_blocks=16,
                              batch_norm=False, dtype=jnp.float32)
    ref = np.asarray(flax_model.apply(jax_variables, jnp.asarray(x), train=False))
    module = build_generator_model(**config, device="cpu")
    module.load_state_dict(from_flax_variables(module, variables))
    np.testing.assert_allclose(_run(module, x), ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("path,max_abs,mean_abs", [
    # bf16 through 16 blocks: a rounding that flips in one block spreads
    # through the rest (measured 0.035 / 0.0036 on these inputs), and the
    # port's BN-free trunk rounds where the trunk kernel does, after the f32
    # bias and PReLU, where flax rounds before them.
    (FLAGSHIP, 0.1, 0.01),
    # the 128-wide committed model runs its ResBlocks with flax's rounding
    # points; 16 blocks at twice the width, held to the flagship's bound
    # (measured 0.062 / 0.0048)
    (WIDE_MODEL, 0.1, 0.01),
    # bf16 with BatchNorm, 4 blocks, flax's rounding points (measured 8e-4 / 1.3e-4)
    (BN_MODEL, 5e-3, 5e-4),
])
def test_committed_bf16_models_match_flax(path, max_abs, mean_abs):
    module, variables = jax_load_model(path)
    port = load_model(path, device="cpu")
    for seed in range(2):
        x = np.random.default_rng(seed).uniform(0, 1, (1, 12, 16, 3)).astype(np.float32)
        ref = np.asarray(module.apply(variables, jnp.asarray(x), train=False))
        diff = np.abs(_run(port, x) - ref)
        assert diff.max() < max_abs and diff.mean() < mean_abs, (diff.max(), diff.mean())


@pytest.mark.parametrize("r,c", [(2, 3), (2, 16), (3, 2)])
def test_pixel_shuffle_is_tf_dcr(r, c):
    x = np.random.default_rng(r).normal(size=(2, 3, 5, c * r * r)).astype(np.float32)
    got = depth_to_space(torch.from_numpy(x), r).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_d2s(jnp.asarray(x), r)))
    back = space_to_depth(torch.from_numpy(got), r).numpy()
    np.testing.assert_array_equal(back, np.asarray(jax_s2d(jnp.asarray(got), r)))
    np.testing.assert_array_equal(back, x)


def test_unported_configs_raise():
    """RRDB builds (ported since; tests/test_torch_rrdb.py holds it against
    flax); unknown scales and architectures raise."""
    from simplesr_tpu_torch.models import RRDBNet

    rrdb = build_generator_model(4, architecture="rrdb", num_blocks=1, num_filters=8,
                                 device="cpu")
    assert isinstance(rrdb, RRDBNet) and not rrdb.training
    with pytest.raises(ValueError):
        build_generator_model(3, device="cpu")
    with pytest.raises(ValueError):
        build_generator_model(4, architecture="unet", device="cpu")


def test_trunk_weights_follow_a_loaded_state_dict():
    config, variables = load_payload(BN_MODEL)
    state = from_flax_variables(build_generator_model(**config, device="cpu"), variables)
    config = {**config, "batch_norm": False, "num_blocks": 2}
    state = {k: v for k, v in state.items()
             if "bn." not in k and not k.startswith(("blocks.2", "blocks.3"))}
    module = build_generator_model(**config, device="cpu")
    module.load_state_dict(state)
    weights = module.trunk_weights()
    np.testing.assert_array_equal(
        weights.weight[1, 1].float().reshape(3, 3, 64, 64).numpy(),
        state["blocks.1.conv2.conv.weight"].to(torch.bfloat16).float().permute(2, 3, 1, 0)
        .numpy())
    np.testing.assert_array_equal(weights.alpha[0].numpy(), state["blocks.0.act.alpha"].numpy())
