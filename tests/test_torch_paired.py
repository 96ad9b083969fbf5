"""The port's paired serving form against simplesr_tpu's: packing and the
block-diagonal kernels bit for bit, SRResNetPaired, SRResNetPairedPolyphase
and RRDBNetPaired against flax ``apply`` and against the unpaired port on the
same float32 variables (the JAX side eager on the CPU), the predictor's
padding, and the inference-only rule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplesr_tpu.eval.evaluation import _pad_to_multiple as jax_pad_to_multiple
from simplesr_tpu.models import RRDBNet as FlaxRRDBNet
from simplesr_tpu.models import SRResNet as FlaxSRResNet
from simplesr_tpu.models import paired as jax_paired
from simplesr_tpu.ops import pairing as jax_pairing
from simplesr_tpu_torch.eval.evaluation import _as_predictor, _pad_to_multiple
from simplesr_tpu_torch.models import build_generator_model, paired, polyphase
from simplesr_tpu_torch.ops import pairing
from test_torch_srresnet import _port, _randomised, _run

# the same float32 products summed in another order (measured under 1e-6)
F32_TOL = 1e-5


@pytest.mark.parametrize("ways", [2, 4])
def test_pack_and_unpack_are_bit_equal(ways):
    x = np.random.default_rng(ways).normal(size=(4 * ways // 2, 5, 6, 3)).astype(np.float32)
    packed = pairing.pack_batch(torch.from_numpy(x), ways)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jax_pairing.pack_batch(x, ways)))
    back = pairing.unpack_batch(packed, ways)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_pairing.unpack_batch(jnp.asarray(packed.numpy()), ways)))
    np.testing.assert_array_equal(back.numpy(), x)
    with pytest.raises(ValueError):
        pairing.pack_batch(torch.from_numpy(x[:3]), ways if ways != 3 else 2)
    with pytest.raises(ValueError):
        pairing.unpack_batch(torch.zeros((1, 2, 2, 5)), 2)


@pytest.mark.parametrize("ways", [2, 3])
def test_blockdiag_kernels_are_bit_equal(ways):
    rng = np.random.default_rng(ways)
    kernel = rng.normal(size=(3, 3, 4, 5)).astype(np.float32)
    np.testing.assert_array_equal(pairing.blockdiag_kernel(kernel, ways),
                                  jax_pairing.blockdiag_kernel(kernel, ways))
    dense = rng.normal(size=(3, 3, 4 + 2 * 3, 6)).astype(np.float32)
    segments = [4, 3, 3]
    np.testing.assert_array_equal(
        pairing.blockdiag_kernel_segmented(dense, ways, segments),
        jax_pairing.blockdiag_kernel_segmented(dense, ways, segments))
    with pytest.raises(ValueError):
        pairing.blockdiag_kernel_segmented(dense, ways, [4, 3])
    tree = {"a": {"kernel": kernel, "bias": kernel[0, 0, 0]}, "alpha": kernel[1, 1, 1]}
    got = pairing.pair_param_tree(tree, ways)
    ref = jax.device_get(jax_pairing.pair_param_tree(tree, ways))
    for path in (("a", "kernel"), ("a", "bias"), ("alpha",)):
        g, r = got, ref
        for key in path:
            g, r = g[key], r[key]
        np.testing.assert_array_equal(g, np.asarray(r))
    with pytest.raises(ValueError):
        pairing.pair_param_tree({"x": np.zeros((2, 2))}, ways)


@pytest.mark.parametrize("polyphase_tail", [False, True])
@pytest.mark.parametrize("batch_norm", [False, True])
def test_srresnet_paired_matches_flax_and_unpaired(polyphase_tail, batch_norm):
    rng = np.random.default_rng(2 * polyphase_tail + batch_norm)
    x = rng.uniform(0, 1, (4, 7, 6, 3)).astype(np.float32)
    flax_model = FlaxSRResNet(upsample_factor=4, num_filters=8, num_res_blocks=2,
                              batch_norm=batch_norm, dtype=jnp.float32)
    variables = _randomised(flax_model.init(jax.random.key(1), jnp.asarray(x)), rng)
    flax_paired, flax_vars = jax_paired.paired_model(flax_model, variables, ways=2,
                                                     polyphase=polyphase_tail)
    ref = np.asarray(flax_paired.apply(flax_vars, jnp.asarray(x), train=False))
    port = _port(variables, upsample_factor=4, num_blocks=2, num_filters=8,
                 batch_norm=batch_norm, dtype="float32")
    module, state = paired.paired_model(port, ways=2, polyphase=polyphase_tail)
    assert type(module).__name__ == type(flax_paired).__name__
    assert not module.uses_trunk_kernel and set(state) == set(module.state_dict())
    got = _run(module, x)
    assert got.shape == ref.shape == (4, 28, 24, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(got, _run(port, x), rtol=0, atol=F32_TOL)


def test_paired_model_of_a_polyphase_module():
    """An SRResNetPolyphase is paired as it is (JAX's paired_model)."""
    port = build_generator_model(2, num_blocks=1, num_filters=8, batch_norm=False,
                                 dtype="float32", device="cpu")
    poly, _ = polyphase.polyphase_model(port)
    module, _ = paired.paired_model(poly, ways=2)
    assert type(module) is paired.SRResNetPairedPolyphase
    x = np.random.default_rng(0).uniform(0, 1, (2, 5, 6, 3)).astype(np.float32)
    np.testing.assert_allclose(_run(module, x), _run(port, x), rtol=0, atol=F32_TOL)
    with pytest.raises(TypeError):
        paired.paired_model(module)


@pytest.mark.parametrize("growth", [None, 6])
def test_rrdb_paired_matches_flax_and_unpaired(growth):
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (4, 6, 5, 3)).astype(np.float32)
    flax_model = FlaxRRDBNet(upsample_factor=2, num_filters=8, num_rrdb_blocks=2,
                             num_dense_blocks=2, num_convs=2, dtype=jnp.float32,
                             growth_channels=growth)
    variables = _randomised(flax_model.init(jax.random.key(2), jnp.asarray(x)), rng)
    flax_paired, flax_vars = jax_paired.rrdb_paired_model(flax_model, variables, ways=2)
    ref = np.asarray(flax_paired.apply(flax_vars, jnp.asarray(x), train=False))
    port = _port(variables, upsample_factor=2, architecture="rrdb", num_blocks=2,
                 num_filters=8, num_dense_blocks=2, num_convs=2, dtype="float32",
                 growth_channels=growth)
    module, _ = paired.rrdb_paired_model(port, ways=2)
    assert type(module) is paired.RRDBNetPaired
    got = _run(module, x)
    np.testing.assert_allclose(got, ref, rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(got, _run(port, x), rtol=0, atol=F32_TOL)
    with pytest.raises(TypeError):
        paired.rrdb_paired_model(build_generator_model(2, num_blocks=1, num_filters=8,
                                                       device="cpu"))


def test_batch_not_divisible_raises_and_train_mode_raises():
    port = build_generator_model(2, num_blocks=1, num_filters=8, batch_norm=True,
                                 dtype="float32", device="cpu")
    module, _ = paired.paired_model(port, ways=2)
    x = torch.rand((3, 6, 6, 3))
    with torch.inference_mode(), pytest.raises(ValueError, match="divisible"):
        module(x)
    with pytest.raises(ValueError, match="inference-only"):
        module(x[:2])  # grad enabled
    module.train()
    with torch.inference_mode(), pytest.raises(ValueError, match="inference-only"):
        module(x[:2])


@pytest.mark.parametrize("batch", [1, 3, 5])
def test_pad_to_multiple_matches_the_unpadded_result(batch, tmp_path):
    port = build_generator_model(2, num_blocks=1, num_filters=8, batch_norm=False,
                                 dtype="float32", device="cpu")
    x = torch.rand((batch, 6, 7, 3), generator=torch.Generator().manual_seed(batch))
    calls = []

    def predictor(t):
        calls.append(t.shape[0])
        return t * 2.0

    padded = _pad_to_multiple(predictor, 2)(x)
    jax_padded = jax_pad_to_multiple(lambda t: t * 2.0, 2)(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(padded.numpy(), np.asarray(jax_padded))
    assert calls == [batch + batch % 2]
    got = _as_predictor((port, port.state_dict()), paired=2, device="cpu")(x)
    ref = _as_predictor((port, port.state_dict()), device="cpu")(x)
    assert got.shape == (batch, 12, 14, 3)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=F32_TOL)


def test_flagship_paired_trunk_at_bf16():
    """The bound chip_smoke.py phase 11 holds the card to: the flagship's
    paired trunk (128 wide, the ResBlock modules with flax's rounding
    points) against its unpaired serving form (the trunk's plain version,
    the kernel's rounding points), two bf16 models through 16 blocks, within
    tests/test_torch_srresnet.py's port-vs-flax bound."""
    flagship = "results/quality_fastrecipe/models/resnet_gen_srresnet_x4_best.msgpack"
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (2, 12, 16, 3))
                         .astype(np.float32))
    got = _as_predictor(flagship, paired=2, device="cpu")(x)
    ref = _as_predictor(flagship, device="cpu")(x)
    diff = (got - ref).abs()
    assert diff.max().item() < 0.1 and diff.mean().item() < 0.01, (diff.max(), diff.mean())
