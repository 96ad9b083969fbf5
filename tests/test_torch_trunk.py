"""The plain version of the port's trunk kernel against simplesr_tpu's Pallas
trunk kernel in interpret mode, and against the flax ResBlock stack."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplesr_tpu.models import SRResNet as FlaxSRResNet
from simplesr_tpu.models.srresnet import ResBlock as FlaxResBlock
from simplesr_tpu.ops.pallas.trunk_kernel import srresnet_trunk_pallas
from simplesr_tpu_torch.models import build_generator_model
from simplesr_tpu_torch.ops.kernels import (pack_trunk_weights, residual_trunk,
                                            residual_trunk_reference)
from simplesr_tpu_torch.train import from_flax_variables

BLOCKS = 2


@pytest.fixture(scope="module")
def trunk_case():
    rng = np.random.default_rng(7)
    model = FlaxSRResNet(upsample_factor=2, num_res_blocks=BLOCKS, num_filters=64,
                         batch_norm=False, dtype=jnp.float32)
    params = model.init(jax.random.key(0), jnp.zeros((1, 16, 16, 3)))["params"]
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.asarray(rng.uniform(-0.3, 0.3, leaf.shape), leaf.dtype)
        if path[-1].key in ("alpha", "bias") else leaf, params)
    port = build_generator_model(2, num_blocks=BLOCKS, num_filters=64, batch_norm=False,
                                 dtype="bfloat16", device="cpu")
    port.load_state_dict(from_flax_variables(port, {"params": jax.device_get(params)}))
    x = rng.normal(0, 1, (2, 16, 16, 64)).astype(np.float32)
    return params, port, x


def _port_trunk(port, x):
    weights = pack_trunk_weights(
        (b.conv1.conv.weight, b.conv1.conv.bias, b.act.alpha, b.conv2.conv.weight,
         b.conv2.conv.bias) for b in port.blocks)
    out = residual_trunk(torch.from_numpy(x).to(torch.bfloat16), weights)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    return out.float().numpy()


def test_plain_trunk_matches_pallas_interpret(trunk_case):
    params, port, x = trunk_case
    ref = np.asarray(srresnet_trunk_pallas(jnp.asarray(x), params, num_blocks=BLOCKS,
                                           band=8, interpret=True))
    got = _port_trunk(port, x)
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    assert rel < 1e-2  # same rounding points; f32 sums in another order


def test_plain_trunk_matches_flax_resblocks(trunk_case):
    params, port, x = trunk_case
    t = jnp.asarray(x)
    for blk in range(BLOCKS):
        t = FlaxResBlock(64, batch_norm=False, dtype=jnp.float32).apply(
            {"params": params[f"ResBlock_{blk}"]}, t, False)
    ref = np.asarray(t)
    rel = np.abs(_port_trunk(port, x) - ref).max() / np.abs(ref).max()
    assert rel < 1e-2  # bf16 storage between the convs vs an f32 reference


def test_model_trunk_is_the_packed_trunk(trunk_case):
    """The BN-free bf16 model routes its trunk through residual_trunk with
    the weights packed on load."""
    _, port, x = trunk_case
    h = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)
    via_model = port._trunk(h).permute(0, 2, 3, 1)
    ref = residual_trunk_reference(torch.from_numpy(x).to(torch.bfloat16),
                                   pack_trunk_weights(
                                       (b.conv1.conv.weight, b.conv1.conv.bias, b.act.alpha,
                                        b.conv2.conv.weight, b.conv2.conv.bias)
                                       for b in port.blocks))
    assert torch.equal(via_model, ref)


def test_cpu_tensors_count_no_launch(trunk_case):
    _, port, x = trunk_case
    before = residual_trunk.launches
    _port_trunk(port, x)
    assert residual_trunk.launches == before


def test_other_devices_are_refused(trunk_case):
    _, port, _ = trunk_case
    weights = pack_trunk_weights(
        (b.conv1.conv.weight, b.conv1.conv.bias, b.act.alpha, b.conv2.conv.weight,
         b.conv2.conv.bias) for b in port.blocks)
    with pytest.raises(ValueError):
        residual_trunk(torch.zeros((1, 4, 4, 64), device="meta", dtype=torch.bfloat16),
                       weights)
