"""The trunk under autograd on the CPU: ``TrunkFunction`` against autograd
straight through the plain trunk and against ``jax.grad`` through the flax
ResBlock stack; the model reading its live parameters; the model's dispatch
by width; the output conv's gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from simplesr_tpu.models.srresnet import ResBlock as FlaxResBlock
from simplesr_tpu_torch.models import build_generator_model
from simplesr_tpu_torch.models.srresnet import output_conv
from simplesr_tpu_torch.ops.kernels import (TrunkFunction, pack_trunk_weights, residual_trunk,
                                            residual_trunk_reference)
from simplesr_tpu_torch.train import from_flax_variables, to_flax_variables

BLOCKS = 2


def _bf16_model(seed=0, width=64, batch_norm=False, dtype="bfloat16"):
    torch.manual_seed(seed)
    model = build_generator_model(4, num_blocks=BLOCKS, num_filters=width,
                                  batch_norm=batch_norm, dtype=dtype, device="cpu")
    with torch.no_grad():
        for block in model.blocks:
            block.act.alpha.uniform_(0.0, 0.3)
            block.conv1.conv.bias.uniform_(-0.1, 0.1)
    return model.train()


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    lr = torch.from_numpy(rng.uniform(0, 1, (2, 8, 10, 3)).astype(np.float32))
    hr = torch.from_numpy(rng.uniform(-1, 1, (2, 32, 40, 3)).astype(np.float32))
    return lr, hr


def _straight_through(model):
    """Make ``model`` run its trunk as autograd straight through the plain
    version."""
    model._trunk = lambda h: residual_trunk_reference(
        h.permute(0, 2, 3, 1), pack_trunk_weights(model._block_parameters())).permute(0, 3, 1, 2)


def _grads(model, lr, hr):
    loss = ((model(lr) - hr) ** 2).mean()
    return loss, torch.autograd.grad(loss, list(model.parameters()))


def test_every_parameter_gets_the_straight_through_gradient():
    """Fault 3: the trunk's parameters reach autograd. On the CPU the
    recomputing backward gives exactly the gradients of autograd straight
    through the plain trunk."""
    model = _bf16_model()
    assert model.uses_trunk_kernel
    lr, hr = _batch()
    loss, grads = _grads(model, lr, hr)
    _straight_through(model)
    loss_ref, grads_ref = _grads(model, lr, hr)
    assert torch.equal(loss, loss_ref)
    for (name, _), got, ref in zip(model.named_parameters(), grads, grads_ref):
        assert got is not None and got.abs().max() > 0, name
        assert torch.equal(got, ref), name


def test_backward_through_loss_sets_trunk_parameter_grads():
    model = _bf16_model()
    lr, hr = _batch()
    ((model(lr) - hr) ** 2).mean().backward()
    assert all(p.grad is not None for p in model.parameters())


def test_in_place_update_is_seen():
    """Fault 3: the trunk reads the parameters as they are at the call, so an
    in-place update changes the output to that of a fresh module loaded with
    the same state dict."""
    model = _bf16_model().eval()
    lr, _ = _batch()
    with torch.no_grad():
        before = model(lr)
        model.blocks[0].conv1.conv.weight.add_(0.5)
        after = model(lr)
    fresh = build_generator_model(4, num_blocks=BLOCKS, num_filters=64, batch_norm=False,
                                  dtype="bfloat16", device="cpu")
    fresh.load_state_dict(model.state_dict())
    with torch.no_grad():
        assert torch.equal(after, fresh(lr))
    assert not torch.equal(after, before)


def test_packed_weights_follow_the_parameters():
    """The model keeps its packed trunk weights while the parameters stay as
    they are, and packs them again after an in-place write or new data."""
    model = _bf16_model().eval()
    lr, _ = _batch()
    packed = model.trunk_weights()
    assert model.trunk_weights() is packed
    weight = model.blocks[1].conv2.conv.weight
    with torch.no_grad():
        weight.mul_(0.5)
    assert model.trunk_weights() is not packed
    packed = model.trunk_weights()
    weight.data = weight.data * 2.0
    assert model.trunk_weights() is not packed
    fresh = build_generator_model(4, num_blocks=BLOCKS, num_filters=64, batch_norm=False,
                                  dtype="bfloat16", device="cpu")
    fresh.load_state_dict(model.state_dict())
    with torch.no_grad():
        assert torch.equal(model(lr), fresh(lr))


def test_trunk_function_keeps_only_input_and_parameters():
    """The backward recomputes: the graph holds x and the 5 * num_blocks
    parameters, not the trunk's 2 * num_blocks activation maps."""
    model = _bf16_model()
    x = torch.randn((1, 6, 7, 64)).to(torch.bfloat16).requires_grad_()
    out = TrunkFunction.apply(x, None, *model.trunk_parameters())
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 1 + 5 * BLOCKS
    assert saved[0] is x
    assert all(a is b for a, b in zip(saved[1:], model.trunk_parameters()))


def test_residual_trunk_stays_forward_only():
    model = _bf16_model()
    weights = pack_trunk_weights(model._block_parameters())
    assert weights.weight.requires_grad  # packing is differentiable
    out = residual_trunk(torch.zeros((1, 4, 4, 64), dtype=torch.bfloat16), weights)
    assert out.grad_fn is None and not out.requires_grad


@pytest.mark.parametrize("width,batch_norm,dtype,kernel", [
    (64, False, "bfloat16", True),
    (32, False, "bfloat16", False),
    (128, False, "bfloat16", False),
    (64, True, "bfloat16", False),
    (64, False, "float32", False),
])
def test_only_bn_free_bf16_width_64_takes_the_trunk_function(width, batch_norm, dtype, kernel):
    """Fault 1: the trunk kernel, like the TPU kernel, takes C = 64; every
    other model runs its ResBlock modules, differentiably, on any device."""
    model = _bf16_model(width=width, batch_norm=batch_norm, dtype=dtype)
    assert model.uses_trunk_kernel == kernel
    lr, hr = _batch()
    _, grads = _grads(model, lr, hr)
    assert all(torch.isfinite(g).all() for g in grads)


def test_output_conv_gradients_equal_conv2d_autograd():
    rng = np.random.default_rng(2)
    conv = torch.nn.Conv2d(8, 3, 9, padding=4)
    h = torch.from_numpy(rng.normal(size=(2, 8, 12, 10)).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.normal(size=(2, 3, 12, 10)).astype(np.float32))
    got = torch.autograd.grad(output_conv(h, conv), [h, conv.weight, conv.bias], g)
    ref = torch.autograd.grad(F.conv2d(h, conv.weight, conv.bias, padding=4),
                              [h, conv.weight, conv.bias], g)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def _cosine_and_fro(got, ref):
    got, ref = np.asarray(got, np.float64).ravel(), np.asarray(ref, np.float64).ravel()
    cos = got @ ref / (np.linalg.norm(got) * np.linalg.norm(ref))
    return cos, np.linalg.norm(got - ref) / np.linalg.norm(ref)


def test_trunk_function_gradients_match_jax_grad():
    """TrunkFunction (CPU forward, recomputing backward) against ``jax.grad``
    of the same MSE through the flax ResBlock stack in bf16, with the same
    weights carried across by ``from_flax_variables``. The two round to bf16
    at different points (flax after the conv, again after the bias and the
    PReLU; the trunk after the f32 bias and PReLU), and the gradients of
    bf16 activations are bf16 on both sides, so the bound is on direction
    and relative size: per tensor cosine > 0.99 and relative Frobenius error
    < 3e-2 (measured: cosine >= 0.99985, Frobenius <= 1.81e-2)."""
    rng = np.random.default_rng(11)
    blocks = [FlaxResBlock(64, batch_norm=False, dtype=jnp.bfloat16) for _ in range(BLOCKS)]
    x = rng.normal(0, 1, (2, 10, 12, 64)).astype(np.float32)
    x = np.asarray(torch.from_numpy(x).to(torch.bfloat16).float())  # bf16 values
    target = rng.normal(0, 1, x.shape).astype(np.float32)
    params = []
    for blk, block in enumerate(blocks):
        p = block.init(jax.random.key(blk), jnp.asarray(x))["params"]
        params.append(jax.tree_util.tree_map_with_path(
            lambda path, leaf: jnp.asarray(rng.uniform(0.0, 0.3, leaf.shape), leaf.dtype)
            if path[-1].key in ("alpha", "bias") else leaf, p))

    def loss_fn(params, x):
        h = x
        for block, p in zip(blocks, params):
            h = block.apply({"params": p}, h)
        return jnp.mean((jnp.asarray(h, jnp.float32) - target) ** 2)

    jax_params, jax_x = jax.grad(loss_fn, argnums=(0, 1))(params, jnp.asarray(x))

    trunk = build_generator_model(2, num_blocks=BLOCKS, num_filters=64, batch_norm=False,
                                  dtype="bfloat16", device="cpu")
    variables = to_flax_variables(trunk.state_dict())
    variables["params"].update({f"ResBlock_{i}": jax.device_get(p) for i, p in enumerate(params)})
    state = from_flax_variables(trunk, variables)
    leaves = []
    for i in range(BLOCKS):
        for name in ("conv1.conv.weight", "conv1.conv.bias", "act.alpha", "conv2.conv.weight",
                     "conv2.conv.bias"):
            leaves.append(state[f"blocks.{i}.{name}"].clone().requires_grad_())
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    out = TrunkFunction.apply(xt, None, *leaves)
    loss = ((out.float() - torch.from_numpy(target)) ** 2).mean()
    got = torch.autograd.grad(loss, [xt, *leaves])

    refs = [np.asarray(jax_x, np.float32)]
    for p in jax_params:
        for layer, leaf in (("ConvLayer_0", "kernel"), ("ConvLayer_0", "bias"),
                            ("PReLU_0", "alpha"), ("ConvLayer_1", "kernel"),
                            ("ConvLayer_1", "bias")):
            v = np.asarray(p[layer]["alpha"] if layer == "PReLU_0" else p[layer]["Conv_0"][leaf])
            refs.append(v.transpose(3, 2, 0, 1) if leaf == "kernel" else v)  # HWIO -> OIHW
    worst_cos, worst_fro = 1.0, 0.0
    for g, ref in zip(got, refs):
        cos, fro = _cosine_and_fro(g.float().numpy(), ref)
        worst_cos, worst_fro = min(worst_cos, cos), max(worst_fro, fro)
    assert worst_cos > 0.99 and worst_fro < 3e-2, (worst_cos, worst_fro)
