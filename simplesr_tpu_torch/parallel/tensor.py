"""Tensor parallelism, as simplesr_tpu.parallel.tensor: one generator
forward split channel-wise across the ranks of a "model" mesh axis.

SRResNet (BN-free) is Megatron's pattern on a conv trunk: in every residual
block the first conv is column-parallel (each rank computes C/n output
channels, and its slice of the PReLU slopes), the second row-parallel (each
rank's partial sum over its C/n input channels, kept in float32 across the
one all-reduce of the block, then rounded to the model's dtype and given
the bias once). RRDB is all column-parallel: every dense, fusion and
post-trunk conv computes its slice of the output channels whole, and an
all-gather re-replicates it for the next concatenation. The head and the
subpixel tail run replicated.

The parameters are the model's own, whole on every rank: each rank slices
what it computes at every call, so that model files, checkpoints and the
optimizer are those of single-device training. The collectives are
differentiable (``parallel.comm``), so the forward trains: the sharded
parameters' gradients are each rank's slice, to be summed over the axis,
the replicated ones' are the same on every rank.

The split convs have per-rank widths (64 -> 32 at n = 2) that the C = 64
trunk kernel does not take: they run as PyTorch convolutions, as the JAX
package runs them as ``lax`` convolutions outside its Pallas kernel.
"""

import torch
import torch.nn.functional as F

from simplesr_tpu_torch.models.blocks import conv2d
from simplesr_tpu_torch.models.rrdb import RRDBNet
from simplesr_tpu_torch.models.srresnet import SRResNet
from simplesr_tpu_torch.parallel.comm import (all_gather_cat, copy_to_model, gather_from_model,
                                              reduce_from_model)
from simplesr_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size, mesh_shape

__all__ = ["MODEL_AXIS", "tp_param_specs", "tp_apply"]

MODEL_AXIS = "model"


def tp_param_specs(model, axis=MODEL_AXIS):
    """{parameter name: spec} for the TP forward, in the port's layouts: a
    spec names the mesh axis at the dim that is split (conv weights are
    OIHW: ``(axis,)`` splits the output channels, ``(None, axis)`` the
    input channels), ``()`` is replicated. SRResNet: each block's conv1 and
    PReLU split on the output channels, conv2 on the input channels. RRDB:
    every dense, fusion and post-trunk conv on the output channels."""
    specs = {name: () for name, _ in model.named_parameters()}
    if isinstance(model, RRDBNet):
        for name in specs:
            if name.startswith(("RRDBBlock_", "Conv_1.")):
                specs[name] = (axis,)
        return specs
    for i in range(model.num_res_blocks):
        p = f"blocks.{i}."
        specs[p + "conv1.conv.weight"] = (axis,)
        specs[p + "conv1.conv.bias"] = (axis,)
        specs[p + "act.alpha"] = (axis,)
        specs[p + "conv2.conv.weight"] = (None, axis)
    return specs


def _check(model, n, axis):
    if isinstance(model, RRDBNet):
        growth = model.growth_channels or model.num_filters // 2
        if model.num_filters % n != 0:
            raise ValueError(f"num_filters {model.num_filters} not divisible by "
                             f"mesh axis {axis}={n}")
        if growth % n != 0:
            raise ValueError(f"RRDB growth width {growth} not divisible by "
                             f"mesh axis {axis}={n}")
        return
    if not isinstance(model, SRResNet):
        raise TypeError(f"tensor-parallel forward supports SRResNet and RRDBNet, "
                        f"got {type(model).__name__}")
    if model.batch_norm:
        raise ValueError("tensor-parallel forward supports batch_norm=False "
                         "models (BatchNorm stats don't shard channel-wise)")
    if model.num_filters % n != 0:
        raise ValueError(f"num_filters {model.num_filters} not divisible by "
                         f"mesh axis {axis}={n}")


def _out_slice(t, n, r):
    c = t.shape[0] // n
    return t[r * c:(r + 1) * c]


def _srresnet_local(model, x, group, n, r):
    dtype = model.dtype
    h = x.permute(0, 3, 1, 2).to(dtype)
    h = skip = model.head_act(model.head(h))
    for block in model.blocks:
        c1, c2 = block.conv1.conv, block.conv2.conv
        # column-parallel: this rank's output channels and PReLU slopes
        y = conv2d(copy_to_model(h, group), _out_slice(c1.weight, n, r),
                   _out_slice(c1.bias, n, r), dtype)
        alpha = _out_slice(block.act.alpha, n, r).to(y.dtype).view(1, -1, 1, 1)
        y = torch.where(y >= 0, y, alpha * y)
        # row-parallel: the partial sum over this rank's input channels, in
        # float32 across the all-reduce, the bias added once after it
        c = c2.weight.shape[1] // n
        w2 = c2.weight[:, r * c:(r + 1) * c].to(dtype).float()
        y = F.conv2d(y.float(), w2, padding=c2.weight.shape[-1] // 2)
        y = reduce_from_model(y, group).to(dtype) + c2.bias.to(dtype).view(1, -1, 1, 1)
        h = h + y
    return model.tail(model.trunk_out(h) + skip)


def _rrdb_local(model, x, group, n, r):
    dtype = model.dtype

    def col_conv(h, conv):
        return conv2d(copy_to_model(h, group), _out_slice(conv.weight, n, r),
                      _out_slice(conv.bias, n, r), dtype)

    def dense(h, block):
        cat = h
        for j in range(block.num_convs):
            y = F.leaky_relu(col_conv(cat, getattr(block, f"Conv_{j}")), 0.2)
            cat = torch.cat([cat, gather_from_model(y, 1, group)], dim=1)
        return gather_from_model(col_conv(cat, getattr(block, f"Conv_{block.num_convs}")), 1,
                                 group)

    h = skip = conv2d(x.permute(0, 3, 1, 2), model.Conv_0.weight, model.Conv_0.bias, dtype)
    trunk = h
    rs = model.residual_scaling
    for i in range(model.num_rrdb_blocks):
        rrdb = getattr(model, f"RRDBBlock_{i}")
        for d in range(rrdb.num_dense_blocks):
            trunk = trunk + rs * dense(trunk, getattr(rrdb, f"DenseBlock_{d}"))
    trunk = skip + rs * trunk
    return model.tail(skip + gather_from_model(col_conv(trunk, model.Conv_1), 1, group))


def tp_apply(model, mesh, axis=MODEL_AXIS, batch_axis=None):
    """The tensor-parallel forward of ``model`` (a BN-free SRResNet, or an
    RRDBNet) over ``mesh[axis]``: ``f(x)`` with (B, H, W, 3) ``x`` the same
    on every rank of the axis, reading the model's parameters as they are at
    the call, differentiable. With ``batch_axis`` in the mesh, ``x`` is the
    global batch: each rank takes its slice along that axis and the outputs
    are gathered (forward only). Returns the (B, sH, sW, 3) float32 SR
    batch on every rank."""
    n = axis_size(mesh, axis)
    _check(model, n, axis)
    group = axis_group(mesh, axis)
    local = _rrdb_local if isinstance(model, RRDBNet) else _srresnet_local
    b_ax = batch_axis if batch_axis and batch_axis in mesh_shape(mesh) else None

    def f(x):
        r = axis_index(mesh, axis)
        if b_ax is None:
            return local(model, x, group, n, r)
        nb, bi = axis_size(mesh, b_ax), axis_index(mesh, b_ax)
        if x.shape[0] % nb:
            raise ValueError(f"batch {x.shape[0]} not divisible by mesh axis {b_ax}={nb}")
        per = x.shape[0] // nb
        out = local(model, x[bi * per:(bi + 1) * per], group, n, r)
        return all_gather_cat(out.contiguous(), 0, axis_group(mesh, b_ax))

    return f

