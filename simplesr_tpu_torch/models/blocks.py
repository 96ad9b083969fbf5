"""Shared building blocks, as simplesr_tpu.models.blocks, in NCHW.

Numerics follow flax's ``nn.Conv(dtype=...)``: input, kernel and bias are
cast to the compute dtype, and the bias is added after the convolution in
that dtype. BatchNorm (eps 1e-3, Keras momentum 0.8) runs in float32 and
returns float32, as flax's ``nn.BatchNorm``: in training mode it normalises
by the batch's mean and biased variance (E[x^2] - E[x]^2, clipped at 0) and
moves the running statistics by them; in eval mode it uses the running
statistics. PReLU casts its per-channel slope to the input's dtype.

A strided convolution pads as XLA's ``SAME`` does: the total padding
``max((out - 1) * stride + k - in, 0)`` split with the smaller half first, so
a stride-2 3x3 conv on an even side pads (0, 1), where torch's
``padding=1`` would pad (1, 1).
"""

import contextlib
import math
import threading

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from simplesr_tpu_torch.core.dtypes import cudnn_tf32
from simplesr_tpu_torch.ops.shuffle import depth_to_space_nchw
from simplesr_tpu_torch.parallel.comm import batch_moments


_RECOMPUTE = threading.local()  # per thread: autograd may recompute on its own threads


@contextlib.contextmanager
def recomputing():
    """Within: BatchNorm in training mode leaves its running statistics
    alone (a checkpointed block's recomputation in the backward)."""
    saved = getattr(_RECOMPUTE, "active", False)
    _RECOMPUTE.active = True
    try:
        yield
    finally:
        _RECOMPUTE.active = saved


def checkpointed(block, x):
    """``block(x)`` whose activations are recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant) under ``recomputing()``."""
    return checkpoint(block, x, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), recomputing()))


def same_padding(size, kernel_size, stride):
    """XLA's SAME padding of one spatial side: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel_size - size, 0)
    return total // 2, total - total // 2


def conv2d(x, weight, bias, dtype, stride=1):
    """SAME convolution in ``dtype``, flax numerics (the bias added after
    the convolution, in ``dtype``)."""
    x, k = x.to(dtype), weight.shape[-1]
    if stride == 1 and k % 2:
        y = F.conv2d(x, weight.to(dtype), padding=k // 2)
    else:
        (top, bottom), (left, right) = (same_padding(n, k, stride) for n in x.shape[-2:])
        y = F.conv2d(F.pad(x, (left, right, top, bottom)), weight.to(dtype), stride=stride)
    return y + bias.to(dtype).view(1, -1, 1, 1)


def glorot_conv(in_features, features, kernel_size):
    conv = nn.Conv2d(in_features, features, kernel_size, padding=kernel_size // 2)
    nn.init.xavier_uniform_(conv.weight)  # Keras / flax glorot_uniform
    nn.init.zeros_(conv.bias)
    return conv


def scaled_he_normal_(weight, scale=0.2):
    """flax's ``variance_scaling(scale, "fan_in", "truncated_normal")``, the
    RRDB and discriminator kernels' initialiser: a normal truncated at two
    standard deviations, rescaled to variance ``scale / fan_in``."""
    fan_in = weight[0].numel()  # (out, in, kh, kw) or (out, in)
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std)


def he_conv(in_features, features, kernel_size=3, scale=0.2):
    """A conv with ``scaled_he_normal_`` kernels and zero biases."""
    conv = nn.Conv2d(in_features, features, kernel_size, padding=kernel_size // 2)
    scaled_he_normal_(conv.weight, scale)
    nn.init.zeros_(conv.bias)
    return conv


class _PinnedConv(torch.autograd.Function):
    """A float32 SAME convolution whose forward and backward both run with
    cuDNN's TF32 flag at ``tf32``: autograd runs a backward after the
    forward's flag has been restored."""

    @staticmethod
    def forward(ctx, h, weight, bias, tf32):
        ctx.save_for_backward(h, weight)
        ctx.tf32 = tf32
        with cudnn_tf32(h.device, tf32):
            return F.conv2d(h, weight, bias, padding=weight.shape[-1] // 2)

    @staticmethod
    def backward(ctx, grad):
        h, weight = ctx.saved_tensors
        pad = weight.shape[-1] // 2
        with cudnn_tf32(h.device, ctx.tf32):
            grads = torch.ops.aten.convolution_backward(
                grad, h, weight, [weight.shape[0]], [1, 1], [pad, pad], [1, 1], False,
                [0, 0], 1, list(ctx.needs_input_grad[:3]))
        return (*grads, None)


def pinned_conv2d(h, weight, bias, tf32):
    """A stride-1 SAME float32 conv (odd kernel) whose forward and backward
    run with TF32 at ``tf32`` on a CUDA device, whatever torch's global flag
    says."""
    return _PinnedConv.apply(h.float(), weight.float(), bias.float(), tf32)


class PReLU(nn.Module):
    """Per-channel PReLU, one slope per channel, initialised to zero."""

    def __init__(self, channels):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        alpha = self.alpha.to(x.dtype).view(1, -1, 1, 1)
        return torch.where(x >= 0, x, alpha * x)


class ConvLayer(nn.Module):
    """Conv2D, then BatchNorm when ``batch_norm``."""

    def __init__(self, in_features, features, kernel_size=3, batch_norm=False,
                 momentum=0.8, dtype=torch.float32, stride=1, he_scale=None):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        # glorot-uniform kernels, or scaled he-normal ones at ``he_scale``
        self.conv = glorot_conv(in_features, features, kernel_size) if he_scale is None \
            else he_conv(in_features, features, kernel_size, he_scale)
        # Keras momentum m keeps m of the running average; torch's keeps 1 - m.
        self.bn = nn.BatchNorm2d(features, eps=1e-3, momentum=1.0 - momentum) \
            if batch_norm else None

    def forward(self, x):
        y = conv2d(x, self.conv.weight, self.conv.bias, self.dtype, self.stride)
        if self.bn is not None:
            y = batch_norm(self.bn, y.float())
        return y


def batch_norm(bn, y):
    """flax's BatchNorm of NCHW float32 ``y`` with ``bn``'s parameters and
    running statistics, which training mode updates in place. Under data
    parallelism the batch statistics are the global batch's
    (``parallel.comm.batch_moments``)."""
    if bn.training:
        mean, var = batch_moments(y, (0, 2, 3))
        if not getattr(_RECOMPUTE, "active", False):
            keep = 1.0 - bn.momentum  # Keras / flax momentum
            with torch.no_grad():
                bn.running_mean.copy_(keep * bn.running_mean + (1.0 - keep) * mean)
                bn.running_var.copy_(keep * bn.running_var + (1.0 - keep) * var)
    else:
        mean, var = bn.running_mean, bn.running_var
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (y - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) + bn.bias.view(1, -1, 1, 1)


class SubpixelConvBlock(nn.Module):
    """Conv to C*r*r channels, depth_to_space(r) in DCR order, then PReLU
    when ``activation``."""

    def __init__(self, channels, upsample_factor=2, activation=True,
                 dtype=torch.float32, he_scale=None):
        super().__init__()
        self.dtype = dtype
        self.upsample_factor = upsample_factor
        out = channels * upsample_factor ** 2
        self.conv = glorot_conv(channels, out, 3) if he_scale is None \
            else he_conv(channels, out, 3, he_scale)
        self.act = PReLU(channels) if activation else None

    def forward(self, x):
        x = conv2d(x, self.conv.weight, self.conv.bias, self.dtype)
        x = depth_to_space_nchw(x, self.upsample_factor)
        if self.act is not None:
            x = self.act(x)
        return x
