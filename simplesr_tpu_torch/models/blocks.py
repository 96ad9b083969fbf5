"""Shared building blocks, as simplesr_tpu.models.blocks, in NCHW.

Numerics follow flax's ``nn.Conv(dtype=...)``: input, kernel and bias are
cast to the compute dtype, and the bias is added after the convolution in
that dtype. BatchNorm (eps 1e-3, Keras momentum 0.8) runs in float32 and
returns float32, as flax's ``nn.BatchNorm``: in training mode it normalises
by the batch's mean and biased variance (E[x^2] - E[x]^2, clipped at 0) and
moves the running statistics by them; in eval mode it uses the running
statistics. PReLU casts its per-channel slope to the input's dtype.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from simplesr_tpu_torch.ops.shuffle import depth_to_space_nchw


def conv2d(x, weight, bias, dtype):
    """Stride-1 SAME convolution (odd kernel) in ``dtype``, flax numerics."""
    y = F.conv2d(x.to(dtype), weight.to(dtype), padding=weight.shape[-1] // 2)
    return y + bias.to(dtype).view(1, -1, 1, 1)


def glorot_conv(in_features, features, kernel_size):
    conv = nn.Conv2d(in_features, features, kernel_size, padding=kernel_size // 2)
    nn.init.xavier_uniform_(conv.weight)  # Keras / flax glorot_uniform
    nn.init.zeros_(conv.bias)
    return conv


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
                 momentum=0.8, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = glorot_conv(in_features, features, kernel_size)
        # Keras momentum m keeps m of the running average; torch's keeps 1 - m.
        self.bn = nn.BatchNorm2d(features, eps=1e-3, momentum=1.0 - momentum) \
            if batch_norm else None

    def forward(self, x):
        y = conv2d(x, self.conv.weight, self.conv.bias, self.dtype)
        if self.bn is not None:
            y = batch_norm(self.bn, y.float())
        return y


def batch_norm(bn, y):
    """flax's BatchNorm of NCHW float32 ``y`` with ``bn``'s parameters and
    running statistics, which training mode updates in place."""
    if bn.training:
        mean = y.mean((0, 2, 3))
        var = ((y * y).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
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
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.upsample_factor = upsample_factor
        self.conv = glorot_conv(channels, channels * upsample_factor ** 2, 3)
        self.act = PReLU(channels) if activation else None

    def forward(self, x):
        x = conv2d(x, self.conv.weight, self.conv.bias, self.dtype)
        x = depth_to_space_nchw(x, self.upsample_factor)
        if self.act is not None:
            x = self.act(x)
        return x
