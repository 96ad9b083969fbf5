"""RRDB (ESRGAN) generator, as simplesr_tpu.models.rrdb, in NCHW.

conv3 [head skip] -> N RRDB blocks -> global x0.2-scaled skip add -> conv3 ->
head skip add -> log2(scale) x (subpixel -> LeakyReLU 0.2) -> conv3 +
LeakyReLU -> float32 conv3 to 3 channels -> tanh. An RRDB block chains
``num_dense_blocks`` dense blocks, each added back after scaling by
``residual_scaling``; a dense block is ``num_convs`` convs of
``growth_channels`` outputs (``num_filters // 2`` when None), each on the
concatenation of its input and all earlier outputs, with LeakyReLU 0.2,
closed by a conv back to ``num_filters``. No BatchNorm; kernels are
scaled he-normal (0.2), biases zero.

Module names are flax's (``Conv_0``, ``RRDBBlock_3.DenseBlock_1.Conv_2``, ...),
so ``train/convert.py`` carries a model file's variables over by name. The
convolutions run in the model's dtype (bf16 for the committed models) with
flax's numerics; the output conv runs in float32 at the model's precision on
CUDA, as SRResNet's does. Input LR NHWC in [0, 1]; output NHWC float32 in
[-1, 1].

``remat=True`` recomputes each RRDB block in the backward
(``blocks.checkpointed``) instead of storing its dense concatenations.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from simplesr_tpu_torch.core.dtypes import OUTPUT_CONV_TF32
from simplesr_tpu_torch.models.blocks import (SubpixelConvBlock, checkpointed, conv2d, he_conv,
                                              pinned_conv2d)

_ALLOWED_SCALES = (2, 4, 8)


def _conv(module, x, dtype):
    return conv2d(x, module.weight, module.bias, dtype)


class DenseBlock(nn.Module):
    def __init__(self, num_convs=4, num_filters=64, kernel_size=3, dtype=torch.bfloat16,
                 growth_channels=None):
        super().__init__()
        self.dtype = dtype
        self.num_convs = num_convs
        growth = growth_channels or num_filters // 2
        for i in range(num_convs):
            self.add_module(f"Conv_{i}", he_conv(num_filters + i * growth, growth, kernel_size))
        self.add_module(f"Conv_{num_convs}",
                        he_conv(num_filters + num_convs * growth, num_filters, 3))

    def forward(self, x):
        for i in range(self.num_convs):
            y = F.leaky_relu(_conv(getattr(self, f"Conv_{i}"), x, self.dtype), 0.2)
            x = torch.cat([x, y], dim=1)
        return _conv(getattr(self, f"Conv_{self.num_convs}"), x, self.dtype)


class RRDBBlock(nn.Module):
    def __init__(self, num_dense_blocks=3, num_convs=4, num_filters=64, kernel_size=3,
                 residual_scaling=0.2, dtype=torch.bfloat16, growth_channels=None):
        super().__init__()
        self.residual_scaling = residual_scaling
        self.num_dense_blocks = num_dense_blocks
        for i in range(num_dense_blocks):
            self.add_module(f"DenseBlock_{i}", DenseBlock(num_convs, num_filters, kernel_size,
                                                          dtype, growth_channels))

    def forward(self, x):
        for i in range(self.num_dense_blocks):
            x = x + self.residual_scaling * getattr(self, f"DenseBlock_{i}")(x)
        return x


class RRDBNet(nn.Module):
    """ESRGAN x{2,4,8} generator. ``forward`` takes (B, H, W, 3) in [0, 1]
    and returns (B, sH, sW, 3) float32 in [-1, 1]."""

    uses_trunk_kernel = False  # the trunk kernel is SRResNet's

    def __init__(self, upsample_factor=4, num_filters=64, num_rrdb_blocks=16,
                 num_dense_blocks=3, num_convs=4, kernel_size=3, residual_scaling=0.2,
                 dtype=torch.bfloat16, growth_channels=None, remat=False):
        super().__init__()
        if upsample_factor not in _ALLOWED_SCALES:
            raise ValueError(
                "upsample factor not supported - please choose either 2, 4 or 8")
        self.upsample_factor = upsample_factor
        self.num_filters = num_filters
        self.num_rrdb_blocks = num_rrdb_blocks
        self.num_dense_blocks = num_dense_blocks
        self.num_convs = num_convs
        self.kernel_size = kernel_size
        self.residual_scaling = residual_scaling
        self.dtype = dtype
        self.growth_channels = growth_channels
        self.remat = remat
        self.Conv_0 = he_conv(3, num_filters, 3)
        for i in range(num_rrdb_blocks):
            self.add_module(f"RRDBBlock_{i}", RRDBBlock(
                num_dense_blocks, num_convs, num_filters, kernel_size, residual_scaling, dtype,
                growth_channels))
        self.Conv_1 = he_conv(num_filters, num_filters, kernel_size)
        self.num_upsample = upsample_factor.bit_length() - 1
        for i in range(self.num_upsample):
            self.add_module(f"SubpixelConvBlock_{i}", SubpixelConvBlock(
                num_filters, 2, activation=False, dtype=dtype, he_scale=0.2))
        self.Conv_2 = he_conv(num_filters, num_filters, kernel_size)
        self.Conv_3 = he_conv(num_filters, 3, 3)

    def features(self, x):
        """Head, RRDB trunk and the two skips of (B, H, W, 3) ``x`` in
        [0, 1], NCHW in the model's dtype."""
        h = skip = _conv(self.Conv_0, x.permute(0, 3, 1, 2), self.dtype)
        trunk = h
        for i in range(self.num_rrdb_blocks):
            block = getattr(self, f"RRDBBlock_{i}")
            if self.remat and torch.is_grad_enabled():
                trunk = checkpointed(block, trunk)
            else:
                trunk = block(trunk)
        trunk = skip + self.residual_scaling * trunk
        return skip + _conv(self.Conv_1, trunk, self.dtype)

    def tail(self, h):
        """Subpixel blocks, HR conv, output conv and tanh of NCHW features;
        (B, sH, sW, 3) float32."""
        for i in range(self.num_upsample):
            h = F.leaky_relu(getattr(self, f"SubpixelConvBlock_{i}")(h), 0.2)
        h = F.leaky_relu(_conv(self.Conv_2, h, self.dtype), 0.2)
        out = pinned_conv2d(h, self.Conv_3.weight, self.Conv_3.bias, OUTPUT_CONV_TF32)
        return torch.tanh(out).permute(0, 2, 3, 1).contiguous()

    def forward(self, x):
        return self.tail(self.features(x))
