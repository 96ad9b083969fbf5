"""SRResNet generator, as simplesr_tpu.models.srresnet, in its training
form (``models/polyphase.py`` holds the exact serving rewrite of its tail,
``models/paired.py`` the paired trunk).

9x9 conv (64 f) -> PReLU [skip] -> N residual blocks (conv3 [+BN] -> PReLU ->
conv3 [+BN] -> add) -> conv3 [+BN] -> global skip add -> log2(scale) subpixel
blocks -> 9x9 conv to 3 channels in float32 -> tanh. On a CUDA device that
conv runs at ``core.dtypes.OUTPUT_CONV_TF32``'s precision, forward and
backward, not at whatever cuDNN's global TF32 flag is.

Input LR NHWC in [0, 1]; output NHWC float32 in [-1, 1]. The head, trunk and
subpixel tail run in the model's dtype (bf16 for the committed models).

The residual trunk of a BN-free bf16 model with 64 filters is
``ops.kernels.TrunkFunction``: the CUDA kernel on the GPU, its plain version
on the CPU, fed the blocks' parameters as they are at each call (packed
again whenever one changed), and differentiable through them. Any other
model (BatchNorm, float32, another width) runs its ResBlock modules with
flax's numerics on every device, as the JAX package runs every model: the
kernel, like the TPU kernel, takes C = 64 bf16 BN-free blocks only.

``remat=True`` recomputes each ResBlock in the backward instead of storing
its activations (``blocks.checkpointed``), as the JAX model's ``nn.remat``
does, with BatchNorm or without; BatchNorm's running statistics still move
once a step. The kernel's trunk needs no flag: ``TrunkFunction`` stores only
the trunk's input and recomputes the blocks in its backward. Parameter names
are ``blocks.{i}...`` either way.
"""

import torch
import torch.nn as nn

from simplesr_tpu_torch.core.dtypes import OUTPUT_CONV_TF32
from simplesr_tpu_torch.models.blocks import (ConvLayer, PReLU, SubpixelConvBlock, checkpointed,
                                              he_conv, pinned_conv2d)
from simplesr_tpu_torch.ops.kernels.trunk import (
    KERNEL_WIDTH,
    TrunkFunction,
    pack_trunk_weights,
)

_ALLOWED_SCALES = (2, 4, 8)


def output_conv(h, conv):
    """``conv`` in float32 on ``h``, at the model's precision on CUDA."""
    return pinned_conv2d(h, conv.weight, conv.bias, OUTPUT_CONV_TF32)


class ResBlock(nn.Module):
    """SRGAN residual block."""

    def __init__(self, num_filters=64, momentum=0.8, batch_norm=True,
                 dtype=torch.bfloat16):
        super().__init__()
        self.conv1 = ConvLayer(num_filters, num_filters, 3, batch_norm, momentum, dtype)
        self.act = PReLU(num_filters)
        self.conv2 = ConvLayer(num_filters, num_filters, 3, batch_norm, momentum, dtype)

    def forward(self, x):
        return x + self.conv2(self.act(self.conv1(x)))


class SRResNet(nn.Module):
    """SRResNet x{2,4,8} generator. ``forward`` takes (B, H, W, 3) in [0, 1]
    and returns (B, sH, sW, 3) float32 in [-1, 1]."""

    def __init__(self, upsample_factor=4, num_filters=64, num_res_blocks=16,
                 momentum=0.8, batch_norm=True, dtype=torch.bfloat16, remat=False):
        super().__init__()
        if upsample_factor not in _ALLOWED_SCALES:
            raise ValueError(
                "upsample factor not supported - please choose either 2, 4 or 8")
        self.upsample_factor = upsample_factor
        self.num_filters = num_filters
        self.num_res_blocks = num_res_blocks
        self.momentum = momentum
        self.batch_norm = batch_norm
        self.dtype = dtype
        self.remat = remat
        self.head = ConvLayer(3, num_filters, 9, dtype=dtype)
        self.head_act = PReLU(num_filters)
        self.blocks = nn.ModuleList(
            ResBlock(num_filters, momentum, batch_norm, dtype)
            for _ in range(num_res_blocks))
        self.trunk_out = ConvLayer(num_filters, num_filters, 3, batch_norm, momentum, dtype)
        self.upsample = nn.ModuleList(
            SubpixelConvBlock(num_filters, 2, activation=True, dtype=dtype)
            for _ in range(upsample_factor.bit_length() - 1))
        # the JAX model's output conv keeps flax's default kernel init,
        # lecun_normal: variance_scaling(1.0, "fan_in", "truncated_normal")
        self.out = he_conv(num_filters, 3, 9, scale=1.0)
        self.uses_trunk_kernel = (not batch_norm and dtype == torch.bfloat16
                                  and num_filters == KERNEL_WIDTH)
        self._packed = None  # (key, the parameters' storage, TrunkWeights)

    def _block_parameters(self):
        return [(b.conv1.conv.weight, b.conv1.conv.bias, b.act.alpha, b.conv2.conv.weight,
                 b.conv2.conv.bias) for b in self.blocks]

    def trunk_parameters(self):
        """The residual blocks' parameters in ``TrunkFunction``'s order."""
        return [t for block in self._block_parameters() for t in block]

    def trunk_weights(self, params=None):
        """The blocks' parameters as they are now (``params``, as
        ``trunk_parameters`` gives them), packed for the kernel
        (``ops.kernels.residual_trunk``), outside autograd. The packing is
        kept between calls while no parameter was written in place (its
        version counter) or given new data (its address; the kept key holds
        the old storage, so no new tensor can take its address meanwhile)."""
        params = self.trunk_parameters() if params is None else params
        key = [(p.data_ptr(), None if torch.is_inference(p) else p._version) for p in params]
        if self._packed is None or self._packed[0] != key:
            with torch.no_grad():
                self._packed = (key, [p.detach() for p in params],
                                pack_trunk_weights(self._block_parameters()))
        return self._packed[2]

    def _trunk(self, h):
        if not self.uses_trunk_kernel:
            remat = self.remat and torch.is_grad_enabled()
            for block in self.blocks:
                h = checkpointed(block, h) if remat else block(h)
            return h
        params = self.trunk_parameters()
        out = TrunkFunction.apply(h.permute(0, 2, 3, 1), self.trunk_weights(params), *params)
        return out.permute(0, 3, 1, 2)

    def features(self, x):
        """Head, residual trunk, trunk conv and global skip of (B, H, W, 3)
        ``x`` in [0, 1], NCHW."""
        h = x.permute(0, 3, 1, 2).to(self.dtype)
        h = skip = self.head_act(self.head(h))
        return self.trunk_out(self._trunk(h)) + skip

    def tail(self, h):
        """Subpixel blocks, output conv and tanh of NCHW features; (B, sH,
        sW, 3) float32."""
        for block in self.upsample:
            h = block(h)
        return torch.tanh(output_conv(h, self.out)).permute(0, 2, 3, 1).contiguous()

    def forward(self, x):
        return self.tail(self.features(x))
