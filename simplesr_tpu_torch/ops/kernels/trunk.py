"""Residual trunk of the BN-free SRResNet: the CUDA kernel
``csrc/trunk.cu`` and its plain PyTorch version.

Replaces ``srresnet_trunk_pallas`` (simplesr_tpu/ops/pallas/trunk_kernel.py).
Per residual block, on (B, H, W, C) bf16 NHWC activations:

    y = bf16(PReLU(conv3x3(x) + b1; alpha))
    x = bf16(x + conv3x3(y) + b2)

with SAME zero padding, f32 accumulation and one rounding to bf16 per conv,
after the bias, PReLU and residual add (the TPU kernel's rounding points).
The kernel is bounded by operations on the H100 (about 290 FLOP per byte of
activations moved, at the bf16 ridge); ``csrc/trunk.cu`` says how its design
meets that. It takes C = 64 and any H, W, and reads each conv's weights as
the image that ``swizzle_trunk_weights`` builds here from the logical
weights, once per weight tensor, where a CPU test can check it.

``residual_trunk`` is the forward-only launcher; ``TrunkFunction`` puts it
under autograd, as the model calls it.
"""

import ctypes
import weakref
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from simplesr_tpu_torch.core.dtypes import model_conv_precision
from simplesr_tpu_torch.ops.kernels import _build

KERNEL_WIDTH = 64
TAP_BYTES = KERNEL_WIDTH * KERNEL_WIDTH * 2


def _image_source():
    """For each element of one tap's image, the flat (C_in, C_out) index of
    the logical weight it holds.

    Image row r (wgmma's N index) holds output channel
    16 * ((r >> 1) & 3) + 2 * (r >> 3) + (r & 1), so that the accumulators
    of each thread hold 16 consecutive channels; input channel k of row r
    lies at element r * 64 + ((k >> 3) ^ (r & 7)) * 8 + (k & 7): K-major rows
    of 128 bytes with the 128-byte swizzle of wgmma and TMA.
    """
    r = np.arange(KERNEL_WIDTH)[:, None]
    k = np.arange(KERNEL_WIDTH)[None, :]
    row_channel = 16 * ((r >> 1) & 3) + 2 * (r >> 3) + (r & 1)
    offset = r * KERNEL_WIDTH + (((k >> 3) ^ (r & 7)) << 3) + (k & 7)
    source = np.empty(KERNEL_WIDTH * KERNEL_WIDTH, dtype=np.int64)
    source[offset.reshape(-1)] = (k * KERNEL_WIDTH + row_channel).reshape(-1)
    return torch.from_numpy(source)


_SOURCE = _image_source()
_source_on = {}  # device -> _SOURCE there


def swizzle_trunk_weights(weight):
    """The kernel's weight image of (..., 9, C_in, C_out) taps, C = 64: the
    same shape, each tap's 8 KB permuted as ``_image_source`` says. One
    gather on the weights' device."""
    if tuple(weight.shape[-3:]) != (9, KERNEL_WIDTH, KERNEL_WIDTH):
        raise ValueError(f"weight image needs (..., 9, {KERNEL_WIDTH}, {KERNEL_WIDTH}) taps, "
                         f"got {tuple(weight.shape)}")
    source = _source_on.get(weight.device)
    if source is None:
        source = _source_on[weight.device] = _SOURCE.to(weight.device)
    taps = weight.reshape(-1, KERNEL_WIDTH * KERNEL_WIDTH)
    return taps.index_select(1, source).view(weight.shape)


_images = {}  # id(weight) -> (its version, its image), while the weight lives


def _kernel_image(weight):
    """``swizzle_trunk_weights(weight)``, built once per weight tensor and
    dropped with it; built again if the weight was written in place since
    (an inference tensor keeps no version, and is taken as unchanged)."""
    version = None if torch.is_inference(weight) else weight._version
    cached = _images.get(id(weight))
    if cached is not None and cached[0] == version:
        return cached[1]
    if cached is None:
        weakref.finalize(weight, _images.pop, id(weight), None)
    image = swizzle_trunk_weights(weight)
    _images[id(weight)] = (version, image)
    return image


class TrunkWeights(NamedTuple):
    """Packed trunk parameters, as ``pack_trunk_weights`` builds them.

    weight: (num_blocks, 2, 9, C_in, C_out) bf16, taps in (dy, dx) raster order.
    b1, b2, alpha: (num_blocks, C) float32.
    """

    weight: torch.Tensor
    b1: torch.Tensor
    b2: torch.Tensor
    alpha: torch.Tensor


def pack_trunk_weights(blocks):
    """Pack residual blocks' parameters for ``residual_trunk``.

    ``blocks`` yields (conv1 weight, conv1 bias, PReLU alpha, conv2 weight,
    conv2 bias) per block, conv weights OIHW (C, C, 3, 3). Differentiable:
    under autograd the packed tensors lead back to the parameters (the cast
    to bf16 passes its gradient straight through).
    """
    blocks = [tuple(block) for block in blocks]
    if not blocks:
        raise ValueError("pack_trunk_weights needs at least one block")
    n, (c_out, c_in) = len(blocks), blocks[0][0].shape[:2]
    convs = torch.stack([w for block in blocks for w in (block[0], block[3])])
    weight = convs.to(torch.bfloat16).permute(0, 3, 4, 2, 1).reshape(n, 2, 9, c_in, c_out)
    b1, alpha, b2 = (torch.stack([block[i] for block in blocks]).float().contiguous()
                     for i in (1, 2, 4))
    return TrunkWeights(weight.contiguous(), b1, b2, alpha)


def _oihw(taps):
    """(9, C_in, C_out) taps -> (C_out, C_in, 3, 3) float32 conv weight."""
    c_in, c_out = taps.shape[1], taps.shape[2]
    return taps.float().reshape(3, 3, c_in, c_out).permute(3, 2, 0, 1)


def residual_trunk_reference(x, weights):
    """Plain PyTorch version of the kernel, on any device and any width:
    float32 convolutions of bf16 values, rounded to bf16 where the kernel
    rounds."""
    h = x.permute(0, 3, 1, 2)
    for blk in range(weights.weight.shape[0]):
        t = F.conv2d(h.float(), _oihw(weights.weight[blk, 0]), weights.b1[blk], padding=1)
        alpha = weights.alpha[blk].view(1, -1, 1, 1)
        y = torch.where(t >= 0, t, alpha * t).to(torch.bfloat16)
        t = F.conv2d(y.float(), _oihw(weights.weight[blk, 1]), weights.b2[blk], padding=1)
        h = (h.float() + t).to(torch.bfloat16)
    return h.permute(0, 2, 3, 1).contiguous()


def residual_trunk(x, weights):
    """Run the residual trunk on (B, H, W, C) bf16 NHWC activations.

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel
    (C must be 64) or raises. Forward only, on both: the result carries no
    autograd graph, and on CUDA an input that requires grad is refused
    (``TrunkFunction`` is the differentiable trunk).
    """
    if x.device.type == "cpu":
        with torch.no_grad():
            return residual_trunk_reference(x, weights)
    if x.device.type != "cuda":
        raise ValueError(f"residual_trunk: unsupported device {x.device}")
    if x.requires_grad:
        raise ValueError("residual_trunk is forward only: the input requires grad")
    if x.dim() != 4 or x.dtype != torch.bfloat16 or x.shape[-1] != KERNEL_WIDTH:
        raise ValueError(f"residual_trunk takes (B, H, W, {KERNEL_WIDTH}) bfloat16, "
                         f"got {tuple(x.shape)} {x.dtype}")
    num_blocks = weights.weight.shape[0]
    expect = (num_blocks, 2, 9, KERNEL_WIDTH, KERNEL_WIDTH)
    if tuple(weights.weight.shape) != expect or weights.weight.dtype != torch.bfloat16:
        raise ValueError(f"trunk weights must be {expect} bfloat16")
    for t in weights:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("trunk weights must be contiguous on the input's device")
    for t in (weights.b1, weights.b2, weights.alpha):
        if t.dtype != torch.float32 or tuple(t.shape) != (num_blocks, KERNEL_WIDTH):
            raise ValueError(f"trunk biases and alphas must be ({num_blocks}, "
                             f"{KERNEL_WIDTH}) float32")
    b, h, w, _ = x.shape
    out = x.clone(memory_format=torch.contiguous_format)
    if out.numel() == 0 or num_blocks == 0:
        return out
    scratch = torch.empty_like(out)
    image = _kernel_image(weights.weight)
    # TMA and the bulk weight copies need 16-byte aligned bases; every stride
    # of the activation maps is a multiple of a pixel's 128 bytes.
    for t in (out, scratch, image, weights.b1, weights.b2, weights.alpha):
        if t.data_ptr() % 16:
            raise ValueError("residual_trunk: a buffer is not 16-byte aligned")
    fn = _build.function("ssr_trunk_forward",
                         [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        code = fn(out.data_ptr(), scratch.data_ptr(), image.data_ptr(),
                  weights.b1.data_ptr(), weights.b2.data_ptr(), weights.alpha.data_ptr(),
                  b, h, w, num_blocks, torch.cuda.current_stream().cuda_stream)
    _build.check(code, "trunk kernel")
    residual_trunk.launches += 1
    return out


residual_trunk.launches = 0


def _blocks(params):
    """A flat (w1, b1, alpha, w2, b2) * num_blocks sequence, block by block."""
    if len(params) % 5:
        raise ValueError(f"trunk parameters come in fives per block, got {len(params)}")
    return [params[i:i + 5] for i in range(0, len(params), 5)]


class TrunkFunction(torch.autograd.Function):
    """The residual trunk under autograd: ``TrunkFunction.apply(x, weights,
    *params)`` with (B, H, W, C) bf16 NHWC ``x``, the blocks' (conv1 weight,
    conv1 bias, PReLU alpha, conv2 weight, conv2 bias) in order, and
    ``weights`` those parameters as they are now, packed
    (``pack_trunk_weights``; None to pack them here).

    Forward: runs ``residual_trunk`` on the packed weights (the kernel on
    CUDA, the plain version on the CPU). It keeps only ``x`` and the
    parameters for the backward, not the trunk's 2 * num_blocks activation
    maps.

    Backward: recomputes the plain version from them under autograd and
    returns its gradients, its float32 convolutions at the model's precision
    (``core.dtypes.model_conv_precision``). It launches no kernel: the TPU
    kernel has no VJP (the JAX package trains through flax ResBlocks), so its
    backward is PyTorch's convolutions.
    """

    @staticmethod
    def forward(ctx, x, weights, *params):
        ctx.save_for_backward(x, *params)
        if weights is None:
            weights = pack_trunk_weights(_blocks(params))
        return residual_trunk(x.detach(), weights)

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        needs = (ctx.needs_input_grad[0],) + ctx.needs_input_grad[2:]
        with torch.enable_grad(), model_conv_precision(grad_out.device):
            leaves = [t.detach().requires_grad_(need) for t, need in zip(saved, needs)]
            out = residual_trunk_reference(leaves[0], pack_trunk_weights(_blocks(leaves[1:])))
            grads = iter(torch.autograd.grad(out, [t for t in leaves if t.requires_grad],
                                             grad_out))
        grads = [next(grads) if t.requires_grad else None for t in leaves]
        return (grads[0], None, *grads[1:])
