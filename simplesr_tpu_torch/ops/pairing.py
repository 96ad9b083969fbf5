"""Batch-to-channel pairing, an exact weight-space rewrite, as
simplesr_tpu.ops.pairing.

``ways`` images are packed into the channel dimension and every trunk kernel
is expanded block-diagonally, so that each C -> C conv becomes a
ways*C -> ways*C conv. Convolution is linear, so the block-diagonal kernel
computes stream j's convolution on channels [j*C, (j+1)*C) with no
cross-talk, and every per-channel op (bias, PReLU, BatchNorm's inference
affine) tiles across the streams. Only the summation order inside the wider
contraction differs.

``pack_batch`` / ``unpack_batch`` take NHWC tensors; the kernel helpers take
HWIO numpy kernels, as flax keeps them.
"""

import numpy as np

__all__ = ["pack_batch", "unpack_batch", "blockdiag_kernel",
           "blockdiag_kernel_segmented", "pair_param_tree"]


def pack_batch(x, ways: int):
    """[w*g, H, W, C] -> [g, H, W, w*C]; batch items w*i ... w*i + w - 1
    become group i, item j in channels [j*C, (j+1)*C)."""
    if x.shape[0] % ways:
        raise ValueError(f"batch {x.shape[0]} not divisible by ways={ways}")
    g = x.shape[0] // ways
    h, w_, c = x.shape[1:]
    x = x.reshape(g, ways, h, w_, c)
    return x.permute(0, 2, 3, 1, 4).reshape(g, h, w_, ways * c)


def unpack_batch(x, ways: int):
    """Inverse of ``pack_batch``: [g, H, W, w*C] -> [w*g, H, W, C] in the
    original batch order."""
    g, h, w_, wc = x.shape
    if wc % ways:
        raise ValueError(f"channels {wc} not divisible by ways={ways}")
    c = wc // ways
    x = x.reshape(g, h, w_, ways, c)
    return x.permute(0, 3, 1, 2, 4).reshape(g * ways, h, w_, c)


def blockdiag_kernel(kernel: np.ndarray, ways: int) -> np.ndarray:
    """(kh, kw, Cin, Cout) -> (kh, kw, w*Cin, w*Cout) with ``kernel`` on the
    (Cin, Cout) block diagonal: stream j convolves only with stream j."""
    return blockdiag_kernel_segmented(kernel, ways, [kernel.shape[2]])


def blockdiag_kernel_segmented(kernel: np.ndarray, ways: int, in_segments) -> np.ndarray:
    """Block-diagonal expansion for a conv whose input is a concatenation of
    separately packed tensors (RRDB's dense blocks). The concatenation's
    channel axis is segment-major, [seg1*w | seg2*w | ...], stream j holding
    [j*s, (j+1)*s) inside each w*s-wide segment; the expanded kernel routes
    exactly those slices to stream j's outputs. ``in_segments`` lists the
    per-stream segment sizes in concatenation order; they sum to Cin."""
    kh, kw, cin, cout = kernel.shape
    if sum(in_segments) != cin:
        raise ValueError(f"segments {in_segments} sum to {sum(in_segments)}"
                         f" != kernel Cin {cin}")
    out = np.zeros((kh, kw, ways * cin, ways * cout), kernel.dtype)
    for j in range(ways):
        off = 0  # offset into the per-stream input channels
        for s in in_segments:
            paired_off = ways * off + j * s
            out[:, :, paired_off:paired_off + s,
                j * cout:(j + 1) * cout] = kernel[:, :, off:off + s, :]
            off += s
    return out


def pair_param_tree(tree, ways: int):
    """Expand a trunk subtree of parameters or BatchNorm statistics
    ``ways``-fold: 4-d kernels block-diagonal, per-channel vectors tiled.
    Keys are kept."""
    if isinstance(tree, dict):
        return {k: pair_param_tree(v, ways) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.ndim == 4:
        return blockdiag_kernel(arr, ways)
    if arr.ndim == 1:
        return np.tile(arr, ways)
    raise ValueError(f"don't know how to pair a rank-{arr.ndim} trunk parameter")
