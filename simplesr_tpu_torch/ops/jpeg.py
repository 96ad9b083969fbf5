"""JPEG degradation as tensor math, as simplesr_tpu.ops.jpeg: the lossy
stages of a JPEG round trip (uint8 rounding, JFIF RGB to YCbCr, 4:2:0 chroma
subsampling, the 8 x 8 blockwise DCT-II, quantisation against the IJG tables
scaled by the quality, the inverse DCT, libjpeg's "fancy" chroma upsampling,
and back to RGB). Entropy coding is lossless and skipped. The DCT is a
float32 matrix product of 8 x 8 blocks, as the JAX package computes it; the
two libraries sum in other orders, so a quantised coefficient at a .5
boundary can round one step apart (tests/test_torch_pipeline.py states the
bound). ``quality`` is a number or a tensor of one quality per image.
"""

import numpy as np
import torch

__all__ = ["jpeg_degrade", "ijg_quant_tables"]

# Standard IJG (Annex K) luminance / chrominance quantisation tables.
_LUMA_TABLE = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], dtype=np.float32)

_CHROMA_TABLE = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
], dtype=np.float32)


def _dct_matrix():
    k = np.arange(8)[:, None]
    n = np.arange(8)[None, :]
    d = np.cos(np.pi * (2 * n + 1) * k / 16.0)
    d[0] *= np.sqrt(1.0 / 8.0)
    d[1:] *= np.sqrt(2.0 / 8.0)
    return d.astype(np.float32)


_DCT = _dct_matrix()


def ijg_quant_tables(quality, device="cpu"):
    """Quality-scaled (luma, chroma) tables by the IJG rule, each (..., 8, 8)
    for a ``quality`` of shape (...) in [1, 100]."""
    q = torch.clamp(torch.as_tensor(quality, dtype=torch.float32, device=device), 1.0, 100.0)
    scale = torch.where(q < 50.0, 5000.0 / q, 200.0 - 2.0 * q)[..., None, None]

    def _scaled(table):
        t = torch.floor((torch.from_numpy(table).to(q.device) * scale + 50.0) / 100.0)
        return torch.clamp(t, 1.0, 255.0)

    return _scaled(_LUMA_TABLE), _scaled(_CHROMA_TABLE)


def _blockwise_dct_quant_roundtrip(chan, qtable):
    """chan: (..., H, W), level-shifted, H and W multiples of 8; qtable:
    (8, 8) or one (8, 8) per image, (..., 8, 8)."""
    h, w = chan.shape[-2], chan.shape[-1]
    d = torch.from_numpy(_DCT).to(chan.device)
    # (..., H/8, 8, W/8, 8) -> (..., H/8, W/8, 8, 8) blocks
    blocks = chan.reshape(chan.shape[:-2] + (h // 8, 8, w // 8, 8)).transpose(-3, -2)
    q = qtable[..., None, None, :, :]
    coeffs = torch.matmul(torch.matmul(d, blocks), d.T)
    coeffs = torch.round(coeffs / q) * q
    out = torch.matmul(torch.matmul(d.T, coeffs), d)
    return out.transpose(-3, -2).reshape(chan.shape)


def _edge_index(n, size, device):
    return torch.clamp(torch.arange(n, device=device), max=size - 1)


def _fancy_upsample2x(c):
    """libjpeg's "fancy" (triangle) chroma upsampling, per axis:
    out[2i] = (3 c[i] + c[i-1]) / 4, out[2i+1] = (3 c[i] + c[i+1]) / 4, with
    the edges replicated."""
    def _axis(x, ax):
        n = x.shape[ax]
        idx = torch.arange(n, device=x.device)
        prev = x.index_select(ax, torch.clamp(idx - 1, min=0))
        nxt = x.index_select(ax, torch.clamp(idx + 1, max=n - 1))
        even = (3.0 * x + prev) / 4.0
        odd = (3.0 * x + nxt) / 4.0
        stacked = torch.stack([even, odd], dim=ax + 1)
        shape = list(x.shape)
        shape[ax] *= 2
        return stacked.reshape(shape)

    c = _axis(c, c.dim() - 2)
    return _axis(c, c.dim() - 1)


def _pad_to_multiple(x, m):
    """Edge-pad the last two axes up to multiples of ``m``."""
    h, w = x.shape[-2], x.shape[-1]
    hp, wp = h + (-h) % m, w + (-w) % m
    if (hp, wp) != (h, w):
        x = x.index_select(-2, _edge_index(hp, h, x.device))
        x = x.index_select(-1, _edge_index(wp, w, x.device))
    return x


def jpeg_degrade(img, quality, subsample=True):
    """JPEG-compress-then-decompress images in [0, 1].

    Args:
      img: (..., H, W, 3) float tensor in [0, 1].
      quality: a number in [1, 100], or a tensor of one per image (shape
        ``img.shape[:-3]``); lower is more degradation.
      subsample: 4:2:0 chroma subsampling (libjpeg's default).

    Returns: the degraded images, float32 in [0, 1].
    """
    x = img.float()
    h, w = x.shape[-3], x.shape[-2]
    x = torch.clamp(torch.round(x * 255.0), 0.0, 255.0)  # TF encodes uint8

    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b

    luma_t, chroma_t = ijg_quant_tables(quality, device=x.device)

    y = _pad_to_multiple(y - 128.0, 8)
    y = _blockwise_dct_quant_roundtrip(y, luma_t)[..., :h, :w]

    def _chroma(c):
        if subsample:
            c2 = _pad_to_multiple(c, 2)
            h2, w2 = c2.shape[-2], c2.shape[-1]
            c_sub = c2.reshape(c2.shape[:-2] + (h2 // 2, 2, w2 // 2, 2)).mean(dim=(-3, -1))
        else:
            c_sub = c
        c_sub = _pad_to_multiple(c_sub - 128.0, 8)
        c_sub = _blockwise_dct_quant_roundtrip(c_sub, chroma_t) + 128.0
        if subsample:
            hs, ws = (h + 1) // 2, (w + 1) // 2
            return _fancy_upsample2x(c_sub[..., :hs, :ws])[..., :h, :w]
        return c_sub[..., :h, :w]

    cb = _chroma(cb)
    cr = _chroma(cr)
    y = y + 128.0

    r = y + 1.402 * (cr - 128.0)
    g = y - 0.344136 * (cb - 128.0) - 0.714136 * (cr - 128.0)
    b = y + 1.772 * (cb - 128.0)
    out = torch.stack([r, g, b], dim=-1)
    return torch.clamp(torch.round(out), 0.0, 255.0) / 255.0
