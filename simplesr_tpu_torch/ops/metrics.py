"""Image quality metrics, as simplesr_tpu.ops.metrics: PSNR, PSNR on Y and
SSIM of NHWC (or HWC) images, with tf.image's formulation and its default
``max_val=2.0`` for images in [-1, 1].

SSIM: 11 x 11 Gaussian window (sigma 1.5), k1 = 0.01, k2 = 0.03, valid
padding, the map averaged over space and channels. The separable window runs
as float32 multiply-adds over ``unfold`` views, so no convolution (and no
TF32) is involved on any device.
"""

import functools

import numpy as np
import torch

__all__ = ["mse", "psnr", "rgb_to_y", "psnr_on_y", "ssim"]

# TF's rgb_to_yuv Y row (ITU-R BT.601 luma coefficients).
_Y_WEIGHTS = (0.299, 0.587, 0.114)


def _flatten_to_nhwc(x):
    x = torch.as_tensor(x).float()
    if x.dim() == 3:
        return x[None], True
    if x.dim() == 4:
        return x, False
    raise ValueError(f"expected rank 3 or 4 image tensor, got rank {x.dim()}")


def mse(a, b):
    a, squeeze = _flatten_to_nhwc(a)
    b, _ = _flatten_to_nhwc(b)
    out = ((a - b) ** 2).mean((1, 2, 3))
    return out[0] if squeeze else out


def psnr(tensor1, tensor2, max_val=2.0):
    """Peak signal-to-noise ratio per image; rank 3 or 4 inputs."""
    a, squeeze = _flatten_to_nhwc(tensor1)
    b, _ = _flatten_to_nhwc(tensor2)
    err = ((a - b) ** 2).mean((1, 2, 3))
    out = 10.0 * (2.0 * float(np.log10(np.float32(max_val))) - torch.log10(err))
    return out[0] if squeeze else out


def rgb_to_y(img):
    """Y (luma) channel, keepdims; tf.image.rgb_to_yuv's Y row."""
    img = torch.as_tensor(img).float()
    weights = torch.tensor(_Y_WEIGHTS, dtype=torch.float32, device=img.device)
    return torch.tensordot(img, weights, dims=([-1], [0]))[..., None]


def psnr_on_y(tensor1, tensor2, max_val=2.0):
    """PSNR on the Y (luma) channel."""
    if tensor1.shape != tensor2.shape:
        raise ValueError("tensors need to have the same shape")
    if tensor1.dim() > 4 or tensor1.dim() < 3:
        raise ValueError("tensors need to be either of rank 4 or rank 3")
    return psnr(rgb_to_y(tensor1), rgb_to_y(tensor2), max_val=max_val)


@functools.lru_cache(maxsize=8)
def _gaussian_window_np(size, sigma):
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    g /= g.sum()
    return g.astype(np.float32)


def _separable_filter(x, win):
    """Valid filter of NHWC ``x`` by ``win`` along H, then along W."""
    k = win.shape[0]
    x = (x.unfold(1, k, 1) * win).sum(-1)
    return (x.unfold(2, k, 1) * win).sum(-1)


def ssim(tensor1, tensor2, max_val=2.0, filter_size=11, filter_sigma=1.5, k1=0.01, k2=0.03):
    """Structural similarity per image; rank 3 or 4 inputs."""
    a, squeeze = _flatten_to_nhwc(tensor1)
    b, _ = _flatten_to_nhwc(tensor2)
    win = torch.from_numpy(_gaussian_window_np(int(filter_size), float(filter_sigma)))
    win = win.to(a.device)
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    mu_a = _separable_filter(a, win)
    mu_b = _separable_filter(b, win)
    mu_aa = _separable_filter(a * a, win)
    mu_bb = _separable_filter(b * b, win)
    mu_ab = _separable_filter(a * b, win)
    var_a = mu_aa - mu_a * mu_a
    var_b = mu_bb - mu_b * mu_b
    cov_ab = mu_ab - mu_a * mu_b
    luminance = (2.0 * mu_a * mu_b + c1) / (mu_a ** 2 + mu_b ** 2 + c1)
    cs = (2.0 * cov_ab + c2) / (var_a + var_b + c2)
    out = (luminance * cs).mean((1, 2, 3))
    return out[0] if squeeze else out
