"""Separable image resize, as simplesr_tpu.ops.resize: each spatial axis is
resampled by a dense (out, in) weight matrix computed on the host, applied
as a float32 contraction.

The weights follow TF2's ``tf.image.resize(..., antialias=True)`` (the
scale-and-translate formulation): half-pixel sampling, the kernel widened by
the downscale factor when antialiasing, out-of-range taps dropped and rows
renormalised to sum 1. ``"bicubic"`` is Keys' cubic with a = -0.5, and
without antialias TF's 1024-entry coefficient table quantises the sample
position; ``F.interpolate``'s bicubic (a = -0.75, no antialias table) is a
different function. This resize defines the LR training distribution.
"""

import functools

import numpy as np
import torch

__all__ = ["resize", "resize_weights", "METHODS"]


def _kernel_triangle(x):
    return np.maximum(0.0, 1.0 - np.abs(x))


def _keys_cubic(x, a):
    x = np.abs(x)
    return np.where(
        x <= 1.0,
        ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
        np.where(x < 2.0, ((a * x - 5.0 * a) * x + 8.0 * a) * x - 4.0 * a, 0.0),
    )


def _kernel_keys_cubic(x):
    """Keys cubic, a = -0.5 (Catmull-Rom): TF2's and JAX's 'bicubic'."""
    return _keys_cubic(x, -0.5)


def _kernel_lanczos(x, radius):
    return np.where(np.abs(x) < radius, np.sinc(x) * np.sinc(x / radius), 0.0)


def _kernel_box(x):
    return np.where(np.abs(x) <= 0.5, 1.0, 0.0)


METHODS = {
    # name: (kernel_fn, support_radius)
    "bilinear": (_kernel_triangle, 1.0),
    "triangle": (_kernel_triangle, 1.0),
    "bicubic": (_kernel_keys_cubic, 2.0),
    "cubic": (_kernel_keys_cubic, 2.0),
    "lanczos3": (functools.partial(_kernel_lanczos, radius=3.0), 3.0),
    "lanczos5": (functools.partial(_kernel_lanczos, radius=5.0), 5.0),
    "area": (_kernel_box, 0.5),
    "box": (_kernel_box, 0.5),
}


@functools.lru_cache(maxsize=256)
def _resize_weights_np(in_size, out_size, method, antialias):
    """Dense (out_size, in_size) resampling matrix, float32 numpy."""
    if method not in METHODS:
        raise ValueError(f"unknown resize method {method!r}; options: {sorted(METHODS)}")
    kernel, support = METHODS[method]
    scale = out_size / in_size
    kscale = scale if (antialias and scale < 1.0) else 1.0
    i = np.arange(out_size, dtype=np.float64)
    sample_f = (i + 0.5) / scale - 0.5  # half-pixel centres, input coordinates
    if method in ("bicubic", "cubic") and not antialias:
        # TF's non-antialiased bicubic quantises the fractional sample
        # position to a 1024-entry coefficient table.
        lo = np.floor(sample_f)
        sample_f = lo + np.floor((sample_f - lo) * 1024.0 + 0.5) / 1024.0
    j = np.arange(in_size, dtype=np.float64)
    x = (j[None, :] - sample_f[:, None]) * kscale
    w = np.where(np.abs(x) <= support + 1e-9, kernel(x), 0.0)
    row_sum = w.sum(axis=1, keepdims=True)
    w = w / np.where(row_sum == 0.0, 1.0, row_sum)
    return w.astype(np.float32)


def resize_weights(in_size, out_size, method="bilinear", antialias=True, device="cpu"):
    """The (out, in) resampling matrix as a float32 tensor on ``device``."""
    w = _resize_weights_np(int(in_size), int(out_size), method, bool(antialias))
    return torch.from_numpy(w).to(device)


def _nearest(img, size):
    h_out, w_out = size
    h_in, w_in = img.shape[-3], img.shape[-2]
    # TF v2 nearest: floor((i + 0.5) * in / out)
    rows = np.clip(np.floor((np.arange(h_out) + 0.5) * h_in / h_out), 0, h_in - 1)
    cols = np.clip(np.floor((np.arange(w_out) + 0.5) * w_in / w_out), 0, w_in - 1)
    rows = torch.from_numpy(rows.astype(np.int64)).to(img.device)
    cols = torch.from_numpy(cols.astype(np.int64)).to(img.device)
    return img.index_select(-3, rows).index_select(-2, cols)


def resize(img, size, method="bilinear", antialias=True):
    """Resize (..., H, W, C) images to ``size=(H', W')``, in float32 (a
    floating input of another dtype comes back as float32, as TF's does)."""
    h_out, w_out = int(size[0]), int(size[1])
    h_in, w_in = img.shape[-3], img.shape[-2]
    if method == "nearest":
        return _nearest(img, (h_out, w_out))
    orig_dtype = img.dtype
    x = img.float()
    if h_out != h_in:
        wh = resize_weights(h_in, h_out, method, antialias, x.device)
        x = torch.einsum("oh,...hwc->...owc", wh, x)
    if w_out != w_in:
        ww = resize_weights(w_in, w_out, method, antialias, x.device)
        x = torch.einsum("pw,...owc->...opc", ww, x)
    return x if orig_dtype.is_floating_point else x.to(orig_dtype)
