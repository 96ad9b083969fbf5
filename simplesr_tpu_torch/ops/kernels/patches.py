"""Overlapping-window patch extraction: the CUDA kernel
``csrc/patches.cu`` and its plain PyTorch version.

Replaces ``extract_overlapping_patches_pallas``
(simplesr_tpu/ops/pallas/tiling_kernel.py). From a pre-padded (Hp, Wp, C)
image it takes the row-major grid of (ph + 2o, pw + 2o, C) windows at stride
(ph, pw). Pure data movement, bounded by bytes on the H100: one warp of the
kernel copies one window row, in float4s where both row starts and the
row's length are 16-byte multiples and in floats otherwise, for any C and
patch size; the result is bit-exact.
"""

import ctypes

import torch

from simplesr_tpu_torch.ops.kernels import _build


def _grid(padded, patch_h, patch_w, overlap):
    if padded.dim() != 3:
        raise ValueError(f"padded image must be (Hp, Wp, C), got {tuple(padded.shape)}")
    hp, wp, _ = padded.shape
    o = int(overlap)
    if patch_h <= 0 or patch_w <= 0 or o < 0:
        raise ValueError("patch sizes must be positive and the overlap non-negative")
    return (hp - 2 * o) // patch_h, (wp - 2 * o) // patch_w, patch_h + 2 * o, patch_w + 2 * o


def extract_overlapping_patches_reference(padded, patch_h, patch_w, overlap):
    """Plain PyTorch version: two separable gathers (row strips, then column
    windows), as the gather path of simplesr_tpu/ops/tiling.py."""
    grid_h, grid_w, win_h, win_w = _grid(padded, patch_h, patch_w, overlap)
    dev = padded.device
    rows = (torch.arange(grid_h, device=dev)[:, None] * patch_h
            + torch.arange(win_h, device=dev)[None, :])
    cols = (torch.arange(grid_w, device=dev)[:, None] * patch_w
            + torch.arange(win_w, device=dev)[None, :])
    strips = padded[rows]            # (grid_h, win_h, Wp, C)
    patches = strips[:, :, cols]     # (grid_h, win_h, grid_w, win_w, C)
    return patches.permute(0, 2, 1, 3, 4).reshape(
        grid_h * grid_w, win_h, win_w, padded.shape[2])


def extract_overlapping_patches(padded, patch_h, patch_w, overlap):
    """(grid_h * grid_w, ph + 2o, pw + 2o, C) windows of a pre-padded image.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    if padded.device.type == "cpu":
        return extract_overlapping_patches_reference(padded, patch_h, patch_w, overlap)
    if padded.device.type != "cuda":
        raise ValueError(f"extract_overlapping_patches: unsupported device {padded.device}")
    grid_h, grid_w, win_h, win_w = _grid(padded, patch_h, patch_w, overlap)
    if padded.dtype != torch.float32:
        raise ValueError(f"the patch kernel takes float32 images, got {padded.dtype}")
    src = padded.contiguous()
    out = torch.empty((grid_h * grid_w, win_h, win_w, src.shape[2]),
                      dtype=src.dtype, device=src.device)
    if out.numel() == 0:
        return out
    fn = _build.function("ssr_extract_patches",
                         [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 8
                         + [ctypes.c_void_p])
    with torch.cuda.device(src.device):
        code = fn(src.data_ptr(), out.data_ptr(), src.shape[1], src.shape[2],
                  patch_h, patch_w, win_h, win_w, grid_h, grid_w,
                  torch.cuda.current_stream().cuda_stream)
    _build.check(code, "patch extraction kernel")
    extract_overlapping_patches.launches += 1
    return out


extract_overlapping_patches.launches = 0
