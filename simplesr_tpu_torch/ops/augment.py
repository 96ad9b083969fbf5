"""Geometric augmentations, as simplesr_tpu.ops.augment: flips and 90
degree rotations of (..., H, W, C) images. The colour augmentations (hue,
saturation, brightness, contrast, gamma, JPEG quality) come with the data
pipeline (ROADMAP.md, Queue 1)."""

import torch

__all__ = ["flip_along_x", "flip_along_y", "rotate90_by", "rotate90"]


def flip_along_x(img):
    """Flip up-down (tf.image.flip_up_down)."""
    return torch.flip(img, dims=(-3,))


def flip_along_y(img):
    """Flip left-right (tf.image.flip_left_right)."""
    return torch.flip(img, dims=(-2,))


def rotate90_by(img, rotations):
    """``rotations`` x 90 degrees counter-clockwise (tf.image.rot90)."""
    return torch.rot90(img, int(rotations) % 4, dims=(-3, -2))


def rotate90(generator, img, rotations=None):
    """A random rotation by 90 or 180 degrees, k in {1, 2} as the reference
    samples it; a non-square image turns by 180 degrees only, which keeps its
    shape (as the JAX package's static shapes require)."""
    if rotations is not None:
        return rotate90_by(img, rotations)
    if img.shape[-3] != img.shape[-2]:
        return rotate90_by(img, 2)
    return rotate90_by(img, int(torch.randint(1, 3, (), generator=generator)))
