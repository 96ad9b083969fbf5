"""Random cropping, as simplesr_tpu.ops.crop (``crop_at``, ``random_crops``,
``batch_random_crops``; the diversity-sampled crops are not ported). Offsets
come from a ``torch.Generator`` where the JAX package takes a key, so the two
draw different offsets from one seed; at the same offsets the crops are the
same."""

import torch

__all__ = ["crop_at", "random_crops", "batch_random_crops"]


def _start(index, size, patch):
    """``lax.dynamic_slice``'s start: a negative index counts from the end,
    then the start is clamped so that the patch fits."""
    index = int(index)
    index = index + size if index < 0 else index
    return min(max(index, 0), size - patch)


def crop_at(img, top, left, patch_h, patch_w):
    """The (patch_h, patch_w) crop of an HWC image at (top, left), offsets
    taken as ``lax.dynamic_slice`` takes them."""
    top = _start(top, img.shape[0], patch_h)
    left = _start(left, img.shape[1], patch_w)
    return img[top:top + patch_h, left:left + patch_w]


def random_offsets(generator, img, num_crops, patch_size):
    """``num_crops`` uniform (top, left) offsets of a (ph, pw) patch, as two
    int64 CPU tensors."""
    ph, pw = int(patch_size[0]), int(patch_size[1])
    h, w = img.shape[0], img.shape[1]
    if h < ph or w < pw:
        raise ValueError(f"patch {ph}x{pw} larger than image {h}x{w}")
    tops = torch.randint(0, h - ph + 1, (num_crops,), generator=generator)
    lefts = torch.randint(0, w - pw + 1, (num_crops,), generator=generator)
    return tops, lefts


def random_crops(generator, img, num_crops, patch_size):
    """``num_crops`` random (ph, pw) crops of one HWC image:
    (num_crops, ph, pw, C)."""
    tops, lefts = random_offsets(generator, img, num_crops, patch_size)
    ph, pw = int(patch_size[0]), int(patch_size[1])
    return torch.stack([crop_at(img, t, l, ph, pw) for t, l in zip(tops, lefts)])


def batch_random_crops(generator, imgs, num_crops, patch_size):
    """Random crops of each image of a batch (a (B, H, W, C) tensor or a list
    of HWC images of any sizes): (B * num_crops, ph, pw, C)."""
    return torch.cat([random_crops(generator, img, num_crops, patch_size) for img in imgs])
