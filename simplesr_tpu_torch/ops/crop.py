"""Random cropping, as simplesr_tpu.ops.crop (``crop_at``, ``random_crops``,
``batch_random_crops``, ``diverse_crops``). Offsets come from a
``torch.Generator`` where the JAX package takes a key, so the two draw
different offsets from one seed; at the same offsets the crops, and the
diverse selection among them, are the same."""

import torch

__all__ = ["crop_at", "random_crops", "batch_random_crops", "diverse_crops"]


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


def diverse_pick(cands, num_crops, min_variation_patch, min_variation_batch=0.0):
    """The indices of ``num_crops`` of the (K, ph, pw, C) candidates that
    ``diverse_crops`` keeps: those whose std exceeds ``min_variation_patch``
    (earliest first), topped up with the highest-std rejects; if the std of
    the chosen crops' means is below ``min_variation_batch``, the passing
    candidates with the lowest and highest means instead (rejects ranked as
    if they sat at the median)."""
    k = cands.shape[0]
    flat = cands.reshape(k, -1).float()
    stds = flat.std(dim=1, unbiased=False)
    passes = stds > min_variation_patch
    order_pass = torch.where(passes, torch.arange(k, device=cands.device),
                             k + torch.argsort(-stds, stable=True))
    first_pick = torch.argsort(order_pass, stable=True)[:num_crops]
    means = flat.mean(dim=1)
    batch_var = means[first_pick].std(unbiased=False)
    # jnp.median: the mean of the two middle values for an even count
    median = torch.quantile(means, 0.5)
    by_mean = torch.argsort(torch.where(passes, means, median), stable=True)
    n_lo = num_crops - num_crops // 2
    diverse = torch.cat([by_mean[:n_lo], by_mean[k - num_crops // 2:]])
    return first_pick if bool(batch_var >= min_variation_batch) else diverse


def diverse_crops(generator, img, num_crops, patch_size, min_variation_patch,
                  min_variation_batch=0.0, oversample=8):
    """Diversity-aware cropping: ``num_crops * oversample`` random candidates
    scored by their std, selected by ``diverse_pick``: (num_crops, ph, pw, C)."""
    cands = random_crops(generator, img, int(num_crops) * int(oversample), patch_size)
    return cands[diverse_pick(cands, int(num_crops), min_variation_patch, min_variation_batch)]
