"""Image augmentations, as simplesr_tpu.ops.augment, on float (..., H, W, C)
images in [0, 255] (or [0, 1]).

Every augmentation has a deterministic core (``flip_along_x``,
``rotate90_by``, ``adjust_<name>_by``) and a random wrapper
``<name>(generator, img, range)`` with the JAX package's default ranges.
The JAX package draws from a ``jax.random`` key; the port draws from a
``torch.Generator``, so one seed gives other factors in the two packages,
and at the same factors the cores agree. The cores take one factor for all
images, or a tensor of one factor per leading image (shape ``img.shape[:-3]``),
and the random wrappers draw one factor per image.

The data pipeline augments a batch by grouping its items by augmentation
(``draw_batch_params`` and ``apply_batch``), so that each augmentation runs
once per batch whatever the batch's mix.
"""

import torch

__all__ = [
    "flip_along_x", "flip_along_y", "rotate90_by", "rotate90",
    "rgb_to_hsv", "hsv_to_rgb",
    "adjust_hue_by", "adjust_saturation_by", "adjust_brightness_by",
    "adjust_contrast_by", "adjust_gamma_by",
    "adjust_hue", "adjust_saturation", "adjust_brightness",
    "adjust_contrast", "adjust_gamma", "adjust_jpg_quality",
    "augment_fanout", "get_all_available_augmentations", "AUGMENTATIONS",
    "draw_batch_params", "apply_batch",
]

DEFAULT_HUE_RANGE = (-0.07, 0.07)
DEFAULT_SATURATION_RANGE = (0.4, 2.0)
DEFAULT_BRIGHTNESS_RANGE = (0.05, 0.2)
DEFAULT_CONTRAST_RANGE = (0.5, 2.5)
DEFAULT_GAMMA_RANGE = (0.5, 1.5)
DEFAULT_JPG_QUALITY_RANGE = (10, 50)


# ---------------------------------------------------------------- colour space

def rgb_to_hsv(img):
    """Scale-invariant RGB to HSV (tf.image.rgb_to_hsv)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    rng = v - mn
    one = torch.ones_like(rng)
    zero = torch.zeros_like(rng)
    safe_rng = torch.where(rng > 0, rng, one)
    s = torch.where(v > 0, rng / torch.where(v > 0, v, one), zero)
    hr = torch.where(v == r, (g - b) / safe_rng, zero)
    hg = torch.where((v == g) & (v != r), 2.0 + (b - r) / safe_rng, zero)
    hb = torch.where((v == b) & (v != r) & (v != g), 4.0 + (r - g) / safe_rng, zero)
    h = (hr + hg + hb) / 6.0
    h = torch.where(rng > 0, torch.remainder(h, 1.0), zero)
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb(img):
    h, s, v = img[..., 0], img[..., 1], img[..., 2]
    dh = torch.remainder(h, 1.0) * 6.0
    i = torch.floor(dh)
    f = dh - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def select(*choices):  # jnp.select over i == 0 .. 5
        out = choices[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, choices[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


# ------------------------------------------------------- deterministic cores

def flip_along_x(img):
    """Flip up-down (tf.image.flip_up_down)."""
    return torch.flip(img, dims=(-3,))


def flip_along_y(img):
    """Flip left-right (tf.image.flip_left_right)."""
    return torch.flip(img, dims=(-2,))


def rotate90_by(img, rotations):
    """``rotations`` x 90 degrees counter-clockwise (tf.image.rot90)."""
    return torch.rot90(img, int(rotations) % 4, dims=(-3, -2))


def _per_image(factor, img, trailing):
    """``factor`` shaped to broadcast over ``img``: a scalar as it is, a
    tensor of one value per leading image with ``trailing`` unit dims."""
    if isinstance(factor, torch.Tensor) and factor.dim() > 0:
        return factor.to(img.device, img.dtype).reshape(factor.shape + (1,) * trailing)
    return factor


def adjust_hue_by(img, delta):
    hsv = rgb_to_hsv(img)
    h = torch.remainder(hsv[..., 0] + _per_image(delta, img, 2), 1.0)
    return hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))


def adjust_saturation_by(img, factor):
    hsv = rgb_to_hsv(img)
    s = torch.clamp(hsv[..., 1] * _per_image(factor, img, 2), 0.0, 1.0)
    return hsv_to_rgb(torch.stack([hsv[..., 0], s, hsv[..., 2]], dim=-1))


def adjust_brightness_by(img, delta):
    """x + delta, unclipped (tf.image.adjust_brightness)."""
    return img + _per_image(delta, img, 3)


def adjust_contrast_by(img, factor):
    """(x - mean over H, W per channel) * factor + mean (tf.image.adjust_contrast)."""
    mean = torch.mean(img, dim=(-3, -2), keepdim=True)
    return (img - mean) * _per_image(factor, img, 3) + mean


def adjust_gamma_by(img, gamma, gain=1.0):
    """gain * x ** gamma (tf.image.adjust_gamma)."""
    return gain * torch.pow(torch.clamp(img, min=0.0), _per_image(gamma, img, 3))


def adjust_jpg_quality_by(img, quality):
    """A JPEG round trip at ``quality`` of images in [0, 255] or [0, 1]
    (each image's range judged from its maximum)."""
    from simplesr_tpu_torch.ops.jpeg import jpeg_degrade

    scale = torch.where(img.amax(dim=(-3, -2, -1), keepdim=True) > 1.5,
                        torch.tensor(255.0, device=img.device), torch.tensor(1.0, device=img.device))
    out = jpeg_degrade(img / scale, quality) * scale
    return out.to(img.dtype)


# ------------------------------------------------------------ random wrappers

def _uniform(generator, shape, lo, hi):
    return torch.rand(shape, generator=generator) * (hi - lo) + lo


def rotate90(generator, img, rotations=None):
    """A random rotation by 90 or 180 degrees, k in {1, 2} as the reference
    samples it (one k for the call); a non-square image turns by 180
    degrees only, which keeps its shape (as the JAX package's static shapes
    require)."""
    if rotations is not None:
        return rotate90_by(img, rotations)
    if img.shape[-3] != img.shape[-2]:
        return rotate90_by(img, 2)
    return rotate90_by(img, int(torch.randint(1, 3, (), generator=generator)))


def adjust_hue(generator, img, delta_range=None):
    lo, hi = delta_range or DEFAULT_HUE_RANGE
    return adjust_hue_by(img, _uniform(generator, img.shape[:-3], lo, hi))


def adjust_saturation(generator, img, factor_range=None):
    lo, hi = factor_range or DEFAULT_SATURATION_RANGE
    return adjust_saturation_by(img, _uniform(generator, img.shape[:-3], lo, hi))


def adjust_brightness(generator, img, delta_range=None):
    lo, hi = delta_range or DEFAULT_BRIGHTNESS_RANGE
    return adjust_brightness_by(img, _uniform(generator, img.shape[:-3], lo, hi))


def adjust_contrast(generator, img, factor_range=None):
    lo, hi = factor_range or DEFAULT_CONTRAST_RANGE
    return adjust_contrast_by(img, _uniform(generator, img.shape[:-3], lo, hi))


def adjust_gamma(generator, img, factor_range=None):
    lo, hi = factor_range or DEFAULT_GAMMA_RANGE
    return adjust_gamma_by(img, _uniform(generator, img.shape[:-3], lo, hi))


def adjust_jpg_quality(generator, img, quality_range=None):
    """JPEG-degrade with a random integer quality in [lo, hi) per image."""
    lo, hi = quality_range or DEFAULT_JPG_QUALITY_RANGE
    quality = torch.randint(lo, hi, img.shape[:-3], generator=generator).float()
    return adjust_jpg_quality_by(img, quality.to(img.device))


AUGMENTATIONS = {
    "flip_along_x": lambda generator, img: flip_along_x(img),
    "flip_along_y": lambda generator, img: flip_along_y(img),
    "rotate90": rotate90,
    "adjust_hue": adjust_hue,
    "adjust_saturation": adjust_saturation,
    "adjust_brightness": adjust_brightness,
    "adjust_contrast": adjust_contrast,
    "adjust_gamma": adjust_gamma,
    "adjust_jpg_quality": adjust_jpg_quality,
}


def get_all_available_augmentations():
    return list(AUGMENTATIONS)


def augment_fanout(generator, img, augmentations):
    """Identity plus each augmentation of one image (names or
    ``(generator, img) -> img`` callables): (1 + len(augs), H, W, C)."""
    outs = [img]
    for aug in augmentations:
        fn = AUGMENTATIONS[aug] if isinstance(aug, str) else aug
        outs.append(fn(generator, img))
    return torch.stack(outs, dim=0)


# ------------------------------------------------- batches, grouped by kind

# name -> draw(generator, n): one parameter per item, a float32 CPU tensor
_DRAWS = {
    "rotate90": lambda g, n: torch.randint(1, 3, (n,), generator=g).float(),
    "adjust_hue": lambda g, n: _uniform(g, (n,), *DEFAULT_HUE_RANGE),
    "adjust_saturation": lambda g, n: _uniform(g, (n,), *DEFAULT_SATURATION_RANGE),
    "adjust_brightness": lambda g, n: _uniform(g, (n,), *DEFAULT_BRIGHTNESS_RANGE),
    "adjust_contrast": lambda g, n: _uniform(g, (n,), *DEFAULT_CONTRAST_RANGE),
    "adjust_gamma": lambda g, n: _uniform(g, (n,), *DEFAULT_GAMMA_RANGE),
    "adjust_jpg_quality": lambda g, n: torch.randint(*DEFAULT_JPG_QUALITY_RANGE, (n,),
                                                     generator=g).float(),
}
_CORES = {
    "flip_along_x": lambda img, p: flip_along_x(img),
    "flip_along_y": lambda img, p: flip_along_y(img),
    "adjust_hue": adjust_hue_by,
    "adjust_saturation": adjust_saturation_by,
    "adjust_brightness": adjust_brightness_by,
    "adjust_contrast": adjust_contrast_by,
    "adjust_gamma": adjust_gamma_by,
    "adjust_jpg_quality": adjust_jpg_quality_by,
}


def draw_batch_params(names, generator, n):
    """One random parameter per item for each named augmentation, drawn on
    the CPU in a fixed order (the same whatever the device): a (len(names),
    n) float32 CPU tensor, zeros for the flips."""
    rows = [_DRAWS[name](generator, n) if isinstance(name, str) and name in _DRAWS
            else torch.zeros(n) for name in names]
    return torch.stack(rows) if rows else torch.zeros((0, n))


def apply_batch(imgs, aug_ids, names, params, generator=None):
    """Augment a (n, H, W, C) batch: item i gets augmentation
    ``names[aug_ids[i] - 1]`` with its parameter ``params[aug_ids[i] - 1, i]``,
    or none for aug_id 0. ``aug_ids`` and ``params`` live on the host; each
    augmentation runs once on the items that take it (rotations once per
    turn count). A non-square batch turns by 180 degrees only. An entry of
    ``names`` may be a ``(generator, imgs) -> imgs`` callable instead, called
    with ``generator`` on its items."""
    out = imgs
    for a, name in enumerate(names, 1):
        idx = [i for i, v in enumerate(aug_ids) if v == a]
        if not idx:
            continue
        if name == "rotate90":
            turns = params[a - 1, idx].tolist() if imgs.shape[-3] == imgs.shape[-2] \
                else [2] * len(idx)
            groups = {k: [i for i, t in zip(idx, turns) if int(t) == k] for k in set(map(int, turns))}
            updates = [(sel, lambda x, k=k: rotate90_by(x, k)) for k, sel in groups.items()]
        elif callable(name):
            updates = [(idx, lambda x, fn=name: fn(generator, x))]
        else:
            factor = params[a - 1, idx].to(imgs.device)
            updates = [(idx, lambda x, f=factor, core=_CORES[name]: core(x, f))]
        for sel, fn in updates:
            index = torch.tensor(sel, device=imgs.device)
            if out is imgs:
                out = imgs.clone()
            out.index_copy_(0, index, fn(imgs.index_select(0, index)))
    return out
