"""Spatially-sharded inference, as simplesr_tpu.parallel.spatial: one large
image split into row strips across the ranks of a mesh axis.

Each rank takes its strip of the image, receives ``halo`` rows from each
neighbour along the axis (point-to-point), runs the generator's own forward
on the strip with its halos (on a card, the trunk kernel's route) and crops
the scaled halos off; the strips are then gathered, so that every rank
returns the whole SR image. The first and last strips' outer halos are
zero-filled, as the tiled host path zero-pads: the result is near-identical
to a whole-image forward, whose SAME padding re-zeroes at every conv, but
not bit-equal at the image's top and bottom borders; every seam between
strips is exact when the halo covers the model's receptive field.
"""

import torch
import torch.distributed as dist

from simplesr_tpu_torch.parallel.comm import all_gather_cat, exchange
from simplesr_tpu_torch.parallel.mesh import (DATA_AXIS, SPATIAL_AXIS, axis_group, axis_index,
                                              axis_size)

__all__ = ["halo_exchange", "spatial_sharded_apply", "spatial_sharded_apply_batched"]

_FROM_PREV, _FROM_NEXT = 1, 2  # message tags


def halo_exchange(x, halo, group, dim=0):
    """Append ``halo`` rows from the axis neighbours to a local strip along
    ``dim`` (the rows of an (h, W, C) strip by default): (halo + h + halo)
    rows back; the first and last ranks' outer halos are zeros."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    top = torch.zeros_like(x.narrow(dim, 0, halo), memory_format=torch.contiguous_format)
    bottom = torch.zeros_like(top)
    sends, recvs = [], []
    if i > 0:
        sends.append((x.narrow(dim, 0, halo), i - 1, _FROM_NEXT))
        recvs.append((top, i - 1, _FROM_PREV))
    if i < n - 1:
        sends.append((x.narrow(dim, x.shape[dim] - halo, halo), i + 1, _FROM_PREV))
        recvs.append((bottom, i + 1, _FROM_NEXT))
    exchange(sends, recvs, group)
    return torch.cat([top, x, bottom], dim=dim)


def _crop(sr, halo, scale, dim):
    return sr.narrow(dim, halo * scale, sr.shape[dim] - 2 * halo * scale) if halo else sr


def spatial_sharded_apply(apply_fn, image, mesh, scale, halo=32, axis=SPATIAL_AXIS):
    """SR an (H, W, C) image with its rows split over ``mesh[axis]``.

    ``apply_fn`` maps (1, h, W, C) to (1, s*h, s*W, C); ``image`` is the
    whole image on every rank (H divisible by the axis size); ``halo`` LR
    rows are exchanged per side. Returns the whole (s*H, s*W, C) image on
    every rank."""
    n = axis_size(mesh, axis)
    image = torch.as_tensor(image)
    h = image.shape[0]
    if h % n != 0:
        raise ValueError(f"image height {h} not divisible by mesh axis {n}")
    group, i = axis_group(mesh, axis), axis_index(mesh, axis)
    rows = h // n
    strip = halo_exchange(image[i * rows:(i + 1) * rows], halo, group)
    sr = _crop(apply_fn(strip[None])[0], halo, scale, 0)
    return all_gather_cat(sr.contiguous(), 0, group)


def spatial_sharded_apply_batched(apply_fn, images, mesh, scale, halo=32,
                                  batch_axis=DATA_AXIS, axis=SPATIAL_AXIS):
    """SR a batch of large images over a 2-D (batch x spatial) mesh: the
    batch splits over ``mesh[batch_axis]`` and each image's rows over
    ``mesh[axis]``, with halos exchanged along the spatial axis as in
    ``spatial_sharded_apply``.

    ``apply_fn`` maps (N, h, W, C) to (N, s*h, s*W, C); ``images`` (B, H, W,
    C), B divisible by the batch axis, H by the spatial one. Returns the
    whole (B, s*H, s*W, C) batch on every rank."""
    nb, ns = axis_size(mesh, batch_axis), axis_size(mesh, axis)
    images = torch.as_tensor(images)
    b, h = images.shape[:2]
    if b % nb != 0:
        raise ValueError(f"batch {b} not divisible by mesh axis {nb}")
    if h % ns != 0:
        raise ValueError(f"image height {h} not divisible by mesh axis {ns}")
    bi, si = axis_index(mesh, batch_axis), axis_index(mesh, axis)
    per, rows = b // nb, h // ns
    local = images[bi * per:(bi + 1) * per, si * rows:(si + 1) * rows]
    strips = halo_exchange(local, halo, axis_group(mesh, axis), dim=1)
    sr = _crop(apply_fn(strips), halo, scale, 1).contiguous()
    sr = all_gather_cat(sr, 1, axis_group(mesh, axis))
    return all_gather_cat(sr, 0, axis_group(mesh, batch_axis)) if nb > 1 else sr
