"""Geometric self-ensemble (x8 test-time augmentation), as
simplesr_tpu.ops.ensemble.

The model runs on the eight dihedral variants of its input (4 rotations,
with and without a horizontal flip); each output's transform is inverted and
the outputs are averaged in float32. Rotations by 90 and 270 degrees swap H
and W, so the variants fall into two shape groups, even k at (H, W) and odd
k at (W, H). Each group is stacked along the batch and run as one predictor
call: two model calls per ensembled call, not eight.

Tensors are NHWC (or HWC), as the predictor contract is. The transforms are
``torch.rot90`` and ``torch.flip``, so ``dihedral_inverse(
dihedral_transform(x, k), k)`` is ``x`` bit for bit.
"""

import torch

#: the number of elements of the dihedral group D4, the ensemble's size
NUM_TRANSFORMS = 8


def _check(k):
    if not 0 <= k < NUM_TRANSFORMS:
        raise ValueError(f"k must be in [0, {NUM_TRANSFORMS}), got {k}")


def dihedral_transform(x, k):
    """Dihedral element ``k`` in [0, 8) of NHWC (or HWC) images: k % 4
    counter-clockwise 90 degree turns, after a horizontal flip (axis W) when
    k >= 4. k = 0 is the identity."""
    _check(k)
    if k >= 4:
        x = torch.flip(x, dims=(-2,))
    return torch.rot90(x, k % 4, dims=(-3, -2))


def dihedral_inverse(x, k):
    """Inverse of ``dihedral_transform(., k)``, exact."""
    _check(k)
    x = torch.rot90(x, -(k % 4), dims=(-3, -2))
    if k >= 4:
        x = torch.flip(x, dims=(-2,))
    return x


def _group_batched(predict, x, ks):
    """``predict`` once on the batch-stacked transforms ``ks`` of NHWC
    ``x``; the per-k outputs with their transforms inverted."""
    b = x.shape[0]
    stacked = torch.cat([dihedral_transform(x, k) for k in ks], dim=0)
    out = predict(stacked)
    return [dihedral_inverse(out[i * b:(i + 1) * b], k) for i, k in enumerate(ks)]


def self_ensemble(predict, x, transforms=None):
    """SR of NHWC ``x`` through ``predict`` under the geometric
    self-ensemble: the float32 mean of the inverse-transformed outputs.
    ``transforms`` restricts the ensemble to a subset of [0, 8), e.g.
    (0, 4) for a flip-only x2 ensemble."""
    ks = tuple(range(NUM_TRANSFORMS)) if transforms is None else tuple(transforms)
    if len(ks) != len(set(ks)):
        raise ValueError(f"duplicate transforms: {ks}")
    even = [k for k in ks if k % 2 == 0]  # keep (H, W)
    odd = [k for k in ks if k % 2 == 1]   # turned to (W, H)
    outs = []
    for group in (even, odd):
        if group:
            outs.extend(_group_batched(predict, x, group))
    acc = torch.zeros_like(outs[0], dtype=torch.float32)
    for o in outs:
        acc = acc + o.float()
    return acc / len(outs)


def ensemble_predictor(predict, transforms=None):
    """``predict(nhwc) -> nhwc`` wrapped into its self-ensembled version,
    with the same signature and output range."""
    def _ensembled(x):
        return self_ensemble(predict, x, transforms=transforms)
    return _ensembled
