"""Polyphase (phase-space) weight transforms for subpixel-upsampling tails,
as simplesr_tpu.ops.polyphase.

The generators' tails (subpixel conv blocks, then the output conv) run their
convolutions at 2x / 4x / 8x the LR resolution with few channels. These
helpers rewrite such a tail exactly, in weight space, so that every conv runs
at LR resolution on the DCR phase tensor and one depth_to_space at the end
gives the HR image:

    conv_fine(d2s(U, s), K)  ==  d2s(conv_coarse(U, coarsen(K, s)), s)

for any stride-1 SAME conv with odd k. Output fine pixel (s*i + p, s*j + q)
reads fine input (s*(i + dc) + p', s*(j + dc') + q') at kernel tap
d = s*dc + p' - p + k//2; K's taps placed at those offsets of a kc x kc
coarse kernel over s^2-grouped channels (zeros where the tap falls outside
K) compute the same sums, SAME zero padding included.

The phase tensor's channels are in TF's DCR order,
``channel = (py*s + px)*C + c`` (``ops.shuffle.depth_to_space_nchw``; torch's
``pixel_shuffle`` is CRD and would scramble them). Kernels are HWIO, as
flax keeps them: the port's modules take them through
``train.convert.from_flax_variables``. Host-side numpy, run once when a
model is loaded.
"""

import numpy as np

__all__ = [
    "coarsen_conv_kernel",
    "coarse_kernel_taps",
    "phase_merge_permutation",
    "phase_split_permutation",
    "tile_phase",
]


def coarse_kernel_taps(k, scale):
    """Coarse kernel size kc for a fine k x k conv at phase scale ``scale``:
    the smallest odd kc whose coarse taps cover all fine offsets
    |d| <= k//2."""
    if k % 2 != 1:
        raise ValueError(f"only odd kernels supported, got k={k}")
    return 2 * ((k // 2 + scale - 1) // scale) + 1


def coarsen_conv_kernel(kernel, scale, bias=None):
    """Embed a fine HWIO kernel (k, k, Cin, Cout) acting at ``scale``x
    resolution into the equivalent coarse kernel
    (kc, kc, scale^2*Cin, scale^2*Cout) acting on the DCR phase tensor.

    Returns (coarse_kernel, coarse_bias); coarse_bias is the phase-tiled
    bias, or None when ``bias`` is None.
    """
    kernel = np.asarray(kernel)
    k, kw, cin, cout = kernel.shape
    if k != kw:
        raise ValueError(f"square kernels only, got {kernel.shape}")
    s = int(scale)
    kc = coarse_kernel_taps(k, s)
    half, chalf = k // 2, kc // 2

    out = np.zeros((kc, kc, s * s * cin, s * s * cout), kernel.dtype)
    for dcy in range(-chalf, chalf + 1):
        for dcx in range(-chalf, chalf + 1):
            for pin in range(s * s):
                piy, pix = divmod(pin, s)
                for pout in range(s * s):
                    poy, pox = divmod(pout, s)
                    dy = s * dcy + piy - poy + half
                    dx = s * dcx + pix - pox + half
                    if 0 <= dy < k and 0 <= dx < k:
                        out[dcy + chalf, dcx + chalf,
                            pin * cin:(pin + 1) * cin,
                            pout * cout:(pout + 1) * cout] = kernel[dy, dx]
    cbias = None if bias is None else tile_phase(bias, s)
    return out, cbias


def phase_merge_permutation(s_in, upsample, channels):
    """Channel permutation from the nested phase order (an s_in-phase tensor
    whose per-pixel channels are themselves DCR groups of a further
    depth_to_space(upsample)) to the direct DCR order of one
    depth_to_space(s_in * upsample).

    nested channel:  ((i*s_in + j) * u^2 + (a*u + b)) * C + c
    direct channel:  ((i*u + a) * (s_in*u) + (j*u + b)) * C + c

    Returns ``perm`` with ``direct = nested[..., perm]``.
    """
    s, u, c = int(s_in), int(upsample), int(channels)
    big = s * u
    perm = np.empty(big * big * c, np.int64)
    for i in range(s):
        for j in range(s):
            for a in range(u):
                for b in range(u):
                    nested = ((i * s + j) * u * u + (a * u + b)) * c
                    direct = ((i * u + a) * big + (j * u + b)) * c
                    perm[direct:direct + c] = np.arange(nested, nested + c)
    return perm


def phase_split_permutation(s_in, upsample, channels):
    """Inverse of ``phase_merge_permutation``: from the direct DCR order of
    depth_to_space(s_in * upsample) to the nested order, so that the outer
    level can be materialised by one depth_to_space(s_in) while the inner
    one stays in channel space.

    Returns ``perm`` with ``nested = direct[..., perm]``.
    """
    merge = phase_merge_permutation(s_in, upsample, channels)
    inv = np.empty_like(merge)
    inv[merge] = np.arange(merge.size)
    return inv


def tile_phase(vec, scale):
    """Tile a per-channel vector (bias, PReLU slope) across s^2 phases in DCR
    order: ``out[p*C + c] = vec[c]``."""
    return np.tile(np.asarray(vec), int(scale) ** 2)
