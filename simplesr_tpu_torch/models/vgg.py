"""VGG16 / VGG19 feature extractor with pre- and post-activation taps, as
simplesr_tpu.models.vgg, in NCHW.

Every conv's output before and after its ReLU is addressable by the conv's
Keras name (``block5_conv4``); the forward stops at the deepest requested
layer. The convolutions are float32 with float32 products, forward and
backward, on every device: the JAX package runs them at
``precision="highest"``, and on CUDA they run with cuDNN's TF32 off
(``blocks.pinned_conv2d``), scoped to these convolutions only.

Weights: ``load_vgg_weights_npz`` reads an ``.npz`` of
``block{i}_conv{j}/kernel`` (HWIO) and ``/bias`` arrays, the JAX package's
layout; ``default_vgg_weights_path`` finds one through the
``SIMPLESR_VGG_WEIGHTS`` variable or as ``<variant>.npz`` next to this
module. Without one, ``init_vgg_params`` gives a seeded random init (flax's
``nn.Conv`` defaults: lecun-normal kernels, zero biases), from torch's
generator: the same seed gives other numbers than JAX's.
"""

import math
import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from simplesr_tpu_torch.models.blocks import pinned_conv2d

VGG_CONFIGS = {
    "vgg16": (2, 2, 3, 3, 3),
    "vgg19": (2, 2, 4, 4, 4),
}
_FILTERS = (64, 128, 256, 512, 512)
DEFAULT_VGG_SEED = 171  # the JAX package's seed for its random-init fallback


def vgg_layer_names(variant="vgg19"):
    return [f"block{b}_conv{c}" for b, n in enumerate(VGG_CONFIGS[variant], 1)
            for c in range(1, n + 1)]


class VGGFeatures(nn.Module):
    """``forward(x)`` on (B, H, W, 3) float32 -> {tap name: NCHW features}
    for each of ``output_layers``, before or after its ReLU
    (``before_activation``). The weights take no gradient."""

    def __init__(self, variant="vgg19", output_layers=("block5_conv4",),
                 before_activation=False):
        super().__init__()
        self.variant = variant
        self.output_layers = tuple(output_layers)
        self.before_activation = before_activation
        unknown = set(self.output_layers) - set(vgg_layer_names(variant))
        if unknown:
            raise ValueError(f"unknown VGG layers {sorted(unknown)} for {variant}")
        in_features = 3
        for b, nconvs in enumerate(VGG_CONFIGS[variant], 1):
            for c in range(1, nconvs + 1):
                self.add_module(f"block{b}_conv{c}",
                                nn.Conv2d(in_features, _FILTERS[b - 1], 3, padding=1))
                in_features = _FILTERS[b - 1]
        self.requires_grad_(False)

    def forward(self, x):
        remaining = set(self.output_layers)
        taps = {}
        h = x.permute(0, 3, 1, 2).float()
        for b, nconvs in enumerate(VGG_CONFIGS[self.variant], 1):
            for c in range(1, nconvs + 1):
                name = f"block{b}_conv{c}"
                conv = getattr(self, name)
                pre = pinned_conv2d(h, conv.weight, conv.bias, tf32=False)
                h = F.relu(pre)
                if name in remaining:
                    taps[name] = pre if self.before_activation else h
                    remaining.discard(name)
                    if not remaining:
                        return taps
            h = F.max_pool2d(h, 2, 2)
        return taps


def load_vgg_weights_npz(path, variant="vgg19"):
    """A ``{"params": {name: {"kernel", "bias"}}}`` tree (numpy, kernels
    HWIO) from an ``.npz`` of ``<name>/kernel`` and ``<name>/bias`` arrays."""
    data = np.load(path)
    return {"params": {name: {"kernel": np.asarray(data[f"{name}/kernel"]),
                              "bias": np.asarray(data[f"{name}/bias"])}
                       for name in vgg_layer_names(variant)}}


def default_vgg_weights_path(variant="vgg19"):
    """The ``SIMPLESR_VGG_WEIGHTS`` file, else ``<variant>.npz`` next to this
    module, else None."""
    env = os.environ.get("SIMPLESR_VGG_WEIGHTS")
    if env and os.path.isfile(env):
        return env
    bundled = os.path.join(os.path.dirname(os.path.abspath(__file__)), f"{variant}.npz")
    return bundled if os.path.isfile(bundled) else None


def init_vgg_params(variant="vgg19", seed=None):
    """Seeded random-init VGG variables in the ``load_vgg_weights_npz``
    layout: lecun-normal kernels (a normal truncated at two standard
    deviations, variance 1 / fan_in), zero biases."""
    gen = torch.Generator().manual_seed(DEFAULT_VGG_SEED if seed is None else seed)
    params, in_features = {}, 3
    for name in vgg_layer_names(variant):
        out = _FILTERS[int(name[5]) - 1]
        std = math.sqrt(1.0 / (9 * in_features)) / 0.87962566103423978
        kernel = torch.empty((3, 3, in_features, out))
        nn.init.trunc_normal_(kernel, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
        params[name] = {"kernel": kernel.numpy(), "bias": np.zeros(out, np.float32)}
        in_features = out
    return {"params": params}
