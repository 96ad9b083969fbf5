"""The SRGAN/ESRGAN discriminator, as simplesr_tpu.models.discriminator, in
NCHW.

conv3 64 s1 (no BN) -> LReLU 0.2 -> conv3 64 s2 + BN -> LReLU -> blocks at
128 / 256 / 512 filters (s1 conv + BN + LReLU, s2 conv + BN + LReLU) ->
flatten -> Dense 1024 -> LReLU -> Dense 1 in float32 -> sigmoid unless the
critic is relativistic (the relativistic losses take logits). Kernels are
scaled he-normal (0.2), biases zero.

Numerics are flax's: convolutions and the Dense 1024 in the compute dtype
(bf16 by default), BatchNorm in float32 with momentum 0.8 and eps 1e-3
(``blocks.batch_norm``: biased batch variance, running statistics moved in
training mode), and the stride-2 convs padded as XLA's ``SAME``
(``blocks.same_padding``: (0, 1) on an even side). The features are
flattened in flax's (h, w, c) order, so the Dense 1024's rows keep the JAX
package's order and a model file's kernel carries over transposed only.

Module names are flax's (``ConvLayer_i``, ``Dense_0``, ``Dense_1``), for
``train/convert.py``. The flattened size follows from ``input_dims``: the
critic takes that crop size only, as in the JAX package.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from simplesr_tpu_torch.models.blocks import ConvLayer, scaled_he_normal_


def _dense(in_features, features):
    dense = nn.Linear(in_features, features)
    scaled_he_normal_(dense.weight)
    nn.init.zeros_(dense.bias)
    return dense


class Discriminator(nn.Module):
    def __init__(self, num_filters=64, alpha=0.2, kernel_size=3, momentum=0.8,
                 relativistic=False, dtype=torch.bfloat16, input_dims=(96, 96)):
        super().__init__()
        self.alpha = alpha
        self.relativistic = relativistic
        self.dtype = dtype
        layers = [(3, num_filters, 1, False), (num_filters, num_filters, 2, True)]
        for mult in (2, 4, 8):
            feats = num_filters * mult
            layers += [(layers[-1][1], feats, 1, True), (feats, feats, 2, True)]
        for i, (cin, cout, stride, bn) in enumerate(layers):
            self.add_module(f"ConvLayer_{i}", ConvLayer(cin, cout, kernel_size, bn, momentum,
                                                        dtype, stride=stride, he_scale=0.2))
        self.num_layers = len(layers)
        h, w = input_dims
        for _ in range(4):  # the four stride-2 convs, SAME
            h, w = -(-h // 2), -(-w // 2)
        self.Dense_0 = _dense(h * w * num_filters * 8, 1024)
        self.Dense_1 = _dense(1024, 1)

    def forward(self, x):
        """(B, H, W, 3) -> (B, 1) float32: probabilities, or logits when
        relativistic."""
        h = x.permute(0, 3, 1, 2)
        for i in range(self.num_layers):
            h = F.leaky_relu(getattr(self, f"ConvLayer_{i}")(h), self.alpha)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1).to(self.dtype)  # flax's (h, w, c)
        h = F.linear(h, self.Dense_0.weight.to(self.dtype))
        h = F.leaky_relu(h + self.Dense_0.bias.to(self.dtype), self.alpha)
        h = F.linear(h.float(), self.Dense_1.weight.float(), self.Dense_1.bias.float())
        return h if self.relativistic else torch.sigmoid(h)
