"""VGG perceptual loss (SRGAN / ESRGAN), as simplesr_tpu.losses.vgg_loss.

Multi-layer MSE over VGG19 / VGG16 feature maps, pre- or post-activation,
each scaled by ``feature_scale``, ``loss_weight`` applied to every layer's
term whatever ``weighted`` says, an optional total-variation term on the SR
batch, and the input taken from [-1, 1] to [0, 255] and then through Keras's
'caffe' ``preprocess_input`` (RGB -> BGR, ImageNet means subtracted). The
VGG convolutions are float32 with TF32 off on CUDA (``models/vgg.py``); the
HR side's features take no gradient.

Weights come from ``custom_weights_path``, else ``default_vgg_weights_path``,
else the seeded random init, with the JAX package's warning.
"""

import logging

import torch

from simplesr_tpu_torch.losses.base import Loss
from simplesr_tpu_torch.models.vgg import (VGGFeatures, default_vgg_weights_path,
                                           init_vgg_params, load_vgg_weights_npz)

# Keras caffe-mode ImageNet means, BGR order (vgg19.preprocess_input).
_IMAGENET_MEAN_BGR = (103.939, 116.779, 123.68)


def vgg_preprocess(img_0_255):
    """RGB [0, 255] -> BGR, mean-subtracted (Keras preprocess_input 'caffe')."""
    mean = torch.tensor(_IMAGENET_MEAN_BGR, dtype=img_0_255.dtype, device=img_0_255.device)
    return img_0_255.flip(-1) - mean


def total_variation(images):
    """Sum of absolute differences of neighbouring pixels of NHWC
    ``images`` (tf.image.total_variation), summed over the batch."""
    dh = (images[..., 1:, :, :] - images[..., :-1, :, :]).abs()
    dw = (images[..., :, 1:, :] - images[..., :, :-1, :]).abs()
    return dh.sum() + dw.sum()


class VGGLoss(Loss):
    """Perceptual loss functor, with the JAX package's arguments
    (``total_varation_weight`` spelled as there, for YAML files).
    ``vgg_params`` takes VGG variables in the ``load_vgg_weights_npz``
    layout. The feature extractor follows its inputs' device."""

    name = "vgg_loss"

    def __init__(self, output_layers, feature_scale=1.0, loss_weight=1.0,
                 total_variation_loss=False, total_varation_weight=2e-7,
                 after_activation=True, track_metrics=True, vgg16=False,
                 custom_weights=False, custom_weights_path=None, vgg_params=None):
        super().__init__(weighted=(loss_weight != 1.0), loss_weight=1.0,
                         track_metrics=track_metrics)
        self.loss_weight = loss_weight  # applied inside the layer sum, always
        self.feature_scale = feature_scale
        self.total_variation_loss = total_variation_loss
        self.total_variation_weight = total_varation_weight
        self.after_activation = after_activation
        if isinstance(output_layers, str):
            output_layers = [output_layers]
        self.output_layers = tuple(output_layers)
        self.variant = "vgg16" if vgg16 else "vgg19"

        if vgg_params is not None:
            params = vgg_params
        elif custom_weights or custom_weights_path:
            if custom_weights_path is None:
                raise ValueError("no custom weights path supplied")
            params = load_vgg_weights_npz(custom_weights_path, self.variant)
        else:
            path = default_vgg_weights_path(self.variant)
            if path is not None:
                params = load_vgg_weights_npz(path, self.variant)
            else:
                logging.getLogger("simple_sr").warning(
                    "VGGLoss: no ImageNet %s weights found (set SIMPLESR_VGG_WEIGHTS or drop "
                    "%s.npz next to models/vgg.py) - falling back to RANDOM-init features. "
                    "Perceptual loss values will not match the SRGAN/ESRGAN papers.",
                    self.variant, self.variant)
                params = init_vgg_params(self.variant)
        from simplesr_tpu_torch.train.convert import from_flax_variables

        self._module = VGGFeatures(self.variant, self.output_layers,
                                   before_activation=not after_activation)
        self._module.load_state_dict(from_flax_variables(self._module, params))

    def features(self, img_0_255):
        if next(self._module.parameters()).device != img_0_255.device:
            self._module.to(img_0_255.device)
        taps = self._module(vgg_preprocess(img_0_255))
        return [taps[name] for name in self.output_layers]

    def __call__(self, hr_batch, sr_batch, hr_critic=None, sr_critic=None, denormalize=True):
        hr, sr = hr_batch.float(), sr_batch.float()
        if denormalize:
            hr, sr = (hr + 1.0) * 127.5, (sr + 1.0) * 127.5
        with torch.no_grad():
            hr_feats = self.features(hr)
        loss = 0.0
        for hr_f, sr_f in zip(hr_feats, self.features(sr)):
            diff = hr_f * self.feature_scale - sr_f * self.feature_scale
            loss = loss + (diff * diff).mean() * self.loss_weight
        if self.total_variation_loss:
            loss = loss + self.total_variation_weight * total_variation(sr_batch)
        return loss, ({self.name: loss} if self.track_metrics else {})

    def visualize_feature_maps(self, picture, denormalize=True):
        """The feature maps of ``picture`` (NHWC, in [-1, 1] unless
        ``denormalize`` is off) at each output layer, NHWC, as the JAX
        package's method gives them."""
        p = torch.as_tensor(picture).float()
        if denormalize:
            p = (p + 1.0) * 127.5
        with torch.no_grad():
            return [f.permute(0, 2, 3, 1) for f in self.features(p)]

    def __str__(self):
        return (f"## Vgg Loss\n"
                f"output layers: {list(self.output_layers)}\n"
                f"feature scaling: {self.feature_scale}\n"
                f"after activation: {self.after_activation}\n"
                f"loss weight: {self.loss_weight}\n"
                f"total variation loss: {self.total_variation_loss}\n"
                f"total variation loss weight: {self.total_variation_weight}\n")
