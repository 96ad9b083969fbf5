"""Learned perceptual loss, as simplesr_tpu.losses.learned_perceptual: the
MSE between the trunk features of a saved SR generator (head, trunk and
global skip: the model's ``features``) on the HR and on the SR batch, the
stand-in for ImageNet VGG features where none can be fetched.

Inputs in [-1, 1] are taken to [0, 1], the generators' input range; the
loss is ``mean((f(hr) - f(sr))^2) * feature_scale^2 * loss_weight``, the
difference taken in the extractor's dtype, as in the JAX package. The
extractor is frozen. When it is the BN-free bf16 64-filter SRResNet, its
trunk is the trunk kernel on CUDA, through ``TrunkFunction`` on both sides
(the HR side under ``no_grad``). The extractor follows its inputs' device.
"""

import torch

from simplesr_tpu_torch.losses.base import Loss


class LearnedPerceptualLoss(Loss):
    """``model_path``: a saved generator (``.msgpack``), or
    ``extractor=(module, variables)``: a port generator module and its
    variables in flax's layout (None: as the module holds them)."""

    name = "learned_perceptual_loss"

    def __init__(self, model_path=None, feature_scale=1.0, loss_weight=1.0,
                 track_metrics=True, extractor=None):
        super().__init__(weighted=(loss_weight != 1.0), loss_weight=1.0,
                         track_metrics=track_metrics)
        self.loss_weight = loss_weight  # applied inside the sum, as VGGLoss does
        self.feature_scale = feature_scale
        if extractor is not None:
            module, variables = extractor
            if variables is not None:
                from simplesr_tpu_torch.train.convert import from_flax_variables

                module.load_state_dict(from_flax_variables(module, variables))
        elif model_path is not None:
            from simplesr_tpu_torch.train.serialization import load_model

            module = load_model(model_path, device="cpu")
        else:
            raise ValueError("need model_path or extractor=(module, variables)")
        if not hasattr(module, "features"):
            raise ValueError(f"{type(module).__name__} has no trunk feature method")
        self._module = module.eval().requires_grad_(False)

    def features(self, img_01):
        """Trunk features of an NHWC batch in [0, 1]."""
        if next(self._module.parameters()).device != img_01.device:
            self._module.to(img_01.device)
        return self._module.features(img_01)

    def __call__(self, hr_batch, sr_batch, hr_critic=None, sr_critic=None, denormalize=True):
        hr, sr = hr_batch.float(), sr_batch.float()
        if denormalize:  # [-1, 1] -> [0, 1]
            hr, sr = (hr + 1.0) * 0.5, (sr + 1.0) * 0.5
        with torch.no_grad():
            hr_f = self.features(hr)
        diff = (hr_f - self.features(sr)).float()
        loss = (diff * diff).mean() * (self.feature_scale ** 2) * self.loss_weight
        return loss, ({self.name: loss} if self.track_metrics else {})

    def __str__(self):
        return (f"## Learned Perceptual Loss\n"
                f"extractor: {type(self._module).__name__} trunk\n"
                f"feature scaling: {self.feature_scale}\n"
                f"loss weight: {self.loss_weight}\n")
