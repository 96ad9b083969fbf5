"""Losses, as simplesr_tpu.losses: pixel, adversarial, VGG perceptual and
learned perceptual, and the registry that looks a loss up by name."""

from simplesr_tpu_torch.losses.base import (Loss, adapt_generator_loss, bce_from_logits,
                                            bce_from_probs)
from simplesr_tpu_torch.losses.pixel import MeanAbsoluteError, MeanSquaredError
from simplesr_tpu_torch.losses.adversarial import (AdversarialLoss, DiscriminatorLoss,
                                                   RaAdversarialLoss, RaDiscriminatorLoss)
from simplesr_tpu_torch.losses.vgg_loss import VGGLoss, total_variation, vgg_preprocess
from simplesr_tpu_torch.losses.learned_perceptual import LearnedPerceptualLoss

LOSS_REGISTRY = {
    "MeanSquaredError": MeanSquaredError,
    "MeanAbsoluteError": MeanAbsoluteError,
    "VGGLoss": VGGLoss,
    "LearnedPerceptualLoss": LearnedPerceptualLoss,
    "AdversarialLoss": AdversarialLoss,
    "RaAdversarialLoss": RaAdversarialLoss,
    "DiscriminatorLoss": DiscriminatorLoss,
    "RaDiscriminatorLoss": RaDiscriminatorLoss,
}

__all__ = ["Loss", "adapt_generator_loss", "bce_from_probs", "bce_from_logits",
           "MeanSquaredError", "MeanAbsoluteError", "VGGLoss", "LearnedPerceptualLoss",
           "AdversarialLoss", "RaAdversarialLoss", "DiscriminatorLoss", "RaDiscriminatorLoss",
           "LOSS_REGISTRY", "vgg_preprocess", "total_variation"]
