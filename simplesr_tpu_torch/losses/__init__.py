"""Generator losses, as simplesr_tpu.losses: the pixel losses, and the
registry that looks a loss up by name. The adversarial, VGG and learned
perceptual losses come with the GAN family (ROADMAP.md, Queue 1)."""

from simplesr_tpu_torch.losses.base import Loss, adapt_generator_loss
from simplesr_tpu_torch.losses.pixel import MeanAbsoluteError, MeanSquaredError

LOSS_REGISTRY = {
    "MeanSquaredError": MeanSquaredError,
    "MeanAbsoluteError": MeanAbsoluteError,
}

__all__ = ["Loss", "adapt_generator_loss", "MeanSquaredError", "MeanAbsoluteError",
           "LOSS_REGISTRY"]
