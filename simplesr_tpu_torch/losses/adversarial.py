"""Adversarial losses, as simplesr_tpu.losses.adversarial: the standard
(SRGAN) and relativistic-average (ESRGAN) generator and discriminator
losses.

  * AdversarialLoss: BCE(1, D(sr)) on probabilities.
  * RaAdversarialLoss: [BCE(0, D(hr) - mean D(sr)) + BCE(1, D(sr) -
    mean D(hr))] / 2 on logits.
  * DiscriminatorLoss: BCE(sr_labels, D(sr)) + BCE(hr_labels, D(hr)) on
    probabilities, the labels possibly smoothed.
  * RaDiscriminatorLoss: the relativistic mirror on logits, averaged.

The relativistic means are the global batch's under data parallelism
(``parallel.comm.batch_mean``), as in the JAX package's one SPMD program.
"""

import torch

from simplesr_tpu_torch.losses.base import Loss, bce_from_logits, bce_from_probs
from simplesr_tpu_torch.parallel.comm import batch_mean


class AdversarialLoss(Loss):
    """Generator non-saturating loss for the standard GAN."""

    name = "adversarial_loss"

    def __call__(self, hr_batch, sr_batch, hr_critic, sr_critic):
        return self._package(bce_from_probs(torch.ones_like(sr_critic), sr_critic))


class RaAdversarialLoss(Loss):
    """Generator relativistic-average loss (logits in)."""

    name = "ra_adversarial_loss"

    def __call__(self, hr_batch, sr_batch, hr_critic, sr_critic):
        real = bce_from_logits(torch.zeros_like(hr_critic), hr_critic - batch_mean(sr_critic))
        fake = bce_from_logits(torch.ones_like(sr_critic), sr_critic - batch_mean(hr_critic))
        return self._package((real + fake) / 2.0)


class DiscriminatorLoss(Loss):
    """Standard discriminator loss (probabilities in)."""

    name = "discriminator_loss"

    def __call__(self, sr_critic, hr_critic, sr_labels, hr_labels):
        fake = bce_from_probs(sr_labels, sr_critic)
        real = bce_from_probs(hr_labels, hr_critic)
        return self._package(real + fake)


class RaDiscriminatorLoss(Loss):
    """Relativistic-average discriminator loss (logits in)."""

    name = "ra_discriminator_loss"

    def __call__(self, sr_critic, hr_critic, sr_labels, hr_labels):
        real = bce_from_logits(hr_labels, hr_critic - batch_mean(sr_critic))
        fake = bce_from_logits(sr_labels, sr_critic - batch_mean(hr_critic))
        return self._package((real + fake) / 2.0)
