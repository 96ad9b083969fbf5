"""The loss-functor protocol, as simplesr_tpu.losses.base.

Every generator loss is called as ``loss(hr_batch, sr_batch, hr_critic,
sr_critic)`` and returns ``(weighted_loss, metrics)``, where ``metrics`` maps
names to scalar tensors that the trainer accumulates. ``loss_weight`` counts
only when ``weighted=True``; the metrics hold the unweighted loss under the
functor's name and, when weighted, ``weighted_<name>``. A bare callable that
returns a scalar is adapted to the protocol by ``adapt_generator_loss``.

``bce_from_probs`` follows tf.keras's rule (probabilities clipped to
[1e-7, 1 - 1e-7], ``log1p(-p)`` for the negative class), not torch's
``F.binary_cross_entropy``, which clamps each log at -100.
"""

import torch

# tf.keras.losses.BinaryCrossentropy clips probabilities by this epsilon.
_BCE_EPS = 1e-7


def bce_from_probs(labels, probs):
    """Mean binary cross-entropy on probabilities, tf.keras's clip."""
    p = probs.clamp(_BCE_EPS, 1.0 - _BCE_EPS)
    return -(labels * torch.log(p) + (1.0 - labels) * torch.log1p(-p)).mean()


def bce_from_logits(labels, logits):
    """Mean sigmoid cross-entropy on logits, in the stable form."""
    return (logits.clamp_min(0.0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs()))).mean()


class Loss:
    """Base class with the reference's weighting and metric conventions."""

    name = "loss"

    def __init__(self, weighted=False, loss_weight=1.0, track_metrics=True):
        self.weighted = weighted
        self.loss_weight = loss_weight if weighted else 1.0
        self.track_metrics = track_metrics

    def _package(self, loss):
        weighted_loss = loss * self.loss_weight
        metrics = {}
        if self.track_metrics:
            metrics[self.name] = loss
            if self.weighted:
                metrics[f"weighted_{self.name}"] = weighted_loss
        return weighted_loss, metrics

    def __str__(self):
        return (f"## {type(self).__name__}\n"
                f"weighted: {self.weighted}\n"
                f"loss weight: {self.loss_weight}\n")


def adapt_generator_loss(fn):
    """A bare callable ``f(hr, sr, hr_critic, sr_critic) -> scalar`` (or a
    Loss-style functor, returned as it is) in the ``(loss, metrics)``
    protocol."""
    if hasattr(fn, "name") and hasattr(fn, "loss_weight"):
        return fn

    class _Adapted:
        name = getattr(fn, "__name__", "custom_loss")
        weighted = False
        loss_weight = 1.0

        def __call__(self, hr, sr, hr_critic, sr_critic):
            out = fn(hr, sr, hr_critic, sr_critic)
            if isinstance(out, tuple):
                return out
            return out, {self.name: out}

    return _Adapted()
