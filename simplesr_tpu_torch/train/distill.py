"""Knowledge distillation, as simplesr_tpu.train.distill: a frozen teacher's
output is an extra target for the generator.

The teacher runs in eval mode, with no gradient, as float32 targets, on the
student's device, inside ``SRModel``'s train and validation steps. A
distilled run's checkpoints are standard student checkpoints.

Config surface: ``distill:`` takes a mapping

    distill:
      model: path/to/teacher.msgpack   # or an in-memory (module, variables)
      weight: 0.5                      # scales the distill term (default 1.0)
      loss: mae                        # "mae" (default) or "mse"

or just the path string (defaults apply). YAML: ``general.distill``.
"""

import copy
from typing import Any, Callable, NamedTuple

import torch

from simplesr_tpu_torch.core.device import resolve_device

__all__ = ["Distiller", "build_distiller"]


class Distiller(NamedTuple):
    """A resolved teacher: its forward, the loss settings and the module."""
    apply_fn: Callable[[Any], Any]  # lr batch -> teacher SR batch (float32)
    weight: float
    loss: str  # "mae" | "mse"
    teacher: Any = None  # the frozen teacher module

    def loss_terms(self, sr, lr):
        """The distill penalty for a student output ``sr`` on LR batch
        ``lr``: (weighted term, metrics). The teacher's output is a
        constant target."""
        teacher_sr = self.apply_fn(lr).float()
        if self.loss == "mse":
            value = torch.mean(torch.square(sr - teacher_sr))
        else:
            value = torch.mean(torch.abs(sr - teacher_sr))
        metrics = {"distillation_loss": value}
        if self.weight != 1.0:
            metrics["weighted_distillation_loss"] = self.weight * value
        return self.weight * value, metrics


def _teacher_module(model, student_upsample_factor, device):
    """The teacher module of a spec's ``model``: a model file, a
    ``(module, flax variables)`` pair or a ``(module, state_dict)`` pair
    (the module is copied, never changed)."""
    from simplesr_tpu_torch.train import serialization
    from simplesr_tpu_torch.train.convert import from_flax_variables

    if isinstance(model, tuple):
        module, variables = model
        module = copy.deepcopy(module)
        if "params" in variables:  # flax's layout
            variables = from_flax_variables(module, variables)
        module.load_state_dict(variables)
        return module
    config, _ = serialization.load_payload(str(model))
    teacher_scale = config.get("upsample_factor")
    if (student_upsample_factor is not None and teacher_scale is not None
            and int(teacher_scale) != int(student_upsample_factor)):
        raise ValueError(
            f"distillation teacher upscales x{teacher_scale} but the "
            f"student upscales x{student_upsample_factor}")
    return serialization.load_model(str(model), device=device)


def build_distiller(spec, *, student_upsample_factor=None, device="cuda"):
    """Normalize a ``distill:`` spec into a :class:`Distiller` whose teacher
    lives on ``device``.

    ``spec`` is a path string, a ``(module, variables)`` pair, or a mapping
    with keys ``model`` (path or pair, required), ``weight``, ``loss``. A
    teacher from a model file has its upsample factor checked against the
    student's.
    """
    if isinstance(spec, Distiller):
        return spec
    if isinstance(spec, (str,)) or hasattr(spec, "__fspath__"):
        spec = {"model": spec}
    elif isinstance(spec, tuple):
        spec = {"model": spec}
    elif not isinstance(spec, dict):
        raise ValueError(f"unsupported distill spec: {spec!r}")
    if "model" not in spec:
        raise ValueError("distill spec needs a 'model' (path or "
                         "(module, variables) pair)")
    unknown = set(spec) - {"model", "weight", "loss"}
    if unknown:
        raise ValueError(f"unknown distill keys: {sorted(unknown)}")

    loss = str(spec.get("loss", "mae")).lower()
    if loss not in ("mae", "mse"):
        raise ValueError(f"distill loss must be 'mae' or 'mse', got {loss!r}")
    weight = float(spec.get("weight", 1.0))
    if not weight > 0.0:
        raise ValueError(f"distill weight must be > 0, got {weight}")

    device = resolve_device(device)
    module = _teacher_module(spec["model"], student_upsample_factor, device)
    module = module.to(device).eval().requires_grad_(False)

    def apply_fn(lr):
        with torch.no_grad():
            return module(lr)

    return Distiller(apply_fn=apply_fn, weight=weight, loss=loss, teacher=module)
