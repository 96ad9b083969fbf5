"""Optimizers, as simplesr_tpu.train.optimizers: Keras-style names and
configs (``"Adam"`` with ``beta_1``, ``beta_2``, ``epsilon``; Keras's eps of
1e-7), the four learning-rate schedules and ``clipnorm``, each update
written out to equal the optax transformation that the JAX package builds
from the same config. ``torch.optim``'s classes round differently (Adam
divides by sqrt(v) / sqrt(bias correction)) and read their step from their
own counter, so none is used.

An optimizer updates a list of parameters in place from a list of
gradients. Its ``count`` is the number of updates it applied, which is the
step its schedule reads and Adam's bias correction counts, as optax's
``count``. ``SkipNonFinite`` is ``optax.apply_if_finite``: a step with a
non-finite gradient is dropped whole (no update, no count) until
``max_consecutive_errors`` have been dropped in a row. ``MultiSteps`` is
``optax.MultiSteps``: k micro-gradients averaged (Welford's running mean)
into one update of the optimizer it wraps. ``structure()`` describes what
shapes an optimizer's state as optax's state tree would be shaped (kind,
a schedule or a constant rate, clipping, accumulation and the NaN guard),
so that a checkpoint's state is carried into an optimizer only of the same
structure.
"""

import math

import numpy as np
import torch

__all__ = ["piecewise_constant_decay", "build_schedule", "build_optimizer", "Optimizer",
           "MultiSteps", "SkipNonFinite"]


def piecewise_constant_decay(boundaries, values):
    """Keras PiecewiseConstantDecay: ``values[0]`` while step <=
    boundaries[0], ``values[i]`` for boundaries[i-1] < step <= boundaries[i],
    ``values[-1]`` afterwards."""
    if len(values) != len(boundaries) + 1:
        raise ValueError("need len(values) == len(boundaries) + 1")
    boundaries, values = list(boundaries), [float(v) for v in values]
    return lambda step: values[sum(step > b for b in boundaries)]


def _exponential_decay(init_value, transition_steps, decay_rate, staircase=False):
    if transition_steps <= 0 or decay_rate == 0:
        return lambda step: init_value

    def schedule(step):
        p = step / transition_steps
        if staircase:
            p = math.floor(p)
        return init_value if step <= 0 else init_value * decay_rate ** p

    return schedule


def _cosine_decay(init_value, decay_steps, alpha=0.0):
    if not decay_steps > 0:
        raise ValueError(f"cosine decay requires positive decay_steps, got {decay_steps}")

    def schedule(step):
        cosine = 0.5 * (1.0 + math.cos(math.pi * min(step, decay_steps) / decay_steps))
        return init_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def _warmup_cosine_decay(init_value, peak_value, warmup_steps, decay_steps, end_value=0.0):
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine = _cosine_decay(peak_value, decay_steps - warmup_steps, alpha)

    def schedule(step):
        if step >= warmup_steps:
            return cosine(step - warmup_steps)
        if warmup_steps <= 0:
            return init_value
        frac = 1.0 - min(max(step, 0), warmup_steps) / warmup_steps
        return (init_value - peak_value) * frac + peak_value

    return schedule


def build_schedule(learning_rate):
    """A float, a callable of the step, or a dict spec such as
    ``{"piecewise_constant_decay": {"boundaries": [...], "values": [...]}}``
    (also ``exponential_decay``, ``cosine_decay``, ``warmup_cosine_decay``,
    and their Keras CamelCase names)."""
    if learning_rate is None:
        return 1e-3
    if callable(learning_rate) or isinstance(learning_rate, (int, float)):
        return learning_rate
    if isinstance(learning_rate, dict):
        if len(learning_rate) != 1:
            raise ValueError(f"ambiguous schedule spec: {learning_rate}")
        kind, cfg = next(iter(learning_rate.items()))
        kind = kind.lower()
        if kind in ("piecewiseconstantdecay", "piecewise_constant_decay"):
            return piecewise_constant_decay(cfg["boundaries"], cfg["values"])
        if kind in ("exponentialdecay", "exponential_decay"):
            return _exponential_decay(cfg["initial_learning_rate"], cfg["decay_steps"],
                                      cfg["decay_rate"], cfg.get("staircase", False))
        if kind in ("cosinedecay", "cosine_decay"):
            return _cosine_decay(cfg["initial_learning_rate"], cfg["decay_steps"],
                                 cfg.get("alpha", 0.0))
        if kind in ("warmupcosinedecay", "warmup_cosine_decay"):
            return _warmup_cosine_decay(cfg.get("initial_learning_rate", 0.0),
                                        cfg["peak_learning_rate"], cfg["warmup_steps"],
                                        cfg["decay_steps"], cfg.get("end_learning_rate", 0.0))
        raise ValueError(f"unknown schedule kind {kind!r}")
    raise TypeError(f"bad learning_rate spec: {learning_rate!r}")


def _moment(decay, grads, moments):
    """optax's ``(1 - decay) * g + decay * m``, into ``moments``."""
    torch._foreach_mul_(moments, decay)
    torch._foreach_add_(moments, torch._foreach_mul(grads, 1.0 - decay))


class Optimizer:
    """One of ``"adam"``, ``"adamw"``, ``"sgd"``, ``"rmsprop"`` with a
    learning rate (a float or a schedule of ``count``) and an optional
    ``clipnorm`` (clip by global norm first)."""

    def __init__(self, kind, learning_rate, config):
        if kind not in ("adam", "adamw", "sgd", "rmsprop"):
            raise ValueError(f"unknown optimizer {kind!r}; options "
                             "['adam', 'adamw', 'rmsprop', 'sgd']")
        self.kind = kind
        self.learning_rate = learning_rate
        self.clipnorm = config.get("clipnorm") or None
        self.b1 = config.get("beta_1", 0.9)
        self.b2 = config.get("beta_2", 0.999)
        self.eps = config.get("epsilon", 1e-7)
        self.weight_decay = config.get("weight_decay", 1e-4)
        self.rho = config.get("rho", 0.9)
        momentum = config.get("momentum")
        # optax.sgd gets `momentum or None` (no trace for 0); rmsprop always
        # gets a trace, of decay 0.0 by default.
        self.momentum = (momentum or None) if kind == "sgd" else (momentum or 0.0)
        self.nesterov = config.get("nesterov", False) if kind == "sgd" else False
        self.count = 0
        self.slots = {}

    def _lr(self):
        lr = self.learning_rate
        return float(lr(self.count)) if callable(lr) else float(lr)

    def _slot(self, name, params):
        if name not in self.slots:
            self.slots[name] = [torch.zeros_like(p) for p in params]
        return self.slots[name]

    def _clip(self, grads):
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        keep = norm < self.clipnorm
        return [torch.where(keep, g, (g / norm) * self.clipnorm) for g in grads]

    @torch.no_grad()
    def apply(self, params, grads):
        """One update of ``params`` (in place) by ``grads``, in multi-tensor
        ops (a few launches for all the tensors, not a few per tensor)."""
        if self.clipnorm is not None:
            grads = self._clip(grads)
        step = -self._lr()
        if self.kind in ("adam", "adamw"):
            # bias corrections in float32, as optax computes them
            count = self.count + 1
            bc1, bc2 = (float(1 - np.float32(b) ** count) for b in (self.b1, self.b2))
            mus, nus = self._slot("mu", params), self._slot("nu", params)
            _moment(self.b1, grads, mus)
            _moment(self.b2, torch._foreach_mul(grads, grads), nus)
            denom = torch._foreach_sqrt(torch._foreach_div(nus, bc2))
            torch._foreach_add_(denom, self.eps)
            updates = torch._foreach_div(torch._foreach_div(mus, bc1), denom)
            if self.kind == "adamw":
                torch._foreach_add_(updates, torch._foreach_mul(params, self.weight_decay))
            torch._foreach_mul_(updates, step)
        elif self.kind == "sgd":
            updates = grads
            if self.momentum is not None:
                traces = self._slot("trace", params)
                torch._foreach_mul_(traces, self.momentum)
                torch._foreach_add_(traces, grads)
                updates = (torch._foreach_add(grads, torch._foreach_mul(traces, self.momentum))
                           if self.nesterov else traces)
            updates = torch._foreach_mul(updates, step)
        else:  # rmsprop: scale by rms, then the learning rate, then the trace
            nus, traces = self._slot("nu", params), self._slot("trace", params)
            _moment(self.rho, torch._foreach_mul(grads, grads), nus)
            rsqrt = torch._foreach_rsqrt(torch._foreach_add(nus, self.eps))
            scaled = torch._foreach_mul(grads, rsqrt)
            torch._foreach_mul_(scaled, step)
            torch._foreach_mul_(traces, self.momentum)
            torch._foreach_add_(traces, scaled)
            updates = traces
        torch._foreach_add_(params, updates)
        self.count += 1

    def structure(self):
        return (self.kind, callable(self.learning_rate), self.clipnorm is not None)

    def state_dict(self):
        return {"count": self.count,
                "slots": {k: [t.detach().clone() for t in v] for k, v in self.slots.items()}}

    def load_state_dict(self, state):
        self.count = int(state["count"])
        self.slots = {k: [t.clone() for t in v] for k, v in state["slots"].items()}


class MultiSteps:
    """``optax.MultiSteps(inner, every_k_schedule=every_k)``: each call
    folds its gradients into a running mean, ``acc + (g - acc) / (n + 1)``;
    the ``every_k``-th call applies ``inner`` with the mean and clears it.
    ``count`` is the number of updates applied (optax's ``gradient_step``)."""

    def __init__(self, inner, every_k):
        self.inner = inner
        self.every_k = int(every_k)
        self.mini_step = 0
        self.acc = None
        # data-parallel training: the accumulated (local) mean -> the
        # gradients ``inner`` applies (reduced over the ranks)
        self.reduce = None

    @property
    def count(self):
        return self.inner.count

    @torch.no_grad()
    def apply(self, params, grads):
        if self.acc is None:
            self.acc = [torch.zeros_like(g) for g in grads]
        delta = torch._foreach_sub(list(grads), self.acc)
        torch._foreach_div_(delta, self.mini_step + 1)
        torch._foreach_add_(self.acc, delta)
        if self.mini_step == self.every_k - 1:
            self.inner.apply(params, self.acc if self.reduce is None else self.reduce(self.acc))
            torch._foreach_zero_(self.acc)
        self.mini_step = (self.mini_step + 1) % self.every_k

    def structure(self):
        return ("multi_steps", self.every_k, self.inner.structure())

    def state_dict(self):
        return {"mini_step": self.mini_step,
                "acc": None if self.acc is None else [t.detach().clone() for t in self.acc],
                "inner": self.inner.state_dict()}

    def load_state_dict(self, state):
        self.mini_step = int(state["mini_step"])
        self.acc = None if state["acc"] is None else [t.clone() for t in state["acc"]]
        self.inner.load_state_dict(state["inner"])


class SkipNonFinite:
    """``optax.apply_if_finite(inner, max_consecutive_errors)``: a step whose
    gradients hold a NaN or an infinity is dropped, ``inner`` untouched,
    unless more than ``max_consecutive_errors`` were dropped in a row. Reading
    the verdict waits for the device once per step."""

    def __init__(self, inner, max_consecutive_errors=100):
        self.inner = inner
        self.max_consecutive_errors = max_consecutive_errors
        self.notfinite_count = 0
        self.total_notfinite = 0
        # data-parallel training: the local verdict -> the one every rank takes
        self.agree = None

    @property
    def count(self):
        return self.inner.count

    def apply(self, params, grads):
        """Apply ``grads`` unless they are not finite; True if applied."""
        finite = bool(torch.isfinite(torch.cat([g.reshape(-1) for g in grads])).all())
        if self.agree is not None:
            finite = self.agree(finite)
        self.notfinite_count = 0 if finite else self.notfinite_count + 1
        self.total_notfinite += not finite
        if finite or self.notfinite_count > self.max_consecutive_errors:
            self.inner.apply(params, grads)
            return True
        return False

    def structure(self):
        return ("apply_if_finite", self.inner.structure())

    def state_dict(self):
        return {"notfinite_count": self.notfinite_count,
                "total_notfinite": self.total_notfinite, "inner": self.inner.state_dict()}

    def load_state_dict(self, state):
        self.notfinite_count = int(state["notfinite_count"])
        self.total_notfinite = int(state["total_notfinite"])
        self.inner.load_state_dict(state["inner"])


def build_optimizer(optimizer="Adam", config=None):
    """An ``Optimizer`` from a Keras-style name and config dict (an
    ``Optimizer`` passes through)."""
    if isinstance(optimizer, (Optimizer, MultiSteps, SkipNonFinite)):
        return optimizer
    if not isinstance(optimizer, str):
        raise TypeError(f"optimizer must be a name or an Optimizer, got {type(optimizer)}")
    config = dict(config or {})
    lr = build_schedule(config.pop("learning_rate", None))
    return Optimizer(optimizer.lower(), lr, config)
