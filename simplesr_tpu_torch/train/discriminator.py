"""Discriminator wrapper, as simplesr_tpu.train.discriminator: the critic
module, its loss functors (summed when there are several), label smoothing
and the accuracy metrics.

Same constructor surface, ``initialize_standard``,
``initialize_relativistic`` and ``from_yaml``. Labels, smoothed when asked:
SR labels in [0, offset], HR labels in [1 - offset, 1 - offset + 0.5],
drawn from the ``torch.Generator`` the caller passes (the JAX package draws
them from a JAX key: the same seed gives other labels). Accuracy: sign
agreement of the logits for the relativistic critic, 0.5 thresholds for the
standard one. The module lives on one device and ``SRModel`` trains its
parameters in place; ``variables`` gives them in flax's layout. Parameters
are initialised from ``seed`` with scaled he-normal kernels, as flax's are,
but from torch's generator.
"""

import torch

from simplesr_tpu_torch.core.device import resolve_device
from simplesr_tpu_torch.core.dtypes import dtype_from_name
from simplesr_tpu_torch.losses import DiscriminatorLoss, RaDiscriminatorLoss
from simplesr_tpu_torch.models.discriminator import Discriminator as DiscriminatorNet
from simplesr_tpu_torch.parallel.comm import global_rand
from simplesr_tpu_torch.train.convert import from_flax_variables, to_flax_variables
from simplesr_tpu_torch.train.metrics import MetricBundle


class Discriminator:
    def __init__(self,
                 loss_function,
                 relativistic,
                 label_smoothing=False,
                 smoothing_offset=0.3,
                 num_filters=64,
                 alpha=0.2,
                 kernel_size=3,
                 momentum=0.8,
                 initializer=None,
                 input_dims=(96, 96),
                 dtype=None,
                 seed=1,
                 device="cuda"):
        del initializer  # scaled he-normal, as the architecture pins it
        self._relativistic = relativistic
        self._label_smoothing = label_smoothing
        self._smoothing_offset = smoothing_offset if label_smoothing else 0.0
        self._loss_functions = list(loss_function) \
            if isinstance(loss_function, (list, tuple)) else [loss_function]
        self._input_dims = tuple(d or 96 for d in input_dims)
        device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self._module = DiscriminatorNet(
                num_filters=num_filters, alpha=alpha, kernel_size=kernel_size,
                momentum=momentum, relativistic=relativistic, dtype=dtype_from_name(dtype),
                input_dims=self._input_dims)
        self._module = self._module.to(device)

        names = []
        for fn in self._loss_functions:
            names.append(fn.name)
            if fn.weighted:
                names.append(f"weighted_{fn.name}")
        names += ["discriminator_accuracy", "SR_accuracy", "HR_accuracy"]
        self._batch_metrics = MetricBundle(names)
        self._epoch_metrics_train = MetricBundle(names)
        self._epoch_metrics_valid = MetricBundle(names)

    # ------------------------------------------------------------ access

    def model(self):
        return self._module

    def to(self, device):
        self._module = self._module.to(resolve_device(device))
        return self

    @property
    def variables(self):
        """The module's variables in flax's layout (CPU copies)."""
        return to_flax_variables(self._module.state_dict())

    def set_variables(self, variables):
        """Load flax-layout ``variables`` (a JAX discriminator's) into the
        module."""
        self._module.load_state_dict(from_flax_variables(self._module, variables))

    @property
    def relativistic(self):
        return self._relativistic

    def loss_function(self):
        if len(self._loss_functions) == 1:
            return self._loss_functions[0]
        return self._loss_functions

    def batch_metrics(self):
        return self._batch_metrics

    def epoch_metrics(self, train=True):
        return self._epoch_metrics_train if train else self._epoch_metrics_valid

    def reset_epoch_metrics(self):
        self._epoch_metrics_train.reset()
        self._epoch_metrics_valid.reset()

    def reset_batch_metrics(self):
        self._batch_metrics.reset()

    def accumulate_metrics(self, metrics, train=True):
        self._batch_metrics.update(metrics)
        self.epoch_metrics(train).update(metrics)

    # ------------------------------------------------------------ compute

    def accuracy_metrics(self, sr_critic, hr_critic):
        if self._relativistic:
            sr_acc = (sr_critic < 0.0).float().mean()
            hr_acc = (hr_critic > 0.0).float().mean()
        else:
            sr_acc = (sr_critic < 0.5).float().mean()
            hr_acc = (hr_critic >= 0.5).float().mean()
        return {"discriminator_accuracy": (sr_acc + hr_acc) / 2.0,
                "SR_accuracy": sr_acc, "HR_accuracy": hr_acc}

    def get_labels(self, sr_critic, hr_critic, generator=None):
        """Target labels, smoothed when asked, drawn on the CPU from
        ``generator`` and moved to the critics' device; under data
        parallelism each rank's slice of one draw over the global batch."""
        if not self._label_smoothing:
            return torch.zeros_like(sr_critic), torch.ones_like(hr_critic)
        noise_hr = global_rand(hr_critic.shape, generator) * 0.5
        noise_sr = global_rand(sr_critic.shape, generator) * self._smoothing_offset
        sr_labels = noise_sr.to(sr_critic.device)
        hr_labels = (1.0 - self._smoothing_offset + noise_hr).to(hr_critic.device)
        return sr_labels, hr_labels

    def calculate_loss(self, sr_critic, hr_critic, generator=None):
        """Labels, the loss functors summed, and the accuracies ->
        (loss, metrics)."""
        sr_labels, hr_labels = self.get_labels(sr_critic, hr_critic, generator)
        total = 0.0
        metrics = {}
        for fn in self._loss_functions:
            loss, m = fn(sr_critic, hr_critic, sr_labels, hr_labels)
            total = total + loss
            metrics.update(m)
        metrics.update(self.accuracy_metrics(sr_critic, hr_critic))
        return total, metrics

    def formatted_epoch_metrics(self, train=True):
        m = self.epoch_metrics(train).results()
        loss_names = [fn.name for fn in self._loss_functions]
        out = "".join(f"\t{n}: {m.get(n, float('nan')):.5f}\n" for n in loss_names)
        for k, v in m.items():
            if k not in loss_names:
                out += f"\t{k}: {v:.5f}\n"
        return out

    def __str__(self):
        losses = "\n ".join(str(fn) for fn in self._loss_functions)
        return ("Discriminator\n"
                f"relativistic: {self._relativistic}\n"
                f"label smoothing: {self._label_smoothing}\n"
                f"smoothing offset: {self._smoothing_offset}\n"
                f"loss function:\n {losses}\n")

    # ------------------------------------------------------------ factories

    @staticmethod
    def initialize_relativistic(weighted_loss=False, loss_weight=1.0, num_filters=64,
                                alpha=0.2, kernel_size=3, momentum=0.8, initializer=None,
                                input_dims=(96, 96), **kw):
        """Relativistic critic with RaDiscriminatorLoss."""
        return Discriminator(
            loss_function=RaDiscriminatorLoss(weighted=weighted_loss, loss_weight=loss_weight),
            relativistic=True, num_filters=num_filters, alpha=alpha, kernel_size=kernel_size,
            momentum=momentum, initializer=initializer, input_dims=input_dims, **kw)

    @staticmethod
    def initialize_standard(weighted_loss=False, loss_weight=1.0, label_smoothing=False,
                            smoothing_offset=0.0, num_filters=64, alpha=0.2, kernel_size=3,
                            momentum=0.8, initializer=None, input_dims=(96, 96), **kw):
        """Standard critic with DiscriminatorLoss."""
        return Discriminator(
            loss_function=DiscriminatorLoss(weighted=weighted_loss, loss_weight=loss_weight),
            relativistic=False, label_smoothing=label_smoothing,
            smoothing_offset=smoothing_offset, num_filters=num_filters, alpha=alpha,
            kernel_size=kernel_size, momentum=momentum, initializer=initializer,
            input_dims=input_dims, **kw)

    @staticmethod
    def from_yaml(config_yaml, device="cuda"):
        """The discriminator of a YAML config (a path or its loaded dict),
        its ``model.discriminator`` section with the loss functors built by
        name and summed."""
        from simplesr_tpu_torch.config import yaml_helper

        conf = yaml_helper.load_yaml(config_yaml)
        disc_conf = dict(conf["model"]["discriminator"])
        disc_conf["loss_function"] = yaml_helper.init_loss_functions_from_yaml(disc_conf)
        disc_conf.pop("loss_functions", None)
        return Discriminator(**disc_conf, device=device)
