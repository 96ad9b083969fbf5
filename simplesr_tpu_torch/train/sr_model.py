"""SRModel, the training state machine, as simplesr_tpu.train.sr_model, in
ResNet mode (a generator trained on pixel losses).

The same constructor checks and lifecycle: ``train_step`` (one forward,
loss, backward and optimizer update), ``validation_step``, ``generate``,
``before_epoch``, ``after_train_batch``, ``after_validation_batch``,
``after_epoch`` (saves the whole model every epoch, tracks the running best
of ``early_stop_metric``, saves a checkpoint on a new best, stops early after
``early_stop_patience`` and restores the best checkpoint) and
``after_training`` (restores the best checkpoint and saves the ``_best``
model), with the same batch and epoch history keys. ``skip_nonfinite_updates``
(on by default) drops a step whose gradients are not finite, as
``optax.apply_if_finite(max_consecutive_errors=100)`` does.

Model files, written by ``save_model``, are the format that both packages
read and write (``train/serialization.py``). The best-state checkpoints that
``after_epoch`` writes and ``after_training`` and early stopping restore are
the port's own: one ``torch.save`` file per step under
``checkpoint_dir/resnet/``, the newest 5 kept, each holding the parameters
and buffers, the optimizer state, the step and the best metric. Orbax (the
JAX package's checkpoints) cannot read them, nor they orbax's.

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP.md
item: the GAN mode, distillation and the warm start from a ResNet
checkpoint; meshes, FSDP, tensor and pipeline parallelism; the paired trunk;
EMA and gradient accumulation; TensorBoard writers; resume.
"""

import os
import re

import numpy as np
import torch

from simplesr_tpu_torch.core.device import resolve_device
from simplesr_tpu_torch.ops import metrics as image_metrics_lib
from simplesr_tpu_torch.train import serialization
from simplesr_tpu_torch.train.early_stopping import EarlyStopping
from simplesr_tpu_torch.train.metrics import MetricBundle
from simplesr_tpu_torch.train.optimizers import SkipNonFinite, build_optimizer

_KEEP_CHECKPOINTS = 5
_CHECKPOINT = re.compile(r"step_(\d+)\.pt")

_GAN = "ROADMAP.md, Queue 1, the GAN family"
_PARALLEL = "ROADMAP.md, Queue 1, the parallel layer"
_PAIRED = "ROADMAP.md, Queue 1, paired_train"
_EMA_ACCUM = "ROADMAP.md, Queue 1, EMA and gradient accumulation"
_LOOP = "ROADMAP.md, Queue 1, the data pipeline, config and the training loop"


def _not_ported(what, item):
    return NotImplementedError(f"{what} is not ported yet: {item}")


class SRModel:
    def __init__(self,
                 model_type,
                 generator,
                 generator_optimizer="Adam",
                 generator_optimizer_config=None,
                 discriminator=None,
                 discriminator_optimizer=None,
                 discriminator_optimizer_config=None,
                 image_metrics=None,
                 early_stop_metric="psnr",
                 early_stop_patience=100,
                 epoch_train_summary_writer=None,
                 batch_train_summary_writer=None,
                 epoch_validation_summary_writer=None,
                 batch_validation_summary_writer=None,
                 resnet_checkpoint=None,
                 config=None,
                 seed=0,
                 mesh=None,
                 skip_nonfinite_updates=True,
                 tb_batch_interval=50,
                 ema_decay=None,
                 ema_eval=False,
                 grad_accum_steps=None,
                 fsdp=False,
                 distill=None,
                 async_checkpointing=True,
                 tensor_parallel=False,
                 pipeline_parallel=False,
                 pipeline_microbatches=None,
                 paired_ways=None,
                 device="cuda"):
        """``seed`` (the GAN mode's noise), ``tb_batch_interval`` (writers),
        ``async_checkpointing`` (checkpoints are written at once) and
        ``pipeline_microbatches`` are accepted as the JAX package takes them
        and change nothing in ResNet mode. The generator's module moves to
        ``device``."""
        if model_type.lower() not in ("gan", "resnet"):
            raise ValueError("model type not recognized")
        if generator is None:
            raise ValueError("no generator was supplied")
        if generator_optimizer is None and resnet_checkpoint is None:
            raise ValueError("no generator optimizer was supplied")
        if model_type.lower() == "gan" and discriminator is None:
            raise ValueError("model type is GAN but no discriminator supplied")
        if model_type.lower() == "gan" and discriminator_optimizer is None:
            raise ValueError("model type is GAN but no discriminator optimizer supplied")
        if model_type.lower() == "resnet" and discriminator is not None:
            raise ValueError("model type is Resnet but discriminator was supplied")
        if grad_accum_steps is not None and int(grad_accum_steps) < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
        if ema_decay is not None and not 0.0 < float(ema_decay) < 1.0:
            raise ValueError(f"ema_decay must be in (0, 1), got {ema_decay}")
        if ema_eval and ema_decay is None:
            raise ValueError("ema_eval=True requires ema_decay")
        if fsdp and mesh is None:
            raise ValueError("fsdp=True requires a device mesh (mesh=...)")
        unported = [
            (model_type.lower() == "gan", "model_type='gan'", _GAN),
            (distill is not None, "distillation", _GAN),
            (resnet_checkpoint is not None, "the warm start from a resnet_checkpoint", _GAN),
            (mesh is not None, "training on a mesh", _PARALLEL),
            (tensor_parallel, "tensor_parallel", _PARALLEL),
            (pipeline_parallel, "pipeline_parallel", _PARALLEL),
            (paired_ways is not None and int(paired_ways) > 1, "paired_ways > 1", _PAIRED),
            (ema_decay is not None, "ema_decay", _EMA_ACCUM),
            (grad_accum_steps is not None and int(grad_accum_steps) > 1,
             "grad_accum_steps > 1", _EMA_ACCUM),
            (any(w is not None for w in (epoch_train_summary_writer, batch_train_summary_writer,
                                         epoch_validation_summary_writer,
                                         batch_validation_summary_writer)),
             "TensorBoard summary writers", _LOOP),
        ]
        for unsupported, what, item in unported:
            if unsupported:
                raise _not_ported(what, item)

        self._model_type = model_type.lower()
        self._epochs = 0
        self._iterations = 0
        self._model_dir = "./models"
        self._checkpoint_dir = "./checkpoints"
        if config is not None:
            if getattr(config, "model_dir", None):
                self._model_dir = config.model_dir
            if getattr(config, "checkpoint_dir", None):
                self._checkpoint_dir = config.checkpoint_dir

        self._device = resolve_device(device)
        self._generator = generator.to(self._device)
        self._params = list(generator.model().parameters())
        self._optimizer = build_optimizer(generator_optimizer, generator_optimizer_config)
        if skip_nonfinite_updates:
            self._optimizer = SkipNonFinite(self._optimizer, max_consecutive_errors=100)
        self._step = 0
        self._best_metric = -1.0
        self._ckpt_dir = os.path.abspath(os.path.join(self._checkpoint_dir, self._model_type))

        self._image_metrics = image_metrics if image_metrics is not None else \
            dict(psnr=image_metrics_lib.psnr)
        # early stopping tracks a metric that must be computed: add it when
        # it is one of the built-in image metrics
        if early_stop_metric not in self._image_metrics and \
                hasattr(image_metrics_lib, early_stop_metric):
            self._image_metrics[early_stop_metric] = getattr(image_metrics_lib,
                                                             early_stop_metric)
        names = list(self._image_metrics)
        self._train_epoch_metrics = MetricBundle(names)
        self._valid_epoch_metrics = MetricBundle(names)
        self._batch_metrics = MetricBundle(names)

        self._train_batch_history = {}
        self._train_epoch_history = {}
        self._valid_batch_history = {}
        self._valid_epoch_history = {}

        self._early_stop_metric = early_stop_metric
        self._early_stop_patience = early_stop_patience
        self._early_stopping_util = EarlyStopping(metric_key=early_stop_metric,
                                                  patience=early_stop_patience)

    # ========================================================== public steps

    def _batch(self, x):
        return torch.as_tensor(x, dtype=torch.float32).to(self._device)

    def _image_metric_values(self, hr, sr):
        return {k: fn(hr, sr).mean() for k, fn in self._image_metrics.items()}

    def train_step(self, lr_batch, hr_batch):
        """One optimisation step: forward, loss, backward and update."""
        lr, hr = self._batch(lr_batch), self._batch(hr_batch)
        module = self._generator.model()
        module.train()
        sr = module(lr).float()
        loss, g_metrics = self._generator.calculate_loss(sr, hr, None, None)
        grads = torch.autograd.grad(loss, self._params)
        self._optimizer.apply(self._params, grads)
        self._step += 1
        sr = sr.detach()
        self._generator.accumulate_metrics({k: v.detach() for k, v in g_metrics.items()},
                                           train=True)
        for k, v in self._image_metric_values(hr, sr).items():
            self._train_epoch_metrics.ensure(k)(v)
            self._batch_metrics.ensure(k)(v)

    def validation_step(self, lr_batch, hr_batch):
        """One validation pass, in eval mode."""
        lr, hr = self._batch(lr_batch), self._batch(hr_batch)
        module = self._generator.model()
        module.eval()
        with torch.no_grad():
            sr = module(lr).float()
            _, g_metrics = self._generator.calculate_loss(sr, hr, None, None)
            img = self._image_metric_values(hr, sr)
        self._generator.accumulate_metrics(g_metrics, train=False)
        for k, v in img.items():
            self._valid_epoch_metrics.ensure(k)(v)
            self._batch_metrics.ensure(k)(v)

    def generate(self, lr_batch, ema=False):
        """SR with the current generator parameters, in eval mode."""
        if ema:
            raise _not_ported("EMA weights", _EMA_ACCUM)
        return self._generator.generate(lr_batch)

    # ============================================================ lifecycle

    def before_epoch(self):
        self._reset_epoch_metrics()
        self._epochs += 1

    def after_train_batch(self):
        """Record the batch's metrics (as tensors, read when needed) and
        reset them."""
        self._iterations += 1
        self._update_history(self._combined_batch_metrics(), self._train_batch_history)
        self._reset_batch_metrics()

    def after_validation_batch(self):
        self._update_history(self._combined_batch_metrics(), self._valid_batch_history)
        self._reset_batch_metrics()

    def after_epoch(self):
        """Save the model, record the epoch's metrics, track the best metric,
        maybe stop early (restoring the best checkpoint), and checkpoint on a
        new best."""
        self.save_model(self._model_dir)
        self._update_epoch_history()

        tracked = self._valid_epoch_metrics.ensure(self._early_stop_metric).result()
        if np.isnan(tracked):  # no validation data: the training metric
            tracked = self._train_epoch_metrics.ensure(self._early_stop_metric).result()
        # the running best: the value the best checkpoint was saved at
        if not np.isnan(tracked) and float(tracked) > self._best_metric:
            self._best_metric = float(np.float32(tracked))  # kept in float32, as JAX keeps it

        if self._check_early_stopping():
            self._restore_latest_checkpoint()

        if self._early_stopping_util.num_epochs_after_best() == 0:
            self._save_checkpoint()

    def after_training(self):
        """Restore the best checkpoint and save the ``_best`` model."""
        self._restore_latest_checkpoint()
        self.save_model(self._model_dir, postfix="best")
        self._reset_epoch_metrics()

    def save_model(self, save_path, postfix=None, ema=False):
        """Save the generator as a model file,
        ``<save_path>/<model type>_gen_<postfix>.msgpack`` (the epoch count
        by default). Returns the path."""
        if ema:
            raise _not_ported("EMA weights", _EMA_ACCUM)
        if postfix is None:
            postfix = self._epochs
        path = os.path.join(save_path,
                            f"{self._model_type}_gen_{postfix}{serialization.MODEL_EXT}")
        serialization.save_model(self._generator.module_config(), self._generator.variables,
                                 path)
        return path

    def resume_training(self):
        raise _not_ported("resume_training", _LOOP)

    def save_resume_point(self):
        raise _not_ported("save_resume_point", _LOOP)

    # ========================================================= checkpointing

    def _checkpoint_steps(self):
        if not os.path.isdir(self._ckpt_dir):
            return []
        return sorted(int(m.group(1)) for m in map(_CHECKPOINT.fullmatch,
                                                   os.listdir(self._ckpt_dir)) if m)

    def _save_checkpoint(self):
        os.makedirs(self._ckpt_dir, exist_ok=True)
        state = {
            "step": self._step,
            "best_metric": self._best_metric,
            "params": {k: v.detach().cpu().clone()
                       for k, v in self._generator.model().state_dict().items()},
            "optimizer": _to_cpu(self._optimizer.state_dict()),
        }
        path = os.path.join(self._ckpt_dir, f"step_{self._step}.pt")
        tmp = f"{path}.tmp{os.getpid()}"
        torch.save(state, tmp)
        os.replace(tmp, path)  # readers never see a partial file
        for step in self._checkpoint_steps()[:-_KEEP_CHECKPOINTS]:
            os.remove(os.path.join(self._ckpt_dir, f"step_{step}.pt"))

    def latest_checkpoint(self):
        """The newest checkpoint's step (None without one) and its path."""
        steps = self._checkpoint_steps()
        if not steps:
            return None, None
        return steps[-1], os.path.join(self._ckpt_dir, f"step_{steps[-1]}.pt")

    def _restore_latest_checkpoint(self):
        step, path = self.latest_checkpoint()
        if step is None:
            return
        state = torch.load(path, map_location=self._device, weights_only=True)
        self._generator.model().load_state_dict(state["params"])
        self._optimizer.load_state_dict(state["optimizer"])
        self._step = int(state["step"])
        self._best_metric = float(state["best_metric"])

    # ============================================================== access

    def iterations(self):
        return self._iterations

    @property
    def step(self):
        """The number of train steps taken (a dropped update counts)."""
        return self._step

    @property
    def best_metric(self):
        return self._best_metric

    def stop_early(self):
        return self._early_stopping_util.stop_early()

    def generator(self):
        """The generator module."""
        return self._generator.model()

    def generator_wrapper(self):
        return self._generator

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def model_type(self):
        return self._model_type

    def histories(self):
        return dict(train_batch=self._train_batch_history,
                    train_epoch=self._train_epoch_history,
                    valid_batch=self._valid_batch_history,
                    valid_epoch=self._valid_epoch_history)

    # ============================================================== metrics

    def _combined_batch_metrics(self):
        out = dict(self._batch_metrics.last_values())
        out.update(self._generator.batch_metrics().last_values())
        return out

    def _combined_epoch_metrics(self, train=True):
        own = self._train_epoch_metrics if train else self._valid_epoch_metrics
        out = dict(own.results())
        out.update(self._generator.epoch_metrics(train).results())
        return out

    def _check_early_stopping(self):
        self._early_stopping_util.evaluate_stop_criterion(
            self._valid_epoch_history.get(self._early_stop_metric)
            or self._train_epoch_history.get(self._early_stop_metric, [float("-inf")]))
        return self.stop_early()

    def _update_epoch_history(self):
        self._update_history(self._combined_epoch_metrics(train=True),
                             self._train_epoch_history)
        self._update_history(self._combined_epoch_metrics(train=False),
                             self._valid_epoch_history)

    @staticmethod
    def _update_history(metrics, history):
        for name, value in metrics.items():
            history.setdefault(name, []).append(value)

    def _reset_epoch_metrics(self):
        self._train_epoch_metrics.reset()
        self._valid_epoch_metrics.reset()
        self._generator.reset_epoch_metrics()

    def _reset_batch_metrics(self):
        self._batch_metrics.reset()
        self._generator.reset_batch_metrics()


def _to_cpu(tree):
    """A copy of a nest of dicts and lists with every tensor on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree
