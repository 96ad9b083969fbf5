"""SRModel, the training state machine, as simplesr_tpu.train.sr_model, in
ResNet mode (a generator trained on pixel losses) and GAN mode (a generator
and a discriminator trained together).

The same constructor checks and lifecycle: ``train_step`` (one forward,
the losses, the gradients and the optimizer updates), ``validation_step``,
``generate``, ``before_epoch``, ``after_train_batch``,
``after_validation_batch``, ``after_epoch`` (saves the whole model every
epoch, tracks the running best of ``early_stop_metric``, saves a checkpoint
on a new best, stops early after ``early_stop_patience`` and restores the
best checkpoint) and ``after_training`` (restores the best checkpoint and
saves the ``_best`` model, and ``_best_ema`` with EMA), with the same batch
and epoch history keys, ``test_and_plot``, the four TensorBoard writers,
``SRModel.init`` from a ConfigUtil, and the preemption-tolerant
``save_resume_point`` and ``resume_training``.
``skip_nonfinite_updates`` (on by default) drops a step whose gradients are
not finite, per optimizer, as ``optax.apply_if_finite(max_consecutive_errors=
100)`` does.

The GAN step is the JAX package's joint step: one generator forward; the
discriminator's gradients from its loss on D(sr) and D(hr), the
generator's from its losses through D(sr) and D(hr) with the
discriminator's parameters as they were before this step; then both
optimizers step. The two branches share one discriminator forward per
input (in training mode, batch statistics; the running statistics move
once for the SR call and once for the HR call, as in the JAX package's
discriminator branch): the discriminator reads a detached copy of sr, its
loss is differentiated against its parameters, the generator's losses
against sr and that copy, and the two are carried back through the
generator together. Validation runs the discriminator in eval mode.

``ema_decay`` keeps an EMA shadow of the generator's parameters,
initialised at them, moved after every step (with ``grad_accum_steps`` > 1,
after every applied update only); ``ema_eval`` validates on it.
``grad_accum_steps`` averages that many micro-gradients into one update of
each optimizer (``optimizers.MultiSteps``, inside the NaN guard, so a
non-finite micro-batch is dropped before the accumulator and does not
count); BatchNorm statistics move on every micro-batch.

Model files, written by ``save_model``, are the format that both packages
read and write (``train/serialization.py``). The best-state checkpoints that
``after_epoch`` writes and ``after_training`` and early stopping restore are
the port's own: one ``torch.save`` file per step under
``checkpoint_dir/<model type>/``, the newest 5 kept, each holding the
generator's parameters and buffers, its optimizer and NaN-guard state, the
EMA shadow, the discriminator's parameters, buffers and optimizer state, the
step, the best metric and the model's random stream. The resume point is one
more such file, the newest only, under ``checkpoint_dir/<model
type>_resume/``, beside the JAX package's JSON sidecar
``checkpoint_dir/<model type>_resume_meta.json`` (completed epochs,
iterations, early-stopping state, epoch histories). ``resnet_checkpoint``
warm-starts the generator from such a directory of a pixel-trained run
(``checkpoint_dir/resnet``): parameters, buffers, step and best metric, and
the optimizer's state when its structure matches. Orbax (the JAX package's
checkpoints) cannot read them, nor they orbax's.

``paired_ways`` (YAML ``paired_train``) is accepted as the JAX package
accepts it: a plain BN-free SRResNet only, ``ways >= 2``, exclusive with
tensor and pipeline parallelism, and a train batch that does not divide by
``paired_ways`` trimmed to the largest multiple (one smaller than it is
skipped). The JAX package then trains on a layout that packs that many batch
items into the channels, an exact rewrite with the standard layout's loss,
gradients and parameters that fills the TPU's 128-wide matrix unit. The port
trains the standard layout, through the C = 64 trunk kernel: the same
function, on a card whose convs tile C = 64 as they are. ``distill`` adds a
frozen teacher's term to the generator's loss (``train/distill.py``), in
training and in validation.

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP.md
item: meshes, FSDP, tensor and pipeline parallelism.
"""

import json
import logging
import os
import re
from pathlib import Path

import numpy as np
import torch

from simplesr_tpu_torch.core.device import resolve_device
from simplesr_tpu_torch.ops import metrics as image_metrics_lib
from simplesr_tpu_torch.train import serialization
from simplesr_tpu_torch.train.early_stopping import EarlyStopping
from simplesr_tpu_torch.train.convert import to_flax_variables
from simplesr_tpu_torch.train.metrics import MetricBundle
from simplesr_tpu_torch.train.optimizers import MultiSteps, SkipNonFinite, build_optimizer

_KEEP_CHECKPOINTS = 5
_CHECKPOINT = re.compile(r"step_(\d+)\.pt")

PARALLEL_ITEM = "ROADMAP.md, Queue 1, the parallel layer"
_VALID_LABEL_SEED = 4711  # the JAX package's validation key, folded with the iteration


def not_ported(what, item):
    return NotImplementedError(f"{what} is not ported yet: {item}")


def _check_paired(module, ways):
    """``ways`` as an int, after the JAX package's guards on paired
    training (``simplesr_tpu/train/paired.py: paired_train_apply``)."""
    from simplesr_tpu_torch.models.srresnet import SRResNet

    if type(module) is not SRResNet:
        raise TypeError(
            f"paired training supports plain SRResNet, got {type(module).__name__}")
    if module.batch_norm:
        raise ValueError(
            "paired training requires batch_norm=False (packed-layout BN "
            "would normalize each stream over batch/ways items — a "
            "different function, not an exact rewrite)")
    ways = int(ways)
    if ways < 2:
        raise ValueError(f"paired ways must be >= 2, got {ways}")
    return ways


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
        """``seed`` roots the model's random stream (the discriminator's
        smoothed labels; checkpointed); ``async_checkpointing`` (the port's
        checkpoints are written at once) and ``pipeline_microbatches`` are
        accepted as the JAX package takes them and change nothing. Batch
        metrics go to the batch writers every ``tb_batch_interval`` steps.
        The generator's and the discriminator's modules move to
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
        if paired_ways is not None and (tensor_parallel or pipeline_parallel):
            raise ValueError(
                "paired_ways is mutually exclusive with tensor_parallel/"
                "pipeline_parallel (they re-lay-out the same trunk)")
        unported = [
            (mesh is not None, "training on a mesh", PARALLEL_ITEM),
            (tensor_parallel, "tensor_parallel", PARALLEL_ITEM),
            (pipeline_parallel, "pipeline_parallel", PARALLEL_ITEM),
        ]
        for unsupported, what, item in unported:
            if unsupported:
                raise not_ported(what, item)

        self._model_type = model_type.lower()
        self.name = model_type
        self._epochs = 0
        self._iterations = 0
        self._in_epoch = False
        self._tb_batch_interval = tb_batch_interval
        self._epoch_train_summary_writer = epoch_train_summary_writer
        self._batch_train_summary_writer = batch_train_summary_writer
        self._epoch_validation_summary_writer = epoch_validation_summary_writer
        self._batch_validation_summary_writer = batch_validation_summary_writer
        self._generator_optimizer_config = generator_optimizer_config
        self._discriminator_optimizer_config = discriminator_optimizer_config
        self._rng = torch.Generator().manual_seed(int(seed))
        self._model_dir = "./models"
        self._checkpoint_dir = "./checkpoints"
        if config is not None:
            if getattr(config, "model_dir", None):
                self._model_dir = config.model_dir
            if getattr(config, "checkpoint_dir", None):
                self._checkpoint_dir = config.checkpoint_dir

        self._device = resolve_device(device)
        self._grad_accum = 1 if grad_accum_steps is None else int(grad_accum_steps)

        def optimizer(name, config):
            opt = build_optimizer(name, config)
            if self._grad_accum > 1:
                opt = MultiSteps(opt, self._grad_accum)
            # outside the accumulator: a non-finite micro-batch never reaches it
            return SkipNonFinite(opt, max_consecutive_errors=100) if skip_nonfinite_updates \
                else opt

        self._generator = generator.to(self._device)
        self._param_names, self._params = map(list, zip(*generator.model().named_parameters()))
        self._optimizer = optimizer(generator_optimizer, generator_optimizer_config)
        self._discriminator = None
        self._d_optimizer = None
        if self._model_type == "gan":
            self._discriminator = discriminator.to(self._device)
            self._d_params = list(discriminator.model().parameters())
            self._d_optimizer = optimizer(discriminator_optimizer, discriminator_optimizer_config)
        self._paired_ways = 1 if paired_ways is None else \
            _check_paired(generator.model(), paired_ways)
        self._distill = None
        if distill is not None:
            from simplesr_tpu_torch.train.distill import build_distiller
            self._distill = build_distiller(
                distill, student_upsample_factor=generator.module_config().get(
                    "upsample_factor"), device=self._device)
        self._ema_decay = None if ema_decay is None else float(ema_decay)
        self._ema_eval = bool(ema_eval)
        self._ema = self._fresh_ema()
        self._step = 0
        self._best_metric = -1.0
        self._ckpt_dir = os.path.abspath(os.path.join(self._checkpoint_dir, self._model_type))
        self._resume_dir = self._ckpt_dir + "_resume"
        self._last_resume_step = None

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
        if resnet_checkpoint is not None:
            self._restore_resnet_checkpoint(resnet_checkpoint)

    def _fresh_ema(self):
        """The EMA shadow at the generator's parameters (None without EMA)."""
        if self._ema_decay is None:
            return None
        return [p.detach().clone() for p in self._params]

    # ========================================================== public steps

    def _batch(self, x):
        return torch.as_tensor(x, dtype=torch.float32).to(self._device)

    def _image_metric_values(self, hr, sr):
        return {k: fn(hr, sr).mean() for k, fn in self._image_metrics.items()}

    def _fit_train_batch(self, lr_batch, hr_batch):
        """The train batch trimmed to the largest multiple of
        ``paired_ways`` (None, None when it is smaller), as the JAX
        package's ``_fit_batch_to_mesh`` trims it."""
        n, b = self._paired_ways, lr_batch.shape[0]
        if b % n == 0:
            return lr_batch, hr_batch
        keep = (b // n) * n
        if keep == 0:
            logging.getLogger("simple_sr").warning(
                "skipping batch of %d: smaller than the required multiple "
                "of %d (data mesh x paired ways)", b, n)
            return None, None
        logging.getLogger("simple_sr").warning(
            "trimming uneven batch %d -> %d to a multiple of %d "
            "(enable DataPipeline(drop_remainder=True) to avoid this)", b, keep, n)
        return lr_batch[:keep], hr_batch[:keep]

    def _add_distillation(self, loss, g_metrics, sr, lr):
        """The generator's loss with the teacher's term added, and its
        metrics (``generator_loss`` overwritten), as the JAX package adds
        them."""
        term, metrics = self._distill.loss_terms(sr, lr)
        loss = loss + term
        g_metrics.update(metrics)
        g_metrics["generator_loss"] = loss
        return loss

    def train_step(self, lr_batch, hr_batch):
        """One optimisation step: forward, losses, gradients and updates."""
        lr_batch, hr_batch = self._fit_train_batch(lr_batch, hr_batch)
        if lr_batch is None:
            return
        lr, hr = self._batch(lr_batch), self._batch(hr_batch)
        module = self._generator.model()
        module.train()
        sr = module(lr).float()
        d_metrics = None
        if self._model_type == "gan":
            g_grads, d_grads, g_metrics, d_metrics = self._gan_gradients(sr, hr, lr)
        else:
            loss, g_metrics = self._generator.calculate_loss(sr, hr, None, None)
            if self._distill is not None:
                loss = self._add_distillation(loss, g_metrics, sr, lr)
            g_grads = torch.autograd.grad(loss, self._params)
        updates = self._optimizer.count
        self._optimizer.apply(self._params, g_grads)
        if d_metrics is not None:
            self._d_optimizer.apply(self._d_params, d_grads)
        # as the JAX package: without accumulation the shadow moves every
        # step; with it, only when an update was applied
        if self._ema is not None and (self._grad_accum == 1
                                      or self._optimizer.count != updates):
            self._advance_ema()
        self._step += 1
        sr = sr.detach()
        self._generator.accumulate_metrics({k: v.detach() for k, v in g_metrics.items()},
                                           train=True)
        if d_metrics is not None:
            self._discriminator.accumulate_metrics(
                {k: v.detach() for k, v in d_metrics.items()}, train=True)
        for k, v in self._image_metric_values(hr, sr).items():
            self._train_epoch_metrics.ensure(k)(v)
            self._batch_metrics.ensure(k)(v)

    def _gan_losses(self, sr, hr, lr):
        """The joint step's losses on one discriminator forward per input
        (in training mode), the SR one on a detached copy ``sr_in`` of sr,
        and the teacher's term with ``distill``:
        (sr_in, d_loss, g_loss, g_metrics, d_metrics)."""
        disc = self._discriminator.model()
        disc.train()
        sr_in = sr.detach().requires_grad_(True)
        sr_critic, hr_critic = disc(sr_in), disc(hr)
        d_loss, d_metrics = self._discriminator.calculate_loss(sr_critic, hr_critic, self._rng)
        g_loss, g_metrics = self._generator.calculate_loss(sr, hr, sr_critic, hr_critic)
        if self._distill is not None:
            g_loss = self._add_distillation(g_loss, g_metrics, sr, lr)
        return sr_in, d_loss, g_loss, g_metrics, d_metrics

    def _gan_gradients(self, sr, hr, lr):
        """The joint step's gradients: the discriminator's of its loss, the
        generator's of its losses through the discriminator as it is now:
        their gradient at sr directly and through sr_in, carried back through
        the generator together."""
        sr_in, d_loss, g_loss, g_metrics, d_metrics = self._gan_losses(sr, hr, lr)
        d_grads = torch.autograd.grad(d_loss, self._d_params, retain_graph=True)
        direct, through_d = torch.autograd.grad(g_loss, [sr, sr_in], allow_unused=True)
        sr_grad = direct if through_d is None else \
            through_d if direct is None else direct + through_d
        g_grads = torch.autograd.grad(sr, self._params, sr_grad, allow_unused=True)
        g_grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self._params, g_grads)]
        return g_grads, d_grads, g_metrics, d_metrics

    @torch.no_grad()
    def _advance_ema(self):
        """shadow = decay * shadow + (1 - decay) * parameters, in float32."""
        torch._foreach_mul_(self._ema, self._ema_decay)
        torch._foreach_add_(self._ema, torch._foreach_mul(self._params, 1.0 - self._ema_decay))

    def _ema_parameters(self):
        if self._ema is None:
            raise ValueError("EMA weights requested but the model was built without ema_decay")
        return dict(zip(self._param_names, self._ema))

    def _eval_forward(self, x, ema):
        """The generator in eval mode on ``x``, with its parameters or the
        EMA shadow."""
        module = self._generator.model()
        module.eval()
        if not ema:
            return module(x)
        return torch.func.functional_call(module, self._ema_parameters(), (x,))

    def validation_step(self, lr_batch, hr_batch):
        """One validation pass, in eval mode (on the EMA shadow with
        ``ema_eval``)."""
        lr, hr = self._batch(lr_batch), self._batch(hr_batch)
        d_metrics = None
        with torch.no_grad():
            sr = self._eval_forward(lr, self._ema_eval).float()
            sr_critic = hr_critic = None
            if self._model_type == "gan":
                disc = self._discriminator.model()
                disc.eval()
                sr_critic, hr_critic = disc(sr), disc(hr)
                labels = torch.Generator().manual_seed(
                    _VALID_LABEL_SEED * 1_000_003 + self._iterations)
                _, d_metrics = self._discriminator.calculate_loss(sr_critic, hr_critic, labels)
            g_loss, g_metrics = self._generator.calculate_loss(sr, hr, sr_critic, hr_critic)
            if self._distill is not None:
                self._add_distillation(g_loss, g_metrics, sr, lr)
            img = self._image_metric_values(hr, sr)
        self._generator.accumulate_metrics(g_metrics, train=False)
        if d_metrics is not None:
            self._discriminator.accumulate_metrics(d_metrics, train=False)
        for k, v in img.items():
            self._valid_epoch_metrics.ensure(k)(v)
            self._batch_metrics.ensure(k)(v)

    def generate(self, lr_batch, ema=False):
        """SR with the current generator parameters (or, ``ema=True``, the
        EMA shadow), in eval mode."""
        if not ema:
            return self._generator.generate(lr_batch)
        x = torch.as_tensor(lr_batch, dtype=torch.float32).to(self._device)
        with torch.inference_mode():
            return self._eval_forward(x, ema=True)

    def test_and_plot(self, lr_batch, save_dir, step, hr_batch=None, file_path=None):
        """SR a batch and save an annotated grid of it, its bicubic
        upscale and (given) the ground truth."""
        from simplesr_tpu_torch.eval import rendering
        from simplesr_tpu_torch.ops.resize import resize

        sr_batch = self.generate(lr_batch)
        fname = f"{str(self._epochs).zfill(5)}_{str(step).zfill(3)}"
        lr = torch.as_tensor(lr_batch, dtype=torch.float32)
        kwargs = {
            self._model_type: sr_batch,
            "bicubic": resize(lr, (sr_batch.shape[1], sr_batch.shape[2]), method="bicubic"),
        }
        if hr_batch is not None:
            kwargs["ground truth"] = hr_batch
        save_dir = os.path.join(save_dir, self._model_type)
        if file_path is not None:
            fp = file_path[0] if isinstance(file_path, (list, tuple)) else file_path
            save_dir = os.path.join(save_dir, Path(str(fp)).parent.stem)
        rendering.prepare_image_grid(save_dir=save_dir, fname=fname, original=None, psnr=None,
                                     low_res_key=None, **kwargs)

    # ============================================================ lifecycle

    def before_epoch(self):
        self._reset_epoch_metrics()
        self._epochs += 1
        self._in_epoch = True

    def _tb_due(self, writer):
        return writer is not None and self._tb_batch_interval and \
            self._iterations % self._tb_batch_interval == 0

    def after_train_batch(self):
        """Record the batch's metrics (as tensors, read when needed), write
        them to TensorBoard every ``tb_batch_interval`` steps, and reset
        them."""
        self._iterations += 1
        if self._tb_due(self._batch_train_summary_writer):
            self._log_batch_metrics_to_tb(train=True)
        self._update_history(self._combined_batch_metrics(), self._train_batch_history)
        self._reset_batch_metrics()

    def after_validation_batch(self):
        if self._tb_due(self._batch_validation_summary_writer):
            self._log_batch_metrics_to_tb(train=False)
        self._update_history(self._combined_batch_metrics(), self._valid_batch_history)
        self._reset_batch_metrics()

    def after_epoch(self):
        """Save the model, record the epoch's metrics, track the best metric,
        maybe stop early (restoring the best checkpoint), checkpoint on a new
        best, and write the resume point."""
        self.save_model(self._model_dir)
        self._log_epoch_metrics_to_tb(train=True)
        self._log_epoch_metrics_to_tb(train=False)
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

        # the newest state (not the best): an interrupted run resumes here
        self._in_epoch = False
        self._save_resume_point(self._epochs)

    def after_training(self):
        """Restore the best checkpoint and save the ``_best`` model, and the
        ``_best_ema`` one with EMA."""
        self._restore_latest_checkpoint()
        self.save_model(self._model_dir, postfix="best")
        if self._ema is not None:
            self.save_model(self._model_dir, postfix="best_ema", ema=True)
        self._reset_epoch_metrics()

    def save_model(self, save_path, postfix=None, ema=False):
        """Save the generator (``ema=True``: with the EMA shadow for its
        parameters) as a model file,
        ``<save_path>/<model type>_gen_<postfix>.msgpack`` (the epoch count
        by default). Returns the path."""
        if postfix is None:
            postfix = self._epochs
        module = self._generator.model()
        state = module.state_dict()
        if ema:
            state.update(self._ema_parameters())
        path = os.path.join(save_path,
                            f"{self._model_type}_gen_{postfix}{serialization.MODEL_EXT}")
        serialization.save_model(self._generator.module_config(),
                                 to_flax_variables(state), path)
        return path

    # ================================================ preemption and resume

    def _resume_meta_path(self):
        return os.path.join(self._checkpoint_dir, f"{self._model_type}_resume_meta.json")

    def _save_resume_point(self, completed_epochs):
        """The newest state (when the step moved since the last one) and the
        JSON sidecar with what the state does not hold."""
        if self._step != self._last_resume_step:
            self._save_checkpoint(self._resume_dir, keep=1)
            self._last_resume_step = self._step
        self._write_resume_meta(completed_epochs)

    def save_resume_point(self):
        """Checkpoint the current state for a preempted run. Called inside
        an epoch, it records the last completed epoch: on resume the
        interrupted epoch runs again from the preempted state."""
        completed = self._epochs - 1 if self._in_epoch else self._epochs
        self._save_resume_point(max(completed, 0))

    def _write_resume_meta(self, completed_epochs):
        def _floats(history):
            return {k: [float(v) for v in vs] for k, vs in history.items()}

        meta = {
            "completed_epochs": int(completed_epochs),
            "iterations": int(self._iterations),
            "model_type": self._model_type,
            "early_stop": self._early_stopping_util.state_dict(),
            "train_epoch_history": _floats(self._train_epoch_history),
            "valid_epoch_history": _floats(self._valid_epoch_history),
        }
        path = self._resume_meta_path()
        tmp = f"{path}.tmp{os.getpid()}"
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, path)  # readers never see a partial file

    def _read_resume_meta(self):
        try:
            with open(self._resume_meta_path()) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def resume_training(self):
        """Resume an interrupted run: restore the newest state (the resume
        point, or the best checkpoint when it is newer) and, from the
        sidecar, the epoch counter, iterations, early-stopping state and
        epoch histories. Returns the number of completed epochs, or None
        when there is nothing to resume."""
        resume_step, resume_path = self._latest(self._resume_dir)
        best_step, best_path = self._latest(self._ckpt_dir)
        if resume_step is None and best_step is None:
            return None
        if resume_step is not None and (best_step is None or resume_step >= best_step):
            self._restore(resume_path)
        else:
            self._restore(best_path)
        self._iterations = self._step
        self._last_resume_step = self._step

        meta = self._read_resume_meta()
        if meta is None:
            logging.getLogger("simple_sr").warning(
                "resume: checkpoint restored but no resume meta found - epoch counters and "
                "early-stop state start fresh (the restored weights act as a warm start)")
            return 0
        self._epochs = int(meta["completed_epochs"])
        self._iterations = int(meta.get("iterations", self._iterations))
        self._early_stopping_util.load_state_dict(meta["early_stop"])
        self._train_epoch_history = {k: list(v) for k, v in meta["train_epoch_history"].items()}
        self._valid_epoch_history = {k: list(v) for k, v in meta["valid_epoch_history"].items()}
        return self._epochs

    # ========================================================= checkpointing

    @staticmethod
    def _checkpoint_steps(directory):
        if not os.path.isdir(directory):
            return []
        return sorted(int(m.group(1)) for m in map(_CHECKPOINT.fullmatch,
                                                   os.listdir(directory)) if m)

    def _save_checkpoint(self, directory=None, keep=_KEEP_CHECKPOINTS):
        """Write the state as ``<directory>/step_<step>.pt`` (the best-state
        directory by default) and keep the newest ``keep``."""
        directory = directory or self._ckpt_dir
        os.makedirs(directory, exist_ok=True)
        state = {
            "step": self._step,
            "best_metric": self._best_metric,
            "params": _to_cpu(self._generator.model().state_dict()),
            "optimizer": _to_cpu(self._optimizer.state_dict()),
            "optimizer_structure": self._optimizer.structure(),
            "ema": _to_cpu(self._ema),
            "rng": self._rng.get_state(),
        }
        if self._model_type == "gan":
            state["d_params"] = _to_cpu(self._discriminator.model().state_dict())
            state["d_optimizer"] = _to_cpu(self._d_optimizer.state_dict())
        path = os.path.join(directory, f"step_{self._step}.pt")
        tmp = f"{path}.tmp{os.getpid()}"
        torch.save(state, tmp)
        os.replace(tmp, path)  # readers never see a partial file
        for step in self._checkpoint_steps(directory)[:-keep]:
            os.remove(os.path.join(directory, f"step_{step}.pt"))

    def _latest(self, directory):
        steps = self._checkpoint_steps(directory)
        if not steps:
            return None, None
        return steps[-1], os.path.join(directory, f"step_{steps[-1]}.pt")

    def latest_checkpoint(self):
        """The newest best-state checkpoint's step (None without one) and
        its path."""
        return self._latest(self._ckpt_dir)

    def _restore(self, path):
        state = torch.load(path, map_location=self._device, weights_only=True)
        self._generator.model().load_state_dict(state["params"])
        self._optimizer.load_state_dict(state["optimizer"])
        self._step = int(state["step"])
        self._best_metric = float(state["best_metric"])
        self._rng.set_state(state["rng"].cpu())
        if self._ema is not None:
            self._ema = [t.clone() for t in state["ema"]]
        if self._model_type == "gan":
            self._discriminator.model().load_state_dict(state["d_params"])
            self._d_optimizer.load_state_dict(state["d_optimizer"])

    def _restore_resnet_checkpoint(self, checkpoint_dir):
        """Warm-start the generator from the newest checkpoint of a
        pixel-trained run's directory (``checkpoint_dir/resnet``):
        parameters, buffers, step and best metric; the optimizer's state
        only when this run's optimizer has its structure and both runs keep
        an EMA shadow or neither does (else a warning, and the optimizer
        starts fresh, as in the JAX package). The EMA shadow starts at the
        restored parameters."""
        directory = os.path.abspath(checkpoint_dir)
        entries = os.listdir(directory) if os.path.isdir(directory) else []
        if any(e.isdigit() or e.startswith("_CHECKPOINT_METADATA") for e in entries):
            raise ValueError(
                f"{checkpoint_dir} holds orbax checkpoints (the JAX package's format); the port "
                "reads only its own torch.save checkpoints, step_<n>.pt")
        step, path = self._latest(directory)
        if step is None:
            raise ValueError(f"no checkpoint found in {checkpoint_dir}")
        state = torch.load(path, map_location=self._device, weights_only=True)
        self._generator.model().load_state_dict(state["params"])
        # the JAX package restores the whole state against one template, so
        # its optimizer state also stays behind when EMA is on in one run only
        if state.get("optimizer_structure") == self._optimizer.structure() and \
                (state.get("ema") is None) == (self._ema is None):
            self._optimizer.load_state_dict(state["optimizer"])
        else:
            logging.getLogger("simple_sr").warning(
                "resnet checkpoint optimizer state does not match this run's optimizer; "
                "warm-starting params only")
        self._step = int(state["step"])
        self._best_metric = float(state["best_metric"])
        self._ema = self._fresh_ema()

    def _restore_latest_checkpoint(self):
        step, path = self.latest_checkpoint()
        if step is not None:
            self._restore(path)

    # ============================================================== access

    def iterations(self):
        return self._iterations

    @property
    def device(self):
        return self._device

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

    def discriminator_wrapper(self):
        return self._discriminator

    @property
    def discriminator_optimizer(self):
        return self._d_optimizer

    @property
    def ema_parameters(self):
        """The EMA shadow, in the generator's parameter order (None without
        EMA)."""
        return self._ema

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

    def _combined_batch_metrics(self, lazy=True):
        """The batch's metrics: as given (tensors, no device sync), or as
        floats (``lazy=False``)."""
        parts = [self._batch_metrics, self._generator.batch_metrics()]
        if self._discriminator is not None:
            parts.append(self._discriminator.batch_metrics())
        out = {}
        for part in parts:
            out.update(part.last_values() if lazy else part.results())
        return out

    def _log_batch_metrics_to_tb(self, train=True):
        writer = self._batch_train_summary_writer if train else \
            self._batch_validation_summary_writer
        if writer is None:
            return
        for name, value in self._combined_batch_metrics(lazy=False).items():
            writer.add_scalar(f"{name}_batch", value, self._iterations)

    def _log_epoch_metrics_to_tb(self, train=True):
        writer = self._epoch_train_summary_writer if train else \
            self._epoch_validation_summary_writer
        if writer is None:
            return
        for name, value in self._combined_epoch_metrics(train).items():
            writer.add_scalar(name, value, self._epochs)

    def _combined_epoch_metrics(self, train=True):
        own = self._train_epoch_metrics if train else self._valid_epoch_metrics
        out = dict(own.results())
        out.update(self._generator.epoch_metrics(train).results())
        if self._discriminator is not None:
            out.update(self._discriminator.epoch_metrics(train).results())
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
        if self._discriminator is not None:
            self._discriminator.reset_epoch_metrics()

    def _reset_batch_metrics(self):
        self._batch_metrics.reset()
        self._generator.reset_batch_metrics()
        if self._discriminator is not None:
            self._discriminator.reset_batch_metrics()

    def formatted_epoch_metrics(self):
        return self._format_metrics(True, "Training") + self._format_metrics(False, "Validation")

    def _format_metrics(self, train, header):
        own = self._train_epoch_metrics if train else self._valid_epoch_metrics
        img = "".join(f"{k}: {v:.5f}\n" for k, v in own.results().items())
        gen = self._generator.formatted_epoch_metrics(train=train)
        out = f"{header}\n{img}Generator\n{gen}"
        if self._discriminator is not None:
            out += "Discriminator\n" + self._discriminator.formatted_epoch_metrics(train=train)
        return out

    def __str__(self):
        return (f"# SR Model\n"
                f"model type: {self._model_type}\n"
                f"generator optimizer config: {self._generator_optimizer_config}\n"
                f"discriminator optimizer config: {self._discriminator_optimizer_config}\n"
                f"image metrics: {list(self._image_metrics)}\n"
                f"early stop metric: {self._early_stop_metric}\n"
                f"early stop patience: {self._early_stop_patience}\n\n"
                f"{self._generator}\n{self._discriminator}")

    # ============================================================== factory

    @staticmethod
    def init(config, generator, generator_optimizer, generator_optimizer_config=None,
             discriminator=None, discriminator_optimizer=None,
             discriminator_optimizer_config=None, image_metrics=None, device="cuda"):
        """The model of a ConfigUtil: its type from the discriminator, its
        early stopping, writers and directories, ``paired_train`` and
        ``distill`` from the config. What the port has not ported raises
        ``NotImplementedError`` with its ROADMAP.md item: more than one
        device under ``data_parallel``, ``fsdp``, ``tensor_parallel`` and
        ``pipeline_parallel``."""
        device = resolve_device(device)
        tp = int(getattr(config, "tensor_parallel", 0) or 0)
        pp = int(getattr(config, "pipeline_parallel", 0) or 0)
        if tp > 1 and pp > 1:
            raise ValueError("tensor_parallel and pipeline_parallel are mutually exclusive")
        multi_device = device.type == "cuda" and torch.cuda.device_count() > 1
        unported = [
            (getattr(config, "data_parallel", False) and multi_device,
             "data_parallel over more than one device", PARALLEL_ITEM),
            (getattr(config, "fsdp", False), "fsdp", PARALLEL_ITEM),
            (tp > 1, "tensor_parallel", PARALLEL_ITEM),
            (pp > 1, "pipeline_parallel", PARALLEL_ITEM),
        ]
        for unsupported, what, item in unported:
            if unsupported:
                raise not_ported(what, item)
        return SRModel(
            model_type="resnet" if discriminator is None else "gan", generator=generator,
            generator_optimizer=generator_optimizer,
            generator_optimizer_config=generator_optimizer_config,
            discriminator=discriminator, discriminator_optimizer=discriminator_optimizer,
            discriminator_optimizer_config=discriminator_optimizer_config,
            image_metrics=image_metrics,
            early_stop_metric=config.early_stop_metric,
            early_stop_patience=config.early_stop_patience,
            ema_decay=getattr(config, "ema_decay", None),
            ema_eval=getattr(config, "ema_eval", False),
            grad_accum_steps=getattr(config, "grad_accum_steps", None),
            distill=getattr(config, "distill", None),
            paired_ways=getattr(config, "paired_train", None),
            epoch_train_summary_writer=config.epoch_train_summary_writer,
            batch_train_summary_writer=config.batch_train_summary_writer,
            epoch_validation_summary_writer=config.epoch_validation_summary_writer,
            batch_validation_summary_writer=config.batch_validation_summary_writer,
            config=config, device=device)


def _to_cpu(tree):
    """A copy of a nest of dicts and lists (None passes) with every tensor
    on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree
