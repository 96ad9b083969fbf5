"""The training operation, as simplesr_tpu.train.training: the epoch and
batch loop with early stopping, train and validation batches with their
hooks, ``test_and_plot`` on one train batch, one validation batch and the
test batches after each epoch but the first, epoch timing and metric logs,
the JSON dump of the histories, and the final pass over the validation set.

A SIGTERM during training (installed in the main thread only, and always
restored) finishes the batch in flight, saves a resume point and returns
None; ``resume=True`` continues from it. ``profile_dir`` captures a
``torch.profiler`` trace of the epoch loop there. Under a process group of
several ranks every rank runs the loop (the model reduces over them) and
rank 0 writes the run's logs and JSON dump.
"""

import logging
import os
import signal
import threading
import time

import torch

from simplesr_tpu_torch.core.device import resolve_device
from simplesr_tpu_torch.parallel import comm
from simplesr_tpu_torch.utils import logger as logger_mod
from simplesr_tpu_torch.utils.train_result import TrainResult

log = logging.getLogger(logger_mod.RESULTS_LOGGER)


def run_training(config, data_pipeline, sr_model, plotting_interval=1, profile_dir=None,
                 resume=None, device="cuda"):
    """Run a training session (see the module docstring). ``data_pipeline``
    and ``sr_model`` must live on ``device``. Returns the TrainResult, or
    None when preempted.

    ``resume`` (default: ``config.resume``) restores the resume point:
    parameters, optimizer, step, epoch counter, early-stopping state and
    epoch histories, and continues from the first unfinished epoch. The
    data order is derived anew from the pipeline's seed: an interrupted
    epoch runs again from the preempted state."""
    device = resolve_device(device)
    for name, where in (("data_pipeline", data_pipeline.device), ("sr_model", sr_model.device)):
        if where.type != device.type:
            raise ValueError(f"{name} lives on {where}, not on {device}")
    _log_configurations(config, data_pipeline, sr_model)
    start_training = time.perf_counter()

    if resume is None:
        resume = bool(getattr(config, "resume", False))
    start_epoch = 0
    if resume:
        completed = sr_model.resume_training()
        if completed is None:
            log.info("resume requested but no checkpoint found - starting fresh")
        else:
            start_epoch = min(completed, config.num_epochs)
            log.info(f"resuming after {completed} completed epochs "
                     f"(step {sr_model.iterations()})")

    preempted, restore_handler = _install_preemption_handler()
    try:
        if profile_dir:
            finished = _profiled(profile_dir, lambda: _epoch_loop(
                config, data_pipeline, sr_model, plotting_interval, start_epoch,
                config.num_epochs, preempted))
        else:
            finished = _epoch_loop(config, data_pipeline, sr_model, plotting_interval,
                                   start_epoch, config.num_epochs, preempted)
    finally:
        restore_handler()

    if not finished:  # preempted: the resume point is saved
        return None

    log.info(f"finished training ({time.perf_counter() - start_training:.2f} sec)")
    sr_model.after_training()

    histories = sr_model.histories()
    result = TrainResult(sr_model.name, histories["train_batch"], histories["train_epoch"],
                         histories["valid_batch"], histories["valid_epoch"])
    if _writes():
        result.save_as_json(os.path.join(getattr(config, "save_path", "."), "json_dump"))

    log.info("calculating psnr/ssim on validation set")
    from simplesr_tpu_torch.eval import evaluation
    evaluation.evaluate_on_validationdata(config=config, model_name=sr_model.name,
                                          pipeline=data_pipeline, model=sr_model,
                                          device=device)
    log.info("done")
    return result


def _stop(preempted):
    """Whether to stop for a preemption: at once alone, when any rank was
    signalled under a process group (every rank stops at the same batch)."""
    if comm.world_size() == 1:
        return preempted.is_set()
    return comm.agree(preempted.is_set(), None, comm.dist.ReduceOp.MAX)


def _writes():
    """Whether this process writes the run's files: rank 0's does, under a
    process group of several ranks."""
    return comm.world_rank() == 0


def _profiled(profile_dir, run):
    """``run()`` under a ``torch.profiler`` trace written to ``profile_dir``
    (CUDA activity too when a card is present)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(profile_dir)):
        return run()


def _install_preemption_handler():
    """SIGTERM -> an event meaning "save a resume point and stop", for the
    duration of training and in the main thread only. Returns (event,
    restore): ``restore`` must run when training ends."""
    preempted = threading.Event()
    if threading.current_thread() is not threading.main_thread():
        return preempted, lambda: None
    prev = signal.signal(signal.SIGTERM, lambda *_: preempted.set())
    return preempted, lambda: signal.signal(signal.SIGTERM, prev)


def _epoch_loop(config, data_pipeline, sr_model, plotting_interval, start_epoch, num_epochs,
                preempted):
    """True when training ran to its end (or stopped early), False when
    preempted (resume point saved)."""
    for epoch in range(start_epoch, num_epochs):
        if sr_model.stop_early():
            break
        sr_model.before_epoch()
        start_epoch_t = time.perf_counter()

        for lr_batch, hr_batch in data_pipeline.train_batch_generator():
            if _stop(preempted):
                break
            sr_model.train_step(lr_batch, hr_batch)
            sr_model.after_train_batch()

        for lr_batch, hr_batch in data_pipeline.validation_batch_generator():
            if _stop(preempted):
                break
            sr_model.validation_step(lr_batch, hr_batch)
            sr_model.after_validation_batch()

        if _stop(preempted):
            sr_model.save_resume_point()
            log.info(f"preempted during epoch {epoch} - resume point saved "
                     f"(step {sr_model.iterations()}); rerun with resume=True to continue")
            return False

        if epoch != 0 and plotting_interval and epoch % plotting_interval == 0:
            _plot_progress(config, data_pipeline, sr_model)

        epoch_duration = time.perf_counter() - start_epoch_t
        log.info(f"epoch: {epoch} ({epoch_duration:.2f} sec)\n"
                 + sr_model.formatted_epoch_metrics())
        _log_perf(config, epoch, epoch_duration, sr_model)
        sr_model.after_epoch()
    return True


def _log_perf(config, epoch, epoch_duration, sr_model):
    """Append the epoch's wall time and step count to config.perf_logfile."""
    path = getattr(config, "perf_logfile", None)
    if not path or not _writes():
        return
    try:
        with open(path, "a") as f:
            f.write(f"epoch={epoch} duration_s={epoch_duration:.3f} "
                    f"total_steps={sr_model.iterations()}\n")
    except OSError:
        pass


def _plot_progress(config, data_pipeline, sr_model):
    for lr_batch, hr_batch in data_pipeline.train_batch_generator():
        sr_model.test_and_plot(lr_batch, config.pic_dir_train, 0, hr_batch)
        break
    for lr_batch, hr_batch in data_pipeline.validation_batch_generator():
        sr_model.test_and_plot(lr_batch, config.pic_dir_val, 0, hr_batch)
        break
    for step, (lr_batch, _) in enumerate(
            data_pipeline.test_batch_generator(batch_size=config.batch_size)):
        sr_model.test_and_plot(lr_batch, config.pic_dir_test, step, None)


def _log_configurations(config, data_pipeline, sr_model):
    path = getattr(config, "config_logfile", None)
    if not path or not _writes():
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a+") as f:
        f.write("# Base config\n")
        f.write(f"{config}\n")
        f.write("# Data Pipeline config\n")
        f.write(f"{data_pipeline}\n")
        f.write("# Model config\n")
        f.write(f"{sr_model}\n")
