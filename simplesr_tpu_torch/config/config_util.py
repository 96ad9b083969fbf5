"""ConfigUtil, the single-YAML config surface, as
simplesr_tpu.config.config_util: operation modes, the timestamped save-dir
tree (checkpoints, logs, models, pics/{train,val,test}) with its ``latest``
symlink, four TensorBoard writers (``torch.utils.tensorboard`` where it can
be imported, else none, as the JAX package does without tensorboardX),
data-dir checks, test-originals matching, config mutation for sweeps, and
``from_yaml``, which builds the config, the pipeline and, for training, the
SRModel on ``device`` (in GAN mode when the YAML has a ``discriminator``
section).
"""

import copy
import os
import time
import logging
from datetime import datetime
from pathlib import Path

from simplesr_tpu_torch.config import yaml_helper
from simplesr_tpu_torch.core.device import resolve_device
from simplesr_tpu_torch.utils import logger

log = logging.getLogger(logger.LIB_LOGGER).getChild(__name__)
AVAILABLE_OPERATIONS = ["training", "evaluation", "inference", "experiment", "testing"]


def _make_summary_writer(log_dir):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:  # no tensorboard package on this machine
        return None
    return SummaryWriter(log_dir)


class ConfigUtil:
    """See the module docstring; the constructor's arguments are the JAX
    package's."""

    def __init__(self, operation, num_epochs, batch_size,
                 train_data_paths, validation_data_path, test_data_paths,
                 test_originals_path, results_save_path, train_val_split,
                 scale, resize_filter,
                 crop_imgs, crop_size, num_crops, crop_naive,
                 minimum_variation_patch, minimum_variation_batch,
                 augmentations, jpg_noise, jpg_noise_level,
                 dry_run, model_path=None, antialias=True,
                 shuffle_buffer_size=4096, random_seed=None,
                 early_stop_metric="psnr", early_stop_patience=5,
                 save_single=False, grid=False, interpolate=False,
                 with_original=False, combine_halfs=False,
                 save_dir_name=None):
        self.dry_run = dry_run
        self.random_seed = random_seed
        if operation not in AVAILABLE_OPERATIONS:
            raise ValueError(
                f"operation not recognized - choose one of {AVAILABLE_OPERATIONS}")
        self.operation = operation
        if save_dir_name:  # reuse a previous run's dir (resume)
            self.save_dir_name = save_dir_name
        elif self.operation == "testing":
            self.save_dir_name = str(time.time())
        else:
            self.save_dir_name = datetime.now().strftime("%Y%m%d-%H%M%S")

        self.train_data_paths = train_data_paths
        if self.train_data_paths and not isinstance(self.train_data_paths, list):
            self.train_data_paths = [self.train_data_paths]

        self.save_path = os.path.join(results_save_path, self.operation,
                                      self.save_dir_name)
        self.validation_data_path = validation_data_path
        self.test_data_paths = test_data_paths
        self.test_originals_path = test_originals_path
        self.test_originals = None
        if self.test_data_paths is not None:
            self.test_originals = self._find_originals()
        self.model_path = model_path

        self._validate_data_dirs()

        self.batch_size = batch_size
        self.scale = scale
        self.save_single = save_single
        self.grid = grid
        self.interpolate = interpolate
        self.with_original = with_original
        self.combine_halfs = combine_halfs
        self.antialias = antialias
        self.resize_filter = resize_filter or "bicubic"
        self.crop_imgs = crop_imgs
        self.crop_size = crop_size
        self.num_crops = num_crops
        self.crop_naive = crop_naive
        self.minimum_variation_patch = minimum_variation_patch
        self.minimum_variation_batch = minimum_variation_batch
        if self.operation not in ("inference",):
            self.num_epochs = num_epochs
            self.shuffle_buffer_size = shuffle_buffer_size
            self.train_val_split = train_val_split
            self.augmentations = augmentations
            self.jpg_noise = jpg_noise
            self.jpg_noise_level = jpg_noise_level
            self.early_stop_metric = early_stop_metric
            self.early_stop_patience = early_stop_patience

        # writer slots always exist (SRModel.init reads them)
        self.epoch_train_summary_writer = None
        self.batch_train_summary_writer = None
        self.epoch_validation_summary_writer = None
        self.batch_validation_summary_writer = None

        self._prepare_save_dirs()
        logger.setup_logger(self.save_path if not self.dry_run else None)

    # -------------------------------------------------------------- mutation

    def base_save_path(self):
        return Path(self.save_path).parent

    def update_config(self, **kwargs):
        for field, value in kwargs.items():
            setattr(self, field, value)

    def reinitialize_save_dirs(self):
        self._prepare_save_dirs()

    def __str__(self):
        return "".join(f"{k} -> {v}\n" for k, v in self.__dict__.items()
                       if "summary_writer" not in k)

    def __deepcopy__(self, memodict):
        cls = self.__class__
        copied = cls.__new__(cls)
        memodict[id(self)] = copied
        for key, val in self.__dict__.items():
            if "summary_writer" in key:
                setattr(copied, key, None)
            else:
                setattr(copied, key, copy.deepcopy(val, memodict))
        return copied

    # -------------------------------------------------------------- factories

    @staticmethod
    def training_config(train_data_paths, num_epochs, batch_size, scale,
                        operation="training", validation_data_path=None,
                        test_data_path=None, test_originals_path=None,
                        results_save_path="./", create_save_dirs=True,
                        train_val_split=0.1, crop_imgs=True,
                        crop_size=(96, 96, 3), num_crops=16, crop_naive=True,
                        minimum_variation_patch=0.15,
                        minimum_variation_batch=0.05, augmentations=None,
                        jpg_noise=False, jpg_noise_level=50,
                        shuffle_buffer_size=4096, random_seed=None,
                        resize_filter=None, antialias=True,
                        early_stop_metric="psnr", early_stop_patience=5,
                        data_parallel=False, ema_decay=None, ema_eval=False,
                        grad_accum_steps=None, fsdp=False, distill=None,
                        async_checkpointing=True, tensor_parallel=None,
                        pipeline_parallel=None, pipeline_microbatches=None,
                        paired_train=None, device_resident="auto",
                        resume=None):
        """Training-mode config. The arguments are the JAX package's, so that
        its YAML files load unchanged; ``paired_train`` (``SRModel``'s
        paired mode) and ``distill`` (a frozen teacher's term,
        train/distill.py) reach ``SRModel.init``, which raises
        ``NotImplementedError`` for those the port has not ported yet
        (``data_parallel`` on more than one device, ``fsdp``,
        ``tensor_parallel``, ``pipeline_parallel``), each naming its
        ROADMAP.md item. ``async_checkpointing`` changes nothing: the port
        writes its checkpoints at once. ``resume=True`` or ``"latest"``
        reuses the latest run's save dir and continues it from its resume
        point (see run_training); a run name (or a path) under
        ``<results>/training/`` picks a run."""
        test_data_paths = ConfigUtil._extract_multiple_data_paths(test_data_path)
        reuse_dir = ConfigUtil._resolve_resume_dir(
            results_save_path, resume) if resume else None
        cfg = ConfigUtil(
            train_data_paths=train_data_paths, num_epochs=num_epochs,
            batch_size=batch_size, resize_filter=resize_filter,
            antialias=antialias, scale=scale, operation=operation,
            validation_data_path=validation_data_path,
            test_data_paths=test_data_paths,
            test_originals_path=test_originals_path,
            dry_run=not create_save_dirs, train_val_split=train_val_split,
            crop_imgs=crop_imgs, crop_size=crop_size, num_crops=num_crops,
            crop_naive=crop_naive,
            minimum_variation_patch=minimum_variation_patch,
            minimum_variation_batch=minimum_variation_batch,
            augmentations=augmentations, jpg_noise=jpg_noise,
            jpg_noise_level=jpg_noise_level,
            shuffle_buffer_size=shuffle_buffer_size, random_seed=random_seed,
            early_stop_metric=early_stop_metric,
            early_stop_patience=early_stop_patience,
            results_save_path=results_save_path,
            save_dir_name=reuse_dir)._with_data_parallel(
                data_parallel, ema_decay, grad_accum_steps, fsdp, ema_eval,
                distill, async_checkpointing, tensor_parallel,
                pipeline_parallel, pipeline_microbatches, paired_train)
        cfg.resume = bool(resume)
        # data: device-resident crop pool gate (docs/data.md) — "auto"
        # uploads small corpora once and gathers crops on device
        cfg.device_resident = device_resident
        return cfg

    @staticmethod
    def _resolve_resume_dir(results_save_path, resume):
        """Map a ``resume`` spec to an existing run-dir NAME under
        ``<results>/training/``: True/'latest' follows the latest symlink;
        a run name or a path under that tree names a specific run. The
        target must contain a checkpoints/ dir (i.e. be a training run)."""
        base = os.path.realpath(os.path.join(results_save_path, "training"))
        if resume is True or (isinstance(resume, str)
                              and resume.lower() == "latest"):
            target = os.path.join(base, "latest")
        elif isinstance(resume, str):
            target = resume if os.path.sep in resume \
                else os.path.join(base, resume)
        else:
            raise ValueError(f"resume must be True/'latest'/a run name or "
                             f"path, got {resume!r}")
        target = os.path.realpath(target)
        if os.path.dirname(target) != base:
            raise ValueError(f"resume target {target} is not a run under "
                             f"{base}")
        if not os.path.isdir(os.path.join(target, "checkpoints")):
            raise ValueError(f"resume target {target} has no checkpoints/ "
                             "dir - not a previous training run")
        return os.path.basename(target)

    def _with_data_parallel(self, flag, ema_decay=None, grad_accum_steps=None,
                            fsdp=False, ema_eval=False, distill=None,
                            async_checkpointing=True, tensor_parallel=None,
                            pipeline_parallel=None,
                            pipeline_microbatches=None, paired_train=None):
        self.data_parallel = bool(flag)
        self.ema_decay = ema_decay
        self.ema_eval = bool(ema_eval)
        self.grad_accum_steps = grad_accum_steps
        self.fsdp = bool(fsdp)
        self.distill = distill
        self.async_checkpointing = bool(async_checkpointing)
        self.tensor_parallel = tensor_parallel
        self.pipeline_parallel = pipeline_parallel
        self.pipeline_microbatches = pipeline_microbatches
        self.paired_train = paired_train
        return self

    @staticmethod
    def evaluation_config(data_paths, test_originals_path, model_paths,
                          results_save_path, scale=2, batch_size=8,
                          resize_filter=None, antialias=True, crop_imgs=False,
                          crop_size=(128, 128, 3), random_seed=None,
                          num_crops=16, crop_naive=True,
                          minimum_variation_patch=0.15,
                          minimum_variation_batch=0.05, create_save_dirs=True,
                          operation="evaluation", save_single=True, grid=False,
                          interpolate=False, with_original=False,
                          combine_halfs=False, self_ensemble=False):
        """Evaluation and inference-mode config. ``self_ensemble=True``
        serves every model through the x8 geometric test-time ensemble
        (``ops/ensemble.py``)."""
        _data_paths = ConfigUtil._extract_multiple_data_paths(data_paths)
        conf = ConfigUtil(
            operation=operation, num_epochs=None, batch_size=batch_size,
            train_data_paths=None, validation_data_path=None,
            test_data_paths=_data_paths,
            test_originals_path=test_originals_path,
            results_save_path=results_save_path, model_path=model_paths,
            train_val_split=None, crop_imgs=crop_imgs, crop_size=crop_size,
            num_crops=num_crops, crop_naive=crop_naive,
            minimum_variation_patch=minimum_variation_patch,
            minimum_variation_batch=minimum_variation_batch, scale=scale,
            resize_filter=resize_filter, antialias=antialias,
            augmentations=[], jpg_noise=None, jpg_noise_level=None,
            dry_run=not create_save_dirs, random_seed=random_seed,
            save_single=save_single, grid=grid, interpolate=interpolate,
            with_original=with_original, combine_halfs=combine_halfs)
        conf.self_ensemble = bool(self_ensemble)
        return conf

    @staticmethod
    def from_yaml(config_yaml_path, device="cuda"):
        """One YAML file (or its loaded dict) to the whole run on ``device``:
        (config, pipeline, sr_model) for training, (config, pipeline) for
        evaluation and inference."""
        from simplesr_tpu_torch.data import DataPipeline
        from simplesr_tpu_torch.train import Discriminator, Generator, SRModel

        device = resolve_device(device)
        conf_yaml = yaml_helper.load_yaml(config_yaml_path)
        operation = conf_yaml["general"]["operation"]

        if operation == "training":
            conf_yaml = yaml_helper.prepare_for_training_config(conf_yaml)
            conf = ConfigUtil.training_config(**conf_yaml["general"])
        elif operation == "evaluation":
            conf_yaml = yaml_helper.prepare_for_evaluation_config(conf_yaml)
            conf = ConfigUtil.evaluation_config(**conf_yaml["general"])
            return conf, DataPipeline.eval_pipeline(conf, device=device)
        elif operation == "inference":
            conf = ConfigUtil.evaluation_config(**conf_yaml["general"])
            return conf, DataPipeline.inference_pipeline(conf, device=device)
        else:
            raise ValueError(f"Operation {operation} not supported")

        pipeline = DataPipeline.from_config(conf, device=device)
        model = conf_yaml["model"]
        generator = Generator.from_yaml(conf_yaml, device=device)
        discriminator = discriminator_optimizer = discriminator_optimizer_config = None
        if "discriminator" in model:
            discriminator = Discriminator.from_yaml(conf_yaml, device=device)
            discriminator_optimizer = model["discriminator_optimizer"]
            discriminator_optimizer_config = model.get("discriminator_optimizer_config")
        sr_model = SRModel.init(
            conf, generator, model["generator_optimizer"],
            model.get("generator_optimizer_config"), discriminator, discriminator_optimizer,
            discriminator_optimizer_config, device=device)
        return conf, pipeline, sr_model

    # ------------------------------------------------------------- internals

    def _prepare_save_dirs(self):
        self.perf_logfile = os.path.join(self.save_path, "perf_logfile")
        self.result_logfile = os.path.join(self.save_path, "result_logfile")
        self.final_result = os.path.join(self.save_path, "result")
        self.config_logfile = os.path.join(self.save_path, "config_logfile")
        if not self.dry_run:
            os.makedirs(self.save_path, exist_ok=True)
            self._update_latest_symlink()
        self._add_save_dir("pics", "pic_dir")

        if self.operation not in ("testing", "evaluation", "inference"):
            self._add_save_dir("checkpoints", "checkpoint_dir")
            self._add_save_dir(os.path.join("pics", "test"), "pic_dir_test")
            self._add_save_dir("models", "model_dir")
            self._add_save_dir(os.path.join("pics", "train"), "pic_dir_train")
            self._add_save_dir(os.path.join("pics", "val"), "pic_dir_val")
            self._add_save_dir(os.path.join("logs", "train", "epoch"), "log_dir_train_epoch")
            self._add_save_dir(os.path.join("logs", "train", "batch"), "log_dir_train_batch")
            self._add_save_dir(os.path.join("logs", "val", "epoch"), "log_dir_val_epoch")
            self._add_save_dir(os.path.join("logs", "val", "batch"), "log_dir_val_batch")
            if not self.dry_run:
                self.epoch_train_summary_writer = _make_summary_writer(self.log_dir_train_epoch)
                self.batch_train_summary_writer = _make_summary_writer(self.log_dir_train_batch)
                self.epoch_validation_summary_writer = _make_summary_writer(self.log_dir_val_epoch)
                self.batch_validation_summary_writer = _make_summary_writer(self.log_dir_val_batch)

    def _update_latest_symlink(self):
        """Point <results>/<operation>/latest at this run's save dir, so
        follow-up configs can reference e.g.
        `training/latest/models/resnet_gen_best.msgpack` without pasting
        timestamps (the evaluation example does). Best-effort: skipped on
        filesystems without symlink support."""
        link = os.path.join(os.path.dirname(self.save_path), "latest")
        try:
            if os.path.exists(link) and not os.path.islink(link):
                return  # a real directory named "latest" — leave it alone
            # atomic swap: create a temp symlink and rename it over "latest",
            # so concurrent runs can't leave the link missing or stale
            tmp = link + f".tmp{os.getpid()}"
            os.symlink(self.save_dir_name, tmp)
            os.replace(tmp, link)
        except OSError:
            pass

    def _add_save_dir(self, dir_name, attribute_name):
        path = os.path.join(self.save_path, dir_name)
        if not self.dry_run:
            os.makedirs(path, exist_ok=True)
        setattr(self, attribute_name, path)

    def _validate_data_dirs(self):
        if not self.dry_run and self.operation not in ("evaluation", "inference"):
            ConfigUtil._validate_data_dir(self.train_data_paths)
        if not self.dry_run and self.validation_data_path is not None:
            ConfigUtil._validate_data_dir(self.validation_data_path)
        if not self.dry_run and self.test_data_paths is not None:
            ConfigUtil._validate_data_dir(self.test_data_paths)

    def _find_originals(self):
        if not self.test_originals_path:
            return None
        if not os.path.isdir(self.test_originals_path):
            log.debug("could not locate originals folder")
            return None
        paths = self.test_data_paths
        if not isinstance(paths, list):
            paths = [paths]
        folder_names = [Path(p).stem if os.path.isdir(p) else Path(p).parent.name
                        for p in paths]
        return {fname.split(".")[0]: os.path.join(self.test_originals_path, fname)
                for fname in os.listdir(self.test_originals_path)
                if fname.split(".")[0] in folder_names}

    @staticmethod
    def _validate_data_dir(data_path):
        if not isinstance(data_path, list):
            data_path = [data_path]
        for path in data_path:
            if not os.path.isdir(path) and not os.path.isfile(path):
                raise ValueError(f"could not locate dataset - {path} does not exist")

    @staticmethod
    def _extract_multiple_data_paths(test_data_path):
        if test_data_path is None:
            return None
        if not isinstance(test_data_path, list) and os.path.isfile(test_data_path):
            return test_data_path
        if not isinstance(test_data_path, list):
            test_data_path = [test_data_path]
        out = []
        for path in test_data_path:
            if os.path.isfile(path):
                out.append(path)
            else:
                out += [os.path.join(path, f) for f in os.listdir(path)
                        if os.path.isdir(os.path.join(path, f))
                        or os.path.isfile(os.path.join(path, f))]
        return out
