"""Training and model files: ``SRModel`` (ResNet and GAN modes),
``Generator``, ``Discriminator`` and ``run_training``, the optimizers,
metrics and early stopping, and reading and writing simplesr_tpu's model
format."""

from simplesr_tpu_torch.train.convert import from_flax_variables, to_flax_variables
from simplesr_tpu_torch.train.serialization import (MODEL_EXT, load_model, load_payload,
                                                    save_model)
from simplesr_tpu_torch.train.discriminator import Discriminator
from simplesr_tpu_torch.train.early_stopping import EarlyStopping
from simplesr_tpu_torch.train.generator import Generator
from simplesr_tpu_torch.train.metrics import MeanMetric, MetricBundle
from simplesr_tpu_torch.train.optimizers import build_optimizer, build_schedule
from simplesr_tpu_torch.train.sr_model import SRModel
from simplesr_tpu_torch.train.training import run_training

__all__ = ["from_flax_variables", "to_flax_variables", "load_model", "load_payload",
           "save_model", "MODEL_EXT", "EarlyStopping", "Discriminator", "Generator",
           "MeanMetric", "MetricBundle", "build_optimizer", "build_schedule", "SRModel", "run_training"]
