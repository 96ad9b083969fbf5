"""Config: the YAML reader, ConfigUtil, the YAML helpers and experiment
sweeps."""

from simplesr_tpu_torch.config import yaml_helper
from simplesr_tpu_torch.config.config_util import AVAILABLE_OPERATIONS, ConfigUtil
from simplesr_tpu_torch.config.experiment import Experiment

__all__ = ["ConfigUtil", "AVAILABLE_OPERATIONS", "Experiment", "yaml_helper"]
