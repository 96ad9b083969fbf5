"""Config: the YAML reader, ConfigUtil and the YAML helpers."""

from simplesr_tpu_torch.config import yaml_helper
from simplesr_tpu_torch.config.config_util import AVAILABLE_OPERATIONS, ConfigUtil

__all__ = ["ConfigUtil", "AVAILABLE_OPERATIONS", "yaml_helper"]
