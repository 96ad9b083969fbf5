"""Logging and the training histories' JSON files."""

from simplesr_tpu_torch.utils.logger import LIB_LOGGER, RESULTS_LOGGER, setup_logger
from simplesr_tpu_torch.utils.train_result import TrainResult

__all__ = ["setup_logger", "LIB_LOGGER", "RESULTS_LOGGER", "TrainResult"]
