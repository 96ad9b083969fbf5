"""Image I/O and the training input pipeline."""

from simplesr_tpu_torch.data.pipeline import DataPipeline, train_test_split
from simplesr_tpu_torch.data.png import read_img, read_png, write_png

__all__ = ["DataPipeline", "train_test_split", "read_img", "read_png", "write_png"]
