"""Image I/O and the training input pipeline."""

from simplesr_tpu_torch.data.image import decode_image, read_img, read_rgb_u8
from simplesr_tpu_torch.data.native_loader import NativeLoader, get_native_loader
from simplesr_tpu_torch.data.pipeline import DataPipeline, train_test_split
from simplesr_tpu_torch.data.png import read_png, write_png

__all__ = ["DataPipeline", "train_test_split", "read_img", "read_rgb_u8", "decode_image",
           "read_png", "write_png", "NativeLoader", "get_native_loader"]
