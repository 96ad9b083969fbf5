"""Image input by magic bytes: PNG and JPEG files and bodies to RGB, as the
JAX package reads them through PIL's ``convert("RGB")`` (``read_img``, the
serving daemon) or its native loader (the training pipeline).

Both formats decode in the port's C++ decoders (``native_loader``); with
``native=False`` a PNG decodes in Python (``data/png.py``), the plain
version. JPEG has no Python decoder: it always goes through the C++ bytes
entry. ``grey16`` picks how 16-bit grey PNGs read, the one mode where the
JAX package's two decoders differ: "pil" (clip to 255) or "loader" (the
high byte). Anything else (GIF, WebP, TIFF, BMP) raises ``ValueError``.
"""

import numpy as np

from simplesr_tpu_torch.data.native_loader import decode_bytes
from simplesr_tpu_torch.data.png import _SIGNATURE as PNG_MAGIC
from simplesr_tpu_torch.data.png import as_rgb, decode_png

JPEG_MAGIC = b"\xff\xd8"


def image_kind(head):
    """"png", "jpeg" or None, from the first bytes."""
    if head[:8] == PNG_MAGIC:
        return "png"
    if head[:2] == JPEG_MAGIC:
        return "jpeg"
    return None


def decode_image(data, name="image", native=True, grey16="pil"):
    """PNG or JPEG bytes -> uint8 RGB (H, W, 3)."""
    kind = image_kind(data)
    if kind is None:
        raise ValueError(f"{name}: not a PNG or JPEG file")
    if kind == "png" and not native:
        return as_rgb(decode_png(data, name, grey16))
    return decode_bytes(data, name, grey16)


def read_rgb_u8(path, native=True, grey16="pil"):
    """Decode a PNG or JPEG file to uint8 RGB (H, W, 3)."""
    with open(path, "rb") as f:
        return decode_image(f.read(), str(path), native, grey16)


def read_img(fpath, normalize_func=None, yield_path=False):
    """Decode an image file to float32 [0, 255] RGB HWC, as
    simplesr_tpu.data.read_img (PIL's semantics)."""
    img = read_rgb_u8(fpath).astype(np.float32)
    if normalize_func is not None:
        img = np.asarray(normalize_func(img))
    if yield_path:
        return img, fpath
    return img
