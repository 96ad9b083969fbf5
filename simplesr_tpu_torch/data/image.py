"""Image input by magic bytes: PNG, JPEG, BMP, WebP, GIF, TIFF and netpbm
files and bodies to RGB, as the JAX package reads them through PIL's
``convert("RGB")`` (``read_img``, the serving daemon and gateway) or its
native loader (the training pipeline).

PNG, JPEG, WebP, GIF and TIFF decode in the port's C++ decoders
(``native_loader``: ``csrc/host/loader.cpp``, ``webp.cpp``, ``gif.cpp``,
``tiff.cpp``); with ``native=False`` a PNG decodes in Python
(``data/png.py``), the plain version. BMP (uncompressed, bitfields, RLE8
and RLE4) and netpbm (P1 to P6) decode in numpy (``data/bmp.py``,
``data/pnm.py``). Each reads the first image of a file, as PIL opens it:
a still WebP (lossy or lossless, alpha dropped), frame 0 of a GIF, the
first IFD of a classic TIFF. ``grey16`` picks how 16-bit grey PNGs read,
the one mode where the JAX package's two decoders differ: "pil" (clip to
255) or "loader" (the high byte). Anything else (an animated WebP, BigTIFF,
JPEG-in-TIFF, an unknown format) raises ``ValueError`` naming it.
"""

import numpy as np

from simplesr_tpu_torch.data.bmp import BMP_MAGIC, decode_bmp
from simplesr_tpu_torch.data.native_loader import decode_bytes
from simplesr_tpu_torch.data.png import _SIGNATURE as PNG_MAGIC
from simplesr_tpu_torch.data.png import as_rgb, decode_png
from simplesr_tpu_torch.data.pnm import decode_pnm, is_pnm

JPEG_MAGIC = b"\xff\xd8"
GIF_MAGICS = (b"GIF87a", b"GIF89a")
TIFF_MAGICS = (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+")  # classic, then BigTIFF
# the kinds that decode in numpy: the C++ library (NativeLoader) reads the rest
PYTHON_KINDS = ("bmp", "pnm")


def image_kind(head):
    """"png", "jpeg", "bmp", "webp", "gif", "tiff", "pnm" or None, from the
    first bytes (12 are enough)."""
    if head[:8] == PNG_MAGIC:
        return "png"
    if head[:2] == JPEG_MAGIC:
        return "jpeg"
    if head[:2] == BMP_MAGIC:
        return "bmp"
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "webp"
    if head[:6] in GIF_MAGICS:
        return "gif"
    if head[:4] in TIFF_MAGICS:
        return "tiff"
    if is_pnm(head):
        return "pnm"
    return None


def decode_image(data, name="image", native=True, grey16="pil"):
    """Image bytes of any kind above -> uint8 RGB (H, W, 3)."""
    kind = image_kind(data)
    if kind is None:
        raise ValueError(f"{name}: not a PNG, JPEG, BMP, WebP, GIF, TIFF or netpbm file")
    if kind == "bmp":
        return decode_bmp(data, name)
    if kind == "pnm":
        return decode_pnm(data, name)
    if kind == "png" and not native:
        return as_rgb(decode_png(data, name, grey16))
    return decode_bytes(data, name, grey16)


def file_kind(path):
    """The kind of an image file, from its first bytes."""
    with open(path, "rb") as f:
        return image_kind(f.read(12))


def read_rgb_u8(path, native=True, grey16="pil"):
    """Decode an image file to uint8 RGB (H, W, 3)."""
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
