"""Lossy WebP files with the encoder settings Pillow does not expose (the
simple loop filter, filter sharpness, token partitions, segments), written
by the libwebp that Pillow bundles, through ctypes. Pillow decodes them, so
its decode stays the judge of the port's.

The structs are libwebp's (encode.h, ABI 2.x) on x86-64; ``_check_layout``
reads back the defaults that libwebp fills in, so that a different layout
fails loudly instead of writing garbage.
"""

import ctypes
import glob
import os
from pathlib import Path

import numpy as np
import PIL
from PIL import _webp  # noqa: F401  (loads libwebp's own dependencies first)

_ABI = 0x0210
_CONFIG_BYTES = 256
_PICTURE_BYTES = 512
# int offsets in WebPConfig
_CFG = {"lossless": 0, "method": 8, "segments": 24, "sns_strength": 28,
        "filter_strength": 32, "filter_sharpness": 36, "filter_type": 40, "autofilter": 44,
        "alpha_quality": 56, "preprocessing": 68, "partitions": 72}
_PIC_USE_ARGB, _PIC_WIDTH, _PIC_HEIGHT = 0, 8, 12
_PIC_ARGB_STRIDE, _PIC_WRITER, _PIC_CUSTOM = 80, 96, 104

_lib = None


def _library():
    global _lib
    if _lib is None:
        libs = Path(PIL.__file__).resolve().parents[1] / "pillow.libs"
        path = sorted(glob.glob(os.fspath(libs / "libwebp-*.so*")))[0]
        lib = ctypes.CDLL(path)
        lib.WebPConfigInitInternal.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                                               ctypes.c_int]
        lib.WebPPictureInitInternal.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.WebPPictureImportRGB.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        lib.WebPEncode.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.WebPValidateConfig.argtypes = [ctypes.c_void_p]
        lib.WebPMemoryWriterInit.argtypes = [ctypes.c_void_p]
        lib.WebPMemoryWriterClear.argtypes = [ctypes.c_void_p]
        lib.WebPPictureFree.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def _ints(buf):
    return np.frombuffer(buf, np.int32)


def _check_layout(cfg, quality):
    ints = _ints(cfg)
    got = (np.frombuffer(cfg, np.float32)[1], ints[_CFG["segments"] // 4],
           ints[_CFG["sns_strength"] // 4], ints[_CFG["filter_strength"] // 4],
           ints[_CFG["filter_type"] // 4], ints[_CFG["alpha_quality"] // 4])
    if got != (quality, 4, 50, 60, 1, 100):
        raise RuntimeError(f"unexpected WebPConfig layout: {got}")


class _MemoryWriter(ctypes.Structure):
    _fields_ = [("mem", ctypes.POINTER(ctypes.c_uint8)), ("size", ctypes.c_size_t),
                ("max_size", ctypes.c_size_t), ("pad", ctypes.c_uint32 * 1)]


def write_webp(rgb, quality=75, **settings):
    """uint8 RGB (H, W, 3) -> lossy WebP bytes, with WebPConfig's int fields
    (``filter_type``, ``filter_sharpness``, ``filter_strength``,
    ``partitions``, ``segments``, ``sns_strength``, ``method``,
    ``autofilter``, ``preprocessing``) set from ``settings``."""
    lib = _library()
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    cfg = ctypes.create_string_buffer(_CONFIG_BYTES)
    if not lib.WebPConfigInitInternal(cfg, 0, ctypes.c_float(quality), _ABI):
        raise RuntimeError("WebPConfigInit failed")
    _check_layout(cfg, quality)
    for key, value in settings.items():
        ctypes.c_int.from_buffer(cfg, _CFG[key]).value = int(value)
    if not lib.WebPValidateConfig(cfg):
        raise ValueError(f"libwebp refuses the settings {settings}")
    pic = ctypes.create_string_buffer(_PICTURE_BYTES)
    if not lib.WebPPictureInitInternal(pic, _ABI):
        raise RuntimeError("WebPPictureInit failed")
    ints = _ints(pic)
    ctypes.c_int.from_buffer(pic, _PIC_USE_ARGB).value = 1
    ctypes.c_int.from_buffer(pic, _PIC_WIDTH).value = w
    ctypes.c_int.from_buffer(pic, _PIC_HEIGHT).value = h
    writer = _MemoryWriter()
    lib.WebPMemoryWriterInit(ctypes.byref(writer))
    try:
        if not lib.WebPPictureImportRGB(pic, rgb.ctypes.data, 3 * w):
            raise RuntimeError("WebPPictureImportRGB failed")
        if ints[_PIC_ARGB_STRIDE // 4] != w:
            raise RuntimeError("unexpected WebPPicture layout")
        ctypes.c_void_p.from_buffer(pic, _PIC_WRITER).value = ctypes.cast(
            lib.WebPMemoryWrite, ctypes.c_void_p).value
        ctypes.c_void_p.from_buffer(pic, _PIC_CUSTOM).value = ctypes.addressof(writer)
        if not lib.WebPEncode(cfg, pic):
            raise RuntimeError("WebPEncode failed")
        return bytes(ctypes.string_at(writer.mem, writer.size))
    finally:
        lib.WebPPictureFree(pic)
        lib.WebPMemoryWriterClear(ctypes.byref(writer))
