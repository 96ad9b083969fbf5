"""Lossy WebP files with the encoder settings Pillow does not expose (the
simple loop filter, filter sharpness, token partitions, segments), written
by the libwebp that Pillow bundles, through ctypes. Pillow decodes them, so
its decode stays the judge of the port's.

The structs are libwebp's (encode.h, ABI 2.x) on x86-64; ``_check_layout``
reads back the defaults that libwebp fills in, so that a different layout
fails loudly instead of writing garbage.

``animation`` builds an animated WebP by hand around the image chunks of
still WebPs that Pillow writes (``image_chunks``), each frame an ``anmf``
chunk at any offset, size field and blend and dispose bits: the layouts
Pillow's encoder does not choose.
"""

import ctypes
import glob
import io
import os
import struct
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


def chunk(tag, payload):
    """A RIFF chunk: its tag, size, payload and pad byte."""
    return tag + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)


def image_chunks(img, **save):
    """The ALPH, VP8 or VP8L chunks of the still WebP that Pillow writes of
    ``img`` with ``save``."""
    buf = io.BytesIO()
    img.save(buf, "WEBP", **save)
    data, out, at = buf.getvalue(), b"", 12
    while at < len(data):
        size = struct.unpack("<I", data[at + 4:at + 8])[0]
        if data[at:at + 4] in (b"ALPH", b"VP8 ", b"VP8L"):
            out += data[at:at + 8 + size + (size & 1)]
        at += 8 + size + (size & 1)
    return out


def anmf(x, y, img, flags=0, image=None, size=None, **save):
    """An ANMF chunk: offset (x, y) (even), the frame's size (its image's, or
    ``size``), 100 ms, the flags byte (1: dispose to the background, 2: do
    not blend), then ``image`` or the chunks of ``img`` saved with ``save``."""
    image = image_chunks(img, **save) if image is None else image
    w, h = size or img.size
    head = b"".join(v.to_bytes(3, "little") for v in (x // 2, y // 2, w - 1, h - 1, 100))
    return chunk(b"ANMF", head + bytes([flags]) + image)


def animation(canvas, *chunks, vp8x_flags=0x12, anim=True):
    """An animated WebP of a (width, height) canvas: VP8X with
    ``vp8x_flags`` (animation and alpha by default), an ANIM chunk (a
    background colour, endless loop) unless ``anim`` is false, and
    ``chunks`` in order."""
    w, h = canvas
    vp8x = chunk(b"VP8X", bytes([vp8x_flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little")
                 + (h - 1).to_bytes(3, "little"))
    body = b"WEBP" + vp8x + (chunk(b"ANIM", struct.pack("<IH", 0xFF2040C0, 0)) if anim
                             else b"") + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body
