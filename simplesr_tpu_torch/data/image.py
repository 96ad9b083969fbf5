"""Image input in PIL's order of formats: PNG, JPEG, BMP, DIB, WebP, GIF,
TIFF, netpbm, PSD, DDS, TGA, ICO, CUR, QOI, PCX, DCX and SGI files and
bodies to RGB, as the JAX package reads them through PIL's
``convert("RGB")`` (``read_img``, the serving daemon and gateway) or its
native loader (the training pipeline).

PNG, JPEG, WebP, GIF, TIFF, PSD, DDS, TGA, QOI, PCX, DCX and SGI decode in
the port's C++ decoders (``native_loader``: ``csrc/host/loader.cpp``,
``webp.cpp``, ``gif.cpp``, ``tiff.cpp``, ``psd.cpp``, ``dds.cpp``,
``tga.cpp``, ``qoi.cpp``, ``pcx.cpp``, ``sgi.cpp``); with ``native=False`` a
PNG decodes in Python (``data/png.py``), the plain version. BMP and DIB
(uncompressed, bitfields, RLE8 and RLE4), netpbm (P1 to P6) and ICO and
CUR (their frames through the PNG and DIB decoders) decode in numpy
(``data/bmp.py``, ``data/pnm.py``, ``data/ico.py``). Each reads the image
PIL opens: a still WebP or an animated one's first frame on its canvas
(lossy or lossless, alpha dropped), frame 0 of a GIF, the first IFD of a
TIFF, a PSD's merged image, the first surface of a DDS, the frame PIL picks
from an icon's directory, the first page of a DCX. A DIB is a BMP without
its 14-byte file header, taken where PIL's DIB plugin takes it: a header
size that BMP knows in the first four bytes.

``image_kind`` picks the kind as ``Image.open`` does: the plugins in the
order of ``Image.ID``, each taking a file its open accepts, the next tried
where an open rejects it as not its format. TGA has no magic and comes
last, so an icon whose directory is empty can read as a TGA, as in PIL.
``grey16`` picks how 16-bit grey PNGs read, the one mode where the JAX
package's two decoders differ: "pil" (clip to 255) or "loader" (the high
byte). Anything else (a PSB, a 16-bit PSD, a format the port does not
read) raises ``ValueError`` naming it and ROADMAP.md's item.
"""

import struct

import numpy as np

from simplesr_tpu_torch.data.bmp import (BMP_MAGIC, UNSUPPORTED_ITEM, decode_bmp, decode_dib,
                                         is_dib)
from simplesr_tpu_torch.data.ico import cur_claims, decode_cur, decode_ico, ico_claims
from simplesr_tpu_torch.data.native_loader import decode_bytes, native_kind
from simplesr_tpu_torch.data.png import _SIGNATURE as PNG_MAGIC
from simplesr_tpu_torch.data.png import as_rgb, decode_png
from simplesr_tpu_torch.data.pnm import decode_pnm, is_pnm

JPEG_MAGIC = b"\xff\xd8"
GIF_MAGICS = (b"GIF87a", b"GIF89a")
TIFF_MAGICS = (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+")  # classic, then BigTIFF
MPEG_MAGIC = b"\0\0\1\xb3"
# the kinds that decode in numpy: the C++ library (NativeLoader) reads the rest
PYTHON_KINDS = ("bmp", "dib", "pnm", "ico", "cur", "gbr", "mpeg", "spider")
# formats PIL tries before ICO, QOI and TGA whose tests can take their files:
# named and refused, so that those never read as a kind PIL does not give
REFUSED_KINDS = {"gbr": "GBR (a GIMP brush)",
                 "mpeg": "MPEG (PIL reads its header and decodes no frame)",
                 "spider": "SPIDER"}
# bytes that settle the kind of every format but the directory formats
HEAD_BYTES = 4096
DIRECTORY_MAGICS = (b"\0\0\1\0", b"\0\0\2\0", b"\xb1\x68\xde\x3a")  # ICO, CUR, DCX
_SPIDER_IFORMS = (1, 3, -11, -12, -21, -22)


def _is_gbr(data):
    """Whether GbrImagePlugin's open takes ``data`` (a big-endian header:
    its size, a version of 1 or 2, a size and a depth of 1 or 4)."""
    if len(data) < 20:
        return False
    size, version, width, height, depth = struct.unpack(">5I", data[:20])
    if size < 20 or version not in (1, 2) or not (width and height) or depth not in (1, 4):
        return False
    return version == 1 or (len(data) >= 28 and data[20:24] == b"GIMP")


def _is_mpeg(data):
    """Whether MpegImagePlugin's open takes ``data``: its magic and a
    non-empty size in the next 24 bits."""
    return len(data) >= 7 and data[:4] == MPEG_MAGIC and data[4] | (data[5] >> 4) != 0 and \
        (data[5] & 15) | data[6] != 0


def _spider_header(t):
    """SpiderImagePlugin's isSpiderHeader: the header's length, or 0."""
    h = (99,) + t
    for i in (1, 2, 5, 12, 13, 22, 23):
        try:
            if h[i] - int(h[i]) != 0:
                return 0
        except (ValueError, OverflowError):
            return 0
    if int(h[5]) not in _SPIDER_IFORMS:
        return 0
    return int(h[22]) if int(h[22]) == int(h[13]) * int(h[23]) else 0


def _is_spider(data):
    """Whether SpiderImagePlugin's open takes ``data`` (it tries any file)."""
    if len(data) < 108:
        return False
    for order in ">", "<":
        t = struct.unpack(f"{order}27f", data[:108])
        if _spider_header(t):
            h = (99,) + t
            try:
                return int(h[5]) == 1 and int(h[12]) > 0 and int(h[2]) > 0
            except (ValueError, OverflowError):
                return True  # PIL's open raises past its own checks: refused
    return False


def image_kind(data):
    """"png", "jpeg", "bmp", "dib", "webp", "gif", "tiff", "pnm", "cur",
    "pcx", "dcx", "dds", "ico", "psd", "qoi", "sgi", "tga", a refused kind of
    ``REFUSED_KINDS``, or None: the format PIL's ``Image.open`` reads
    ``data`` as (``HEAD_BYTES`` settle it but for ICO, CUR and DCX, whose
    directories may reach further)."""
    data = bytes(data)
    if data[:8] == PNG_MAGIC:
        return "png"
    if data[:2] == JPEG_MAGIC:
        return "jpeg"
    if data[:2] == BMP_MAGIC:
        return "bmp"
    if is_dib(data):
        return "dib"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "webp"
    if data[:6] in GIF_MAGICS:
        return "gif"
    if data[:4] in TIFF_MAGICS:
        return "tiff"
    if is_pnm(data):
        return "pnm"
    if cur_claims(data):
        return "cur"
    native = native_kind(data)
    if native in ("pcx", "dcx", "dds"):
        return native
    if _is_gbr(data):
        return "gbr"
    if ico_claims(data):
        return "ico"
    if _is_mpeg(data):
        return "mpeg"
    if native in ("psd", "qoi", "sgi"):
        return native
    if _is_spider(data):
        return "spider"
    return native


def decode_image(data, name="image", native=True, grey16="pil"):
    """Image bytes of any kind above -> uint8 RGB (H, W, 3)."""
    data = bytes(data)
    kind = image_kind(data)
    if kind is None:
        raise ValueError(f"{name}: not a PNG, JPEG, BMP, WebP, GIF, TIFF or netpbm file, nor a "
                         f"DIB, PSD, DDS, TGA, ICO, CUR, QOI, PCX, DCX or SGI one (the other "
                         f"formats PIL opens are listed in {UNSUPPORTED_ITEM})")
    if kind in REFUSED_KINDS:
        raise ValueError(f"{name}: {REFUSED_KINDS[kind]} is not supported ({UNSUPPORTED_ITEM})")
    if kind == "bmp":
        return decode_bmp(data, name)
    if kind == "dib":
        return decode_dib(data, 0, 0, name)
    if kind == "pnm":
        return decode_pnm(data, name)
    if kind == "cur":
        return decode_cur(data, name)
    if kind == "ico":
        def png(frame, frame_name):
            if native:
                return decode_bytes(frame, frame_name, grey16)
            return as_rgb(decode_png(frame, frame_name, grey16))
        return decode_ico(data, png, name)
    if kind == "png" and not native:
        return as_rgb(decode_png(data, name, grey16))
    return decode_bytes(data, name, grey16)


def file_kind(path):
    """The kind of an image file, from its first bytes (all of them for the
    directory formats)."""
    with open(path, "rb") as f:
        head = f.read(HEAD_BYTES)
        if head[:4] in DIRECTORY_MAGICS:
            head += f.read()
    return image_kind(head)


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
