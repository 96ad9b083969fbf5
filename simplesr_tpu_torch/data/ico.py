"""ICO and CUR decoding, to RGB as PIL 12.1's ``convert("RGB")`` gives it.

The JAX package reads icons and cursors through PIL (``read_img``, the
serving daemon); the card has no PIL. This reads the frame PIL reads:

- ICO (``IcoImagePlugin``): the directory's entries sorted, stably, by
  colour depth (the entry's bit count, else the bits its colour count
  needs, else 256) and then by area, largest first; the first of them. A
  PNG frame decodes through the port's PNG decoder; a DIB frame (1, 4, 8,
  16, 24 or 32 bits, BI_RGB, bitfields or RLE) through ``data/bmp.py``'s
  ``decode_dib``, its height halved for the AND mask. The masks only make
  alpha, which RGB drops, but PIL reads them, so a frame whose AND mask (or,
  at 32 bits as the directory says, whose alpha bytes) runs past the file
  is refused, as PIL refuses it.
- CUR (``CurImagePlugin``): the first entry, replaced by each later one
  larger in both width and height (bytes 0 and 1, as they stand); its DIB
  read at its offset (at 0, right after the directory, as PIL's read of
  offset 0 is), height halved. PNG cursors are refused, as PIL refuses them.

Where PIL's open rejects the file in a way that lets ``Image.open`` try the
next plugin (no entries, a directory or a frame header cut short, an empty
frame, a PNG frame whose chunks before the image data are broken), the file
is not claimed (``ico_claims`` / ``cur_claims`` say False), and
``data/image.py`` goes on to the later kinds, TGA included. Host work only.
"""

import math
import re
import struct
import zlib

from simplesr_tpu_torch.data.bmp import decode_dib, dib_pixel_offset
from simplesr_tpu_torch.data.png import _SIGNATURE as PNG_MAGIC

ICO_MAGIC = b"\0\0\1\0"
CUR_MAGIC = b"\0\0\2\0"
# PngImagePlugin's (bit depth, colour type) pairs: others have no mode
_PNG_MODES = {(1, 0), (2, 0), (4, 0), (8, 0), (16, 0), (8, 2), (16, 2), (1, 3), (2, 3), (4, 3),
              (8, 3), (8, 4), (16, 4), (8, 6), (16, 6)}
_CID = re.compile(rb"\w\w\w\w")


class NotThisFormat(Exception):
    """PIL's plugin rejects the file at open time with an error that
    Image.open takes as "try the next plugin"."""


def _u16(data, at):
    return struct.unpack_from("<H", data, at)[0]


def _u32(data, at):
    return struct.unpack_from("<I", data, at)[0]


def _png_frame_opens(data, at):
    """Walk a PNG frame's chunks up to its image data as PngImageFile's open
    does; raise NotThisFormat where that open fails as not a PNG."""
    pos, ihdr = at + 8, None
    while True:
        head = data[pos:pos + 8]
        if len(head) < 4 or not _CID.match(head[4:]):
            raise NotThisFormat
        length, cid = struct.unpack(">I", head[:4])[0], head[4:]
        pos += 8
        if cid in (b"IDAT", b"IEND"):
            break
        body = data[pos:pos + length]
        if len(body) < length:
            raise ValueError("ICO: a PNG frame's chunk is truncated")
        if cid == b"IHDR":
            if length < 13:
                raise ValueError("ICO: a PNG frame's IHDR is truncated")
            if body[11]:
                raise NotThisFormat  # "unknown filter category"
            ihdr = body
        crc = data[pos + length:pos + length + 4]
        if len(crc) < 4 or struct.unpack(">I", crc)[0] != zlib.crc32(cid + body):
            raise NotThisFormat  # "broken PNG file"
        pos += length + 4
    if ihdr is None or (ihdr[8], ihdr[9]) not in _PNG_MODES or \
            not (struct.unpack(">I", ihdr[:4])[0] and struct.unpack(">I", ihdr[4:8])[0]):
        raise NotThisFormat  # no mode or an empty size


def _colour_depth(bpp, colours):
    return bpp or (colours != 0 and math.ceil(math.log(colours, 2))) or 256


def _ico_frame(data):
    """(offset, directory bpp, size field, is PNG) of the frame PIL reads."""
    if data[:4] != ICO_MAGIC:
        raise NotThisFormat
    try:
        count = _u16(data, 4)
        entries = []
        for i in range(count):
            s = data[6 + 16 * i:22 + 16 * i]
            width, height = s[0] or 256, s[1] or 256
            colours, bpp = s[2], _u16(s, 6)
            entries.append((width * height, _colour_depth(bpp, colours), bpp, _u32(s, 8),
                            _u32(s, 12)))
    except (IndexError, struct.error) as e:
        raise NotThisFormat from e
    entries = sorted(entries, key=lambda e: e[1])
    entries = sorted(entries, key=lambda e: e[0], reverse=True)
    if not entries:
        raise NotThisFormat
    _, _, bpp, size, offset = entries[0]
    is_png = data[offset:offset + 8] == PNG_MAGIC
    if is_png:
        _png_frame_opens(data, offset)
    else:
        _dib_opens(data, offset)
    return offset, bpp, size, is_png


def _dib_opens(data, at):
    """BmpImageFile's open of a DIB at ``at``, as far as it lets Image.open
    try the next plugin: a header size cut short, or an empty size."""
    if len(data) - at < 4 or at > len(data):
        raise NotThisFormat
    header_size = _u32(data, at)
    head = data[at + 4:at + header_size]
    if header_size == 12 and len(head) == 8:
        width, height = _u16(head, 0), _u16(head, 2)
    elif header_size in (40, 52, 56, 64, 108, 124) and len(head) == header_size - 4:
        width, height = _u32(head, 0), _u32(head, 4)
        if head[7] == 0xFF:
            height = 2 ** 32 - height
    else:
        return  # PIL refuses it (OSError): decode_dib says why
    if width <= 0 or height <= 0:
        raise NotThisFormat
    return width, height


def ico_claims(data):
    """Whether PIL's ICO plugin takes ``data`` (to decode it or to refuse it)."""
    try:
        _ico_frame(data)
    except NotThisFormat:
        return False
    except ValueError:
        return True
    return True


def _cur_entry(data):
    """The DIB offset of the cursor PIL reads, as CurImageFile._open finds it."""
    if data[:4] != CUR_MAGIC:
        raise NotThisFormat
    try:
        pos, m = 6, b""
        for _ in range(_u16(data, 4)):
            s = data[pos:pos + 16]
            pos += len(s)
            if not m:
                m = s
            elif s[0] > m[0] and s[1] > m[1]:
                m = s
        if not m:
            raise NotThisFormat  # "No cursors were found" (TypeError)
        at = _u32(m, 12) or pos  # offset 0: PIL reads on where the directory ends
    except (IndexError, struct.error) as e:
        raise NotThisFormat from e
    size = _dib_opens(data, at)
    if size and size[1] // 2 <= 0:
        raise NotThisFormat  # the halved size is empty
    return at


def cur_claims(data):
    """Whether PIL's CUR plugin takes ``data`` (to decode it or to refuse it)."""
    try:
        _cur_entry(data)
    except NotThisFormat:
        return False
    return True


def decode_ico(data, decode_png_bytes, name="image"):
    """ICO bytes -> uint8 RGB (H, W, 3). ``decode_png_bytes`` decodes a PNG
    frame (the port's C++ PNG decoder, passed in by ``data/image.py``)."""
    data = bytes(data)
    try:
        offset, bpp, size, is_png = _ico_frame(data)
    except NotThisFormat as e:
        raise ValueError(f"{name}: not an ICO file") from e
    if is_png:
        return decode_png_bytes(data[offset:], name)
    rgb = decode_dib(data, offset, 0, name, halve=True)
    h, w = rgb.shape[:2]
    if bpp == 32:  # PIL reads every fourth byte of 4 * w * h from the pixels as alpha
        if len(data) - dib_pixel_offset(data, offset) < 4 * w * h:
            raise ValueError(f"{name}: ICO: the frame's alpha bytes run past the file "
                             f"(PIL refuses it too)")
    else:  # the AND mask, 1 bit a pixel, rows of 32-bit words, before the entry's end
        total = ((w + 31) // 32 * 32) * h // 8
        at = offset + size - total
        if at < 0 or len(data) - at < total:
            raise ValueError(f"{name}: ICO: the frame's AND mask runs past the file or its "
                             f"entry (PIL refuses it too)")
    return rgb


def decode_cur(data, name="image"):
    """CUR bytes -> uint8 RGB (H, W, 3)."""
    data = bytes(data)
    try:
        at = _cur_entry(data)
    except NotThisFormat as e:
        raise ValueError(f"{name}: not a CUR file") from e
    return decode_dib(data, at, 0, name, halve=True, check_halved=True)
