"""Netpbm decoding in Python/numpy (P1 to P6: PBM, PGM and PPM, plain and
raw), to RGB as PIL 12.1's ``PpmImagePlugin`` and ``convert("RGB")`` give
it. The JAX package reads these files through PIL (``read_img``, the
serving daemon); the card has no PIL.

The header is read as PIL reads it: the magic up to 6 bytes or whitespace,
then tokens of at most 10 bytes, a ``#`` starting a comment to the end of
the line anywhere in the header, one whitespace byte after the last token.
Samples are scaled as PIL scales them:

- a maxval of 255 reads as stored; a raw PGM with maxval 65535 as 16-bit
  big-endian grey;
- any other maxval ``m`` scales a sample ``v`` to ``round(v / m * 255)``
  (Python's rounding, half to even), or for grey with ``m`` over 255 to
  ``round(v / m * 65535)``, PIL's mode "I";
- convert("RGB") clips mode "I" to 255.

Plain files (P1 to P3) skip comments in their data too; a plain sample
above maxval, a token over 10 bytes, or a file that ends before the image
is complete is refused, as PIL refuses it. PIL's own extensions (Pf, P0CMYK,
PyP, PyRGBA, PyCMYK) are refused by name. Host work only.
"""

from array import array

import numpy as np

from simplesr_tpu_torch.data.png import _check_pixels

UNSUPPORTED_ITEM = "ROADMAP.md, Queue 1, item 3"
_WHITESPACE = b"\x20\x09\x0a\x0b\x0c\x0d"
_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB"}
_EXTENSIONS = {b"P0CMYK", b"Pf", b"PyP", b"PyRGBA", b"PyCMYK"}
_BLOCK = 1024 * 1024  # PIL's SAFEBLOCK: plain data is read in blocks of this size


def is_pnm(head):
    """Whether PIL's netpbm plugin accepts the first bytes."""
    return len(head) >= 2 and head[:1] == b"P" and head[1] in b"0123456fy"


class _Reader:
    def __init__(self, data):
        self.data, self.pos = data, 0

    def read(self, n):
        out = self.data[self.pos:self.pos + n]
        self.pos += len(out)
        return out

    def magic(self):
        magic = b""
        for _ in range(6):
            c = self.read(1)
            if not c or c in _WHITESPACE:
                break
            magic += c
        return magic

    def token(self, name):
        token = b""
        while len(token) <= 10:
            c = self.read(1)
            if not c:
                break
            if c in _WHITESPACE:
                if not token:
                    continue
                break
            if c == b"#":
                while self.read(1) not in b"\r\n":  # b"" (the end) is in it too
                    pass
                continue
            token += c
        if not token:
            raise ValueError(f"{name}: netpbm header ends early")
        if len(token) > 10:
            raise ValueError(f"{name}: netpbm header token too long")
        return int(token)


def _strip_comments(block, spans):
    """PIL's PpmPlainDecoder._ignore_comments: the block without comments,
    and whether a comment runs on into the next block."""
    def comment_end(b, start=0):
        a, c = b.find(b"\n", start), b.find(b"\r", start)
        return min(a, c) if a * c > 0 else max(a, c)

    if spans:
        end = comment_end(block)
        if end == -1:
            return b"", True  # the comment runs on: the caller reads the next block
        block = block[end + 1:]
    while True:
        start = block.find(b"#")
        if start == -1:
            return block, False
        end = comment_end(block, start)
        if end == -1:
            return block[:start], True
        block = block[:start] + block[end + 1:]


def _plain_bits(reader, total, name):
    data, spans = bytearray(), False
    while len(data) != total:
        block = reader.read(_BLOCK)
        if not block:
            break
        block, spans = _strip_comments(block, spans)
        tokens = b"".join(block.split())
        if any(t not in (48, 49) for t in tokens):
            raise ValueError(f"{name}: bad plain PBM sample")
        data = (data + tokens)[:total]
    if len(data) < total:
        raise ValueError(f"{name}: truncated netpbm data")
    return np.where(np.frombuffer(bytes(data), np.uint8) == 49, 0, 255).astype(np.uint8)


def _plain_values(reader, total, maxval, out_max, name):
    values, half, spans = array("q"), b"", False
    while len(values) != total:
        block = reader.read(_BLOCK)
        if not block:
            if not half:
                break
            block = b" "
        block, spans = _strip_comments(block, spans)
        if half:
            block, half = half + block, b""
        tokens = block.split()
        if block and not block[-1:].isspace():
            half = tokens.pop()
            if len(half) > 10:
                raise ValueError(f"{name}: netpbm data token too long")
        for token in tokens:
            if len(token) > 10:
                raise ValueError(f"{name}: netpbm data token too long")
            v = int(token)
            if v < 0 or v > maxval:
                raise ValueError(f"{name}: netpbm sample {v} outside 0 to {maxval}")
            values.append(round(v / maxval * out_max))
            if len(values) == total:
                break
    if len(values) < total:
        raise ValueError(f"{name}: truncated netpbm data")
    return np.frombuffer(values, np.int64)


def decode_pnm(data, name="image"):
    """PBM, PGM or PPM bytes -> uint8 RGB (H, W, 3)."""
    data = bytes(data)
    reader = _Reader(data)
    magic = reader.magic()
    if magic in _EXTENSIONS:
        raise ValueError(f"{name}: netpbm {magic.decode()} is not supported ({UNSUPPORTED_ITEM})")
    if magic not in _MODES:
        raise ValueError(f"{name}: not a netpbm file")
    mode = _MODES[magic]
    width, height = reader.token(name), reader.token(name)
    if width <= 0 or height <= 0:
        raise ValueError(f"{name}: bad netpbm size {width} x {height}")
    _check_pixels(name, width, height)
    bands = 3 if mode == "RGB" else 1
    total = width * height * bands
    plain = magic in (b"P1", b"P2", b"P3")
    if mode == "1":
        if plain:
            grey = _plain_bits(reader, width * height, name)
        else:
            stride = (width + 7) // 8
            raw = reader.read(stride * height)
            if len(raw) < stride * height:
                raise ValueError(f"{name}: truncated netpbm data")
            bits = np.unpackbits(np.frombuffer(raw, np.uint8).reshape(height, stride), axis=1)
            grey = np.where(bits[:, :width] == 1, 0, 255).astype(np.uint8)
        return np.repeat(grey.reshape(height, width, 1), 3, axis=2)

    maxval = reader.token(name)
    if not 0 < maxval < 65536:
        raise ValueError(f"{name}: netpbm maxval must be between 1 and 65535, got {maxval}")
    wide = mode == "L" and maxval > 255  # PIL's mode "I"
    out_max = 65535 if wide else 255
    if plain:
        values = _plain_values(reader, total, maxval, out_max, name)
    else:
        nbytes = 1 if maxval < 256 else 2
        raw = reader.read(total * nbytes)
        if len(raw) < total * nbytes:
            raise ValueError(f"{name}: truncated netpbm data")
        values = np.frombuffer(raw, np.uint8 if nbytes == 1 else ">u2").astype(np.int64)
        if not (maxval == 255 or (maxval == 65535 and mode == "L")):
            values = np.minimum(out_max, np.round(values / maxval * out_max)).astype(np.int64)
    img = np.minimum(values, 255).astype(np.uint8).reshape(height, width, bands)
    return img if bands == 3 else np.repeat(img, 3, axis=2)
