"""PNG reading and writing with the standard library (zlib, struct) and
numpy, in place of PIL: files (``read_png``, ``write_png``) and bytes
(``decode_png``, ``encode_png``).

``decode_png`` reads every PNG that libpng and PIL read: colour types 0
(grey), 2 (RGB), 3 (palette), 4 (grey and alpha) and 6 (RGBA) at every legal
bit depth, with all five row filters and Adam7 interlacing. Samples come out
as uint8, as PIL's ``convert("RGB")`` and the JAX package's loader make
them: 1-, 2- and 4-bit grey scaled by 255, 85 and 17, palettes looked up
(an index past the palette reads black), 16 bits cut to the high byte.
16-bit grey is the one mode where the JAX package's two decoders differ:
PIL clips it to 255 (``grey16="pil"``, used by ``data.image.read_img`` and the serving
daemon), its native loader keeps the high byte (``grey16="loader"``, the
training pipeline's path). tRNS is ignored, as the RGB conversion drops it.

This is the plain version of the C++ decoder (``csrc/host/loader.cpp``) and
computes what it computes, as libpng does: critical chunks' CRCs are
checked, the image data is one zlib stream in consecutive IDAT chunks, and
nothing after the end of that stream is read. Bodies come
from outside the program (the daemon, the gateway), so decoding is bounded
as PIL bounds it: an image of more than ``MAX_PIXELS`` pixels is refused
from its header, and the image data is inflated no further than the
header's size.
"""

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel; the legal bit depths
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
GREY16_MODES = ("pil", "loader")
# PIL's refusal (DecompressionBombError): twice its MAX_IMAGE_PIXELS
MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)


def _check_pixels(name, width, height):
    if max(width, 1) * max(height, 1) > MAX_PIXELS:
        raise ValueError(f"{name}: image of {width} x {height} pixels exceeds the limit of "
                         f"{MAX_PIXELS} pixels (a decompression bomb?)")


def _chunks(data, name):
    """(type, body, critical) of each chunk, the critical chunks' CRCs
    checked (libpng ignores an ancillary one's). The caller stops at the end
    of the image data; a run of IDAT chunks that ends before it is an error."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos, in_idat = 8, False
    while True:
        if in_idat and data[pos + 4:pos + 8] != b"IDAT":
            raise ValueError(f"{name}: not enough image data")
        if pos + 8 > len(data):
            raise ValueError(f"{name}: truncated PNG (a chunk header is cut)")
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        if length > 0x7FFFFFFF or not kind.isalpha():
            raise ValueError(f"{name}: invalid PNG chunk")
        if pos + 12 + length > len(data):
            raise ValueError(f"{name}: truncated PNG (chunk {kind.decode()} is cut)")
        body = data[pos + 8:pos + 8 + length]
        critical = not kind[0] & 0x20
        if critical and zlib.crc32(kind + body) != struct.unpack(
                ">I", data[pos + 8 + length:pos + 12 + length])[0]:
            raise ValueError(f"{name}: CRC error in PNG chunk {kind.decode()}")
        pos += 12 + length
        in_idat = kind == b"IDAT"
        yield kind, body, critical


def _paeth_row(cur, prev, bpp):
    for i in range(bpp):
        cur[i] = (cur[i] + prev[i]) & 0xFF
    for i in range(bpp, len(cur)):
        a, b, c = cur[i - bpp], prev[i], prev[i - bpp]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        cur[i] = (cur[i] + pred) & 0xFF


def _average_row(cur, prev, bpp):
    for i in range(bpp):
        cur[i] = (cur[i] + (prev[i] >> 1)) & 0xFF
    for i in range(bpp, len(cur)):
        cur[i] = (cur[i] + ((cur[i - bpp] + prev[i]) >> 1)) & 0xFF


def _unfilter(raw, start, height, stride, bpp, name):
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        row_at = start + y * (stride + 1)
        kind = raw[row_at]
        line = np.frombuffer(raw, np.uint8, stride, row_at + 1)
        if kind == 0:
            row = line
        elif kind == 1:  # Sub: running sum per channel, modulo 256
            pad = (-stride) % bpp
            row = np.cumsum(np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(-1, bpp),
                            axis=0, dtype=np.uint8).reshape(-1)[:stride]
        elif kind == 2:  # Up
            row = line + prev
        elif kind in (3, 4):  # Average, Paeth: each byte depends on its left neighbour
            cur = bytearray(line.tobytes())
            (_average_row if kind == 3 else _paeth_row)(cur, prev.tobytes(), bpp)
            row = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"{name}: bad PNG filter type {kind} in row {y}")
        out[y] = row
        prev = out[y]
    return out


def _samples(rows, width, channels, depth):
    """Unfiltered rows -> (h, width, channels) samples as uint16."""
    h = rows.shape[0]
    n = width * channels
    if depth == 8:
        s = rows[:, :n].astype(np.uint16)
    elif depth == 16:
        s = rows[:, :2 * n].reshape(h, n, 2).astype(np.uint16)
        s = (s[:, :, 0] << 8) | s[:, :, 1]
    else:
        bits = np.unpackbits(rows, axis=1)[:, :n * depth].reshape(h, n, depth)
        s = (bits.astype(np.uint16) << np.arange(depth - 1, -1, -1, dtype=np.uint16)).sum(
            axis=2, dtype=np.uint16)
    return s.reshape(h, width, channels)


def decode_png(data, name="PNG", grey16="pil"):
    """Decode PNG bytes to uint8 (H, W, C): C = 1 (grey), 2 (grey, alpha),
    3 (RGB, and palettes) or 4 (RGBA). ``name`` names the source in errors;
    ``grey16`` is "pil" (clip to 255) or "loader" (high byte)."""
    if grey16 not in GREY16_MODES:
        raise ValueError(f"grey16 must be one of {GREY16_MODES}, got {grey16!r}")
    header, palette, raw, inflater = None, None, [], None
    for kind, body, critical in _chunks(data, name):
        if header is None:
            if kind != b"IHDR" or len(body) != 13:
                raise ValueError(f"{name}: PNG without IHDR")
            header = struct.unpack(">IIBBBBB", body)
            width, height, depth, colour, method, filtering, interlace = header
            if not (0 < width < 2**31 and 0 < height < 2**31):
                raise ValueError(f"{name}: invalid PNG image size")
            if depth not in _DEPTHS.get(colour, ()):
                raise ValueError(f"{name}: invalid PNG colour type {colour} with bit depth "
                                 f"{depth}")
            if method or filtering or interlace > 1:
                raise ValueError(f"{name}: invalid PNG compression, filter or interlace method")
            _check_pixels(name, width, height)
            channels = _CHANNELS[colour]
            bits = channels * depth
            passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
            geometry, expected = [], 0
            for x0, y0, dx, dy in passes:
                pw = max(0, (width - x0 + dx - 1) // dx)
                ph = max(0, (height - y0 + dy - 1) // dy)
                stride = (pw * bits + 7) // 8
                geometry.append((pw, ph, stride, expected))
                if pw and ph:
                    expected += ph * (stride + 1)
        elif kind == b"IHDR":
            raise ValueError(f"{name}: duplicate IHDR")
        elif kind == b"IEND":
            raise ValueError(f"{name}: PNG without image data")
        elif kind == b"PLTE":
            if colour == 3:
                if not body or len(body) % 3 or len(body) > 768:
                    raise ValueError(f"{name}: invalid PNG palette length")
                palette = np.zeros((256, 3), np.uint8)
                palette[:len(body) // 3] = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            # inflated as the chunks come, no further than the header's size
            # (one byte past it tells too long from exact); nothing after
            # the end of the zlib stream is read, as libpng reads nothing
            if inflater is None:
                if colour == 3 and palette is None:
                    raise ValueError(f"{name}: PNG palette missing before the image data")
                inflater = zlib.decompressobj()
            room = expected + 1 - sum(map(len, raw))
            try:
                raw.append(inflater.decompress(body, room))
            except zlib.error as e:
                raise ValueError(f"{name}: corrupt image data ({e})") from None
            if sum(map(len, raw)) > expected:
                raise ValueError(f"{name}: image data inflates past its {width} x {height} "
                                 "header")
            if inflater.eof:
                break
        elif critical:
            raise ValueError(f"{name}: unknown critical PNG chunk {kind.decode()}")
    raw = b"".join(raw)
    if len(raw) != expected:
        raise ValueError(f"{name}: not enough image data")

    bpp = max(1, bits // 8)
    out = np.zeros((height, width, channels), np.uint16)
    for (x0, y0, dx, dy), (pw, ph, stride, start) in zip(passes, geometry):
        if pw and ph:
            rows = _unfilter(raw, start, ph, stride, bpp, name)
            out[y0::dy, x0::dx] = _samples(rows, pw, channels, depth)
    if colour == 3:
        return palette[out[:, :, 0]]
    if depth == 16:
        if colour == 0 and grey16 == "pil":
            return np.minimum(out, 255).astype(np.uint8)
        return (out >> 8).astype(np.uint8)
    if depth < 8:
        return (out * (255 // (2**depth - 1))).astype(np.uint8)
    return out.astype(np.uint8)


def read_png(path, grey16="pil"):
    """Decode a PNG file to uint8 (H, W, C), as ``decode_png``."""
    with open(path, "rb") as f:
        return decode_png(f.read(), str(path), grey16)


def read_png_size(path):
    """A PNG's (height, width), from its header alone."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != _SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    width, height = struct.unpack(">II", head[16:24])
    return height, width


def as_rgb(img):
    """uint8 (H, W, C) as RGB (H, W, 3): grey repeated over the channels,
    alpha dropped, as PIL's ``convert("RGB")`` gives it."""
    if img.shape[2] <= 2:
        return np.repeat(img[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def encode_png(img):
    """A uint8 (H, W), (H, W, 1), (H, W, 3) or (H, W, 4) array as PNG
    bytes (filter type 0, zlib level 6)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    colour = {1: 0, 3: 2, 4: 6}.get(img.shape[2]) if img.ndim == 3 else None
    if colour is None:
        raise ValueError(f"encode_png takes 1, 3 or 4 channels, got {img.shape}")
    height, width = img.shape[:2]
    rows = np.concatenate([np.zeros((height, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(height, -1)], axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", width, height, 8, colour, 0, 0, 0)
    return (_SIGNATURE + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def write_png(path, img):
    """Write a uint8 (H, W), (H, W, 1), (H, W, 3) or (H, W, 4) array as PNG."""
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)
