"""PNG reading and writing with the standard library (zlib, struct) and
numpy, in place of PIL: files (``read_png``, ``write_png``) and bytes
(``decode_png``, ``encode_png``, as the serving daemon and gateway use them).

``read_img`` reads 8-bit, non-interlaced PNGs of colour type 0 (grey),
2 (RGB) and 6 (RGBA), with all five row filters, to float32 [0, 255] RGB
HWC, as simplesr_tpu.data.read_img does through PIL's ``convert("RGB")``
(grey is repeated over the channels, alpha is dropped). Anything else raises.
Bodies come from outside the program (the daemon, the gateway), so decoding
is bounded as PIL bounds it: an image of more than ``MAX_PIXELS`` pixels is
refused from its header, and the image data is inflated no further than the
header's size.
"""

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}
# PIL's refusal (DecompressionBombError): twice its MAX_IMAGE_PIXELS
MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)


def _chunks(data):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG ends without IEND")


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


def _unfilter(raw, height, stride, bpp):
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        start = y * (stride + 1)
        kind = raw[start]
        line = np.frombuffer(raw, np.uint8, stride, start + 1)
        if kind == 0:
            row = line
        elif kind == 1:  # Sub: running sum per channel, modulo 256
            row = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            row = line + prev
        elif kind in (3, 4):  # Average, Paeth: each byte depends on its left neighbour
            cur = bytearray(line.tobytes())
            (_average_row if kind == 3 else _paeth_row)(cur, prev.tobytes(), bpp)
            row = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {kind} in row {y}")
        out[y] = row
        prev = out[y]
    return out


def decode_png(data, name="PNG"):
    """Decode PNG bytes to uint8 (H, W, C), C = 1, 3 or 4 as stored.
    ``name`` names the source in errors."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{name}: PNG without IHDR")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise ValueError(f"{name}: only 8-bit, non-interlaced grey, RGB or RGBA PNGs "
                         f"are read (depth {depth}, colour type {colour}, "
                         f"interlace {interlace})")
    if max(width, 1) * max(height, 1) > MAX_PIXELS:
        raise ValueError(f"{name}: image of {width} x {height} pixels exceeds the limit of "
                         f"{MAX_PIXELS} pixels (a decompression bomb?)")
    channels = _CHANNELS[colour]
    stride = width * channels
    expected = height * (stride + 1)
    try:  # one byte past the header's size tells too long from exact
        raw = zlib.decompressobj().decompress(b"".join(idat), expected + 1)
    except zlib.error as e:
        raise ValueError(f"{name}: corrupt image data ({e})") from None
    if len(raw) > expected:
        raise ValueError(f"{name}: image data inflates past its {width} x {height} header")
    if len(raw) != expected:
        raise ValueError(f"{name}: image data has the wrong length")
    return _unfilter(raw, height, stride, channels).reshape(height, width, channels)


def read_png(path):
    """Decode a PNG file to uint8 (H, W, C), C = 1, 3 or 4 as stored."""
    with open(path, "rb") as f:
        return decode_png(f.read(), str(path))


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
    if img.shape[2] == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def read_rgb_u8(path):
    """Decode a PNG file to uint8 RGB (H, W, 3)."""
    return as_rgb(read_png(path))


def read_img(fpath):
    """Decode an image file to float32 [0, 255] RGB HWC."""
    return read_rgb_u8(fpath).astype(np.float32)


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
