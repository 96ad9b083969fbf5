"""BMP decoding in numpy, to RGB as PIL's ``convert("RGB")`` gives it.

The JAX package reads BMP through PIL (``read_img``, the serving daemon);
the card has no PIL. This decodes what PIL's ``BmpImagePlugin`` reads
without compression: the 12-byte OS/2 core header and the 40- to 124-byte
Windows headers, bottom-up and top-down rows (a negative height), rows
padded to 4 bytes, 1-, 4- and 8-bit palettes (a palette that is the grey
ramp reads as grey, as PIL reads it as mode "L"), 16-bit 5-5-5, 24-bit and
32-bit BI_RGB (the fourth byte ignored), and BI_BITFIELDS with the masks
PIL accepts. RLE and the other compressions raise ``ValueError``; so does a
file that PIL refuses or that ends early. Host work only.
"""

import numpy as np

BMP_MAGIC = b"BM"
UNSUPPORTED_ITEM = "ROADMAP.md, Queue 1, item 3"

_HEADER_SIZES = (12, 40, 52, 56, 64, 108, 124)
_RAW, _RLE8, _RLE4, _BITFIELDS = 0, 1, 2, 3
_COMPRESSION_NAMES = {_RLE8: "RLE8", _RLE4: "RLE4", 4: "JPEG", 5: "PNG", 6: "ALPHABITFIELDS"}
# PIL's accepted bitfield masks, (R, G, B) or (R, G, B, A) by depth
_MASKS = {
    32: {(0xFF0000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0x0),
         (0xFF000000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
         (0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
         (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0x0, 0x0, 0x0, 0x0)},
    24: {(0xFF0000, 0xFF00, 0xFF)},
    16: {(0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F)},
}
_BGRA = (0xFF0000, 0xFF00, 0xFF)  # what PIL reads the all-zero 32-bit masks as


def _u16(data, at):
    return int.from_bytes(data[at:at + 2], "little")


def _u32(data, at):
    return int.from_bytes(data[at:at + 4], "little")


def _channel(pixels, mask):
    """The field of ``mask`` in each pixel, widened to 8 bits as PIL's
    unpackers widen 5- and 6-bit fields (``v * 255 // (2^bits - 1)``)."""
    shift = (mask & -mask).bit_length() - 1
    bits = bin(mask).count("1")
    v = (pixels & mask) >> shift
    if bits >= 8:
        return (v >> (bits - 8)).astype(np.uint8)
    return (v * 255 // ((1 << bits) - 1)).astype(np.uint8)


def decode_bmp(data, name="image"):
    """BMP bytes -> uint8 RGB (H, W, 3)."""
    data = bytes(data)
    if data[:2] != BMP_MAGIC or len(data) < 18:
        raise ValueError(f"{name}: not a BMP file")
    offset = _u32(data, 10)
    header_size = _u32(data, 14)
    if header_size not in _HEADER_SIZES:
        raise ValueError(f"{name}: unsupported BMP header size {header_size}")
    head = data[18:14 + header_size]
    if len(head) != header_size - 4:
        raise ValueError(f"{name}: truncated BMP header")
    pos = 14 + header_size
    if header_size == 12:
        width, height, bits = _u16(head, 0), _u16(head, 2), _u16(head, 6)
        compression, colors, entry, top_down = _RAW, 0, 3, False
    else:
        top_down = head[7] == 0xFF
        width, height = _u32(head, 0), _u32(head, 4)
        if top_down:
            height = 2 ** 32 - height
        bits, compression, colors, entry = _u16(head, 10), _u32(head, 12), _u32(head, 28), 4
    if compression in _COMPRESSION_NAMES:
        raise ValueError(f"{name}: BMP {_COMPRESSION_NAMES[compression]} compression is not "
                         f"supported ({UNSUPPORTED_ITEM})")
    if compression not in (_RAW, _BITFIELDS):
        raise ValueError(f"{name}: unsupported BMP compression {compression}")
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"{name}: unsupported BMP pixel depth {bits}")
    if width <= 0 or height <= 0:
        raise ValueError(f"{name}: bad BMP size {width} x {height}")

    masks = None
    if compression == _BITFIELDS:
        if len(head) >= 48:
            masks = tuple(_u32(head, 36 + 4 * i) for i in range(4 if len(head) >= 52 else 3))
        else:
            masks = tuple(_u32(data, pos + 4 * i) for i in range(3))
            pos += 12
        masks = masks + (0,) * (4 - len(masks))
        accepted = _MASKS.get(bits, set())
        if not (masks in accepted if bits == 32 else masks[:3] in accepted):
            raise ValueError(f"{name}: unsupported BMP bitfields layout {masks} at {bits} bits")
        if masks == (0, 0, 0, 0):
            masks = _BGRA + (0,)
    elif bits == 16:
        masks = (0x7C00, 0x3E0, 0x1F, 0)
    colors = colors or (1 << bits)
    if offset == pos and bits <= 8:
        offset += 4 * colors  # PIL's reading of a pixel offset that forgot the palette

    stride = ((width * bits + 31) >> 3) & ~3
    if offset + stride * height > len(data):
        raise ValueError(f"{name}: truncated BMP pixel data")
    rows = np.frombuffer(data, np.uint8, count=stride * height, offset=offset)
    rows = rows.reshape(height, stride)
    if not top_down:
        rows = rows[::-1]

    if bits <= 8:
        if not 0 < colors <= 65536:
            raise ValueError(f"{name}: unsupported BMP palette size {colors}")
        pal = np.frombuffer(data[pos:pos + entry * colors], np.uint8)
        if pal.size != entry * colors:
            raise ValueError(f"{name}: truncated BMP palette")
        pal = pal.reshape(colors, entry)[:, 2::-1]  # BGR(X) -> RGB
        idx = np.unpackbits(rows, axis=1)[:, :width * bits] if bits < 8 else rows[:, :width]
        if bits < 8:
            idx = idx.reshape(height, width, bits) @ (1 << np.arange(bits - 1, -1, -1))
        ramp = (0, 255) if colors == 2 else range(colors)
        if all(tuple(pal[i]) == (v, v, v) for i, v in enumerate(ramp)):
            # PIL reads a grey-ramp palette as mode "1" or "L": the index is the value
            grey = (idx * 255 if colors == 2 else idx).astype(np.uint8)
            return np.repeat(grey[:, :, None], 3, axis=2)
        full = np.zeros((256, 3), np.uint8)  # an index past the palette reads black
        full[:min(colors, 256)] = pal[:256]
        return full[idx]
    if bits == 24:
        return np.ascontiguousarray(rows[:, :3 * width].reshape(height, width, 3)[:, :, ::-1])
    if bits == 32 and masks is None:
        return np.ascontiguousarray(rows[:, :4 * width].reshape(height, width, 4)[:, :, 2::-1])
    nbytes = bits // 8
    px = rows[:, :nbytes * width].reshape(height, width, nbytes).astype(np.uint32)
    px = sum(px[:, :, i] << (8 * i) for i in range(nbytes))
    return np.stack([_channel(px, m) for m in masks[:3]], axis=2)
