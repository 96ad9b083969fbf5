"""BMP decoding in numpy, to RGB as PIL's ``convert("RGB")`` gives it.

The JAX package reads BMP through PIL (``read_img``, the serving daemon);
the card has no PIL. This decodes what PIL's ``BmpImagePlugin`` reads
without compression: the 12-byte OS/2 core header and the 40- to 124-byte
Windows headers, bottom-up and top-down rows (a negative height), rows
padded to 4 bytes, 1-, 4- and 8-bit palettes (a palette that is the grey
ramp reads as grey, as PIL reads it as mode "L"), 16-bit 5-5-5, 24-bit and
32-bit BI_RGB (the fourth byte ignored), and BI_BITFIELDS with the masks
PIL accepts, and RLE8 and RLE4 as PIL's ``BmpRleDecoder`` reads them
(escapes for end of line, end of bitmap and delta, absolute runs aligned to
an even file offset, pixels it skips left at palette index 0). PIL 12.1's
delta escape reads four bytes and moves by the last two; an odd absolute
RLE4 run gives one pixel fewer than its count; both are read as PIL reads
them. JPEG, PNG and ALPHABITFIELDS compressions raise ``ValueError``, as
PIL 12.1 refuses them too ("Unsupported BMP compression"); so does a file
that PIL refuses or that ends early (PIL also refuses an RLE bitmap that
ends before its last pixel). ``decode_dib`` reads the same bitmaps from a
header anywhere in a buffer, as a DIB file holds them at its start and the
ICO and CUR frames hold them (``data/ico.py``). Host work only.
"""

import numpy as np

from simplesr_tpu_torch.data.png import _check_pixels

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


def _paletted(idx, data, pos, entry, colors, name, rle=False):
    """Palette indices (H, W) -> RGB through the file's palette at ``pos``."""
    if not 0 < colors <= 256:  # PIL's palettes hold 256 entries at most
        raise ValueError(f"{name}: unsupported BMP palette size {colors}")
    pal = np.frombuffer(data[pos:pos + entry * colors], np.uint8)
    if pal.size != entry * colors:
        raise ValueError(f"{name}: truncated BMP palette")
    pal = pal.reshape(colors, entry)[:, 2::-1]  # BGR(X) -> RGB
    ramp = (0, 255) if colors == 2 else range(colors)
    if all(tuple(pal[i]) == (v, v, v) for i, v in enumerate(ramp)):
        if rle and colors == 2:  # PIL has no "P" rawmode into its mode "1"
            raise ValueError(f"{name}: BMP RLE with a black-and-white palette is not "
                             f"supported ({UNSUPPORTED_ITEM})")
        # PIL reads a grey-ramp palette as mode "1" or "L": the index is the value
        grey = (idx * 255 if colors == 2 else idx).astype(np.uint8)
        return np.repeat(grey[:, :, None], 3, axis=2)
    full = np.zeros((256, 3), np.uint8)  # an index past the palette reads black
    full[:min(colors, 256)] = pal[:256]
    return full[idx]


def _rle_indices(data, offset, width, height, rle4, name):
    """The palette indices of an RLE8 or RLE4 bitmap, rows in file order, as
    PIL's BmpRleDecoder produces them."""
    dest = width * height
    out = bytearray()
    x, pos, n = 0, offset, len(data)
    while len(out) < dest:
        if pos + 2 > n:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:  # a run of one byte (two alternating nibbles in RLE4)
            count = max(0, min(count, width - x))
            if rle4:
                out += bytes((byte >> 4, byte & 0x0F)) * (count // 2) + \
                    (bytes((byte >> 4,)) if count % 2 else b"")
            else:
                out += bytes((byte,)) * count
            x += count
        elif byte == 0:  # end of line
            out += bytes(-len(out) % width)
            x = 0
        elif byte == 1:  # end of bitmap
            break
        elif byte == 2:  # delta: PIL reads two bytes, then moves by the next two
            if pos + 2 > n:
                break
            if pos + 4 > n:
                raise ValueError(f"{name}: truncated BMP RLE delta")
            right, up = data[pos + 2], data[pos + 3]
            pos += 4
            out += bytes(min(right + up * width, dest - len(out)))  # no further than the end
            x = len(out) % width
        else:  # an absolute run, then to an even offset in the file
            take = byte // 2 if rle4 else byte
            chunk = data[pos:pos + take]
            pos += len(chunk)
            if rle4:
                out += bytes(v for b in chunk for v in (b >> 4, b & 0x0F))
            else:
                out += chunk
            if len(chunk) < take:
                break
            x += byte
            pos += pos % 2
    if len(out) < dest:
        raise ValueError(f"{name}: the BMP RLE data ends before the image is complete")
    return np.frombuffer(bytes(out[:dest]), np.uint8).reshape(height, width)


def decode_bmp(data, name="image"):
    """BMP bytes -> uint8 RGB (H, W, 3)."""
    data = bytes(data)
    if data[:2] != BMP_MAGIC or len(data) < 18:
        raise ValueError(f"{name}: not a BMP file")
    return decode_dib(data, 14, _u32(data, 10), name)


def is_dib(data):
    """Whether PIL's DIB plugin takes ``data``: a BMP header size in its
    first four bytes (a BMP file without its 14-byte file header)."""
    return len(data) >= 4 and _u32(data, 0) in _HEADER_SIZES


def dib_pixel_offset(data, at):
    """Where the pixels of the DIB whose header starts at ``at`` begin when
    no offset says: after the header, a 40-byte header's bitfield masks and
    the palette, where PIL's reading goes on. The header must be whole."""
    header_size = _u32(data, at)
    bits = _u16(data, at + (10 if header_size == 12 else 14))
    pos = at + header_size
    if header_size == 40 and _u32(data, at + 16) == _BITFIELDS:
        pos += 12
    if bits > 8:
        return pos
    if header_size == 12:
        return pos + 3 * (1 << bits)
    return pos + 4 * (_u32(data, at + 32) or (1 << bits))


def decode_dib(data, at, offset, name="image", halve=False, check_halved=False):
    """The bitmap whose header (its size first) starts at ``at`` in ``data``
    -> uint8 RGB, as PIL's ``BmpImageFile._bitmap`` reads it. ``offset`` is
    the pixels' offset in ``data``, or 0 for right after the header and the
    palette. ``halve`` keeps the first half of the rows (an icon's or a
    cursor's XOR bitmap, its AND mask after them); the bomb check takes the
    halved size with ``check_halved`` (a cursor's), else the whole (an
    icon's DIB)."""
    data = bytes(data)
    header_size = _u32(data, at)
    if header_size not in _HEADER_SIZES:
        raise ValueError(f"{name}: unsupported BMP header size {header_size}")
    head = data[at + 4:at + header_size]
    if len(head) != header_size - 4:
        raise ValueError(f"{name}: truncated BMP header")
    pos = at + header_size
    if header_size == 12:
        width, height, bits = _u16(head, 0), _u16(head, 2), _u16(head, 6)
        compression, colors, entry, top_down = _RAW, 0, 3, False
    else:
        top_down = head[7] == 0xFF
        width, height = _u32(head, 0), _u32(head, 4)
        if top_down:
            height = 2 ** 32 - height
        bits, compression, colors, entry = _u16(head, 10), _u32(head, 12), _u32(head, 28), 4
    rle = compression in (_RLE8, _RLE4)
    if compression in _COMPRESSION_NAMES and not rle:
        raise ValueError(f"{name}: BMP {_COMPRESSION_NAMES[compression]} compression is not "
                         f"supported: PIL refuses it too ({UNSUPPORTED_ITEM})")
    if compression not in (_RAW, _BITFIELDS) and not rle:
        raise ValueError(f"{name}: unsupported BMP compression {compression}")
    if rle and bits not in (4, 8):
        raise ValueError(f"{name}: BMP {_COMPRESSION_NAMES[compression]} compression of "
                         f"{bits}-bit pixels is not supported ({UNSUPPORTED_ITEM})")
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"{name}: unsupported BMP pixel depth {bits}")
    rows = height // 2 if halve else height
    if width <= 0 or rows <= 0:
        raise ValueError(f"{name}: bad BMP size {width} x {rows}")
    _check_pixels(name, width, rows if check_halved else height)
    height = rows

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
    if offset == at + header_size and bits <= 8:
        offset += 4 * colors  # PIL's reading of a pixel offset that forgot the palette
    offset = offset or dib_pixel_offset(data, at)

    if rle:
        idx = _rle_indices(data, offset, width, height, compression == _RLE4, name)
        if not top_down:
            idx = idx[::-1]
        return _paletted(idx, data, pos, entry, colors, name, rle=True)

    stride = ((width * bits + 31) >> 3) & ~3
    if offset + stride * height > len(data):
        raise ValueError(f"{name}: truncated BMP pixel data")
    rows = np.frombuffer(data, np.uint8, count=stride * height, offset=offset)
    rows = rows.reshape(height, stride)
    if not top_down:
        rows = rows[::-1]

    if bits <= 8:
        idx = np.unpackbits(rows, axis=1)[:, :width * bits] if bits < 8 else rows[:, :width]
        if bits < 8:
            idx = idx.reshape(height, width, bits) @ (1 << np.arange(bits - 1, -1, -1))
        return _paletted(idx, data, pos, entry, colors, name)
    if bits == 24:
        return np.ascontiguousarray(rows[:, :3 * width].reshape(height, width, 3)[:, :, ::-1])
    if bits == 32 and masks is None:
        return np.ascontiguousarray(rows[:, :4 * width].reshape(height, width, 4)[:, :, 2::-1])
    nbytes = bits // 8
    px = rows[:, :nbytes * width].reshape(height, width, nbytes).astype(np.uint32)
    px = sum(px[:, :, i] << (8 * i) for i in range(nbytes))
    return np.stack([_channel(px, m) for m in masks[:3]], axis=2)
