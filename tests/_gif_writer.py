"""GIF files with what Pillow's writer does not make: a frame smaller than
the logical screen or placed at an offset, a local palette beside the
global one, any palette size and LZW code size, interlacing by choice.
Pillow decodes them, so its decode stays the judge of the port's.

The LZW coder mirrors the decoder's table (Pillow's GifDecode.c): the code
size grows when the entry 2^size - 1 is added, and the table is cleared
when it is full, so that any reader of the format decodes the same stream.
"""

import struct

import numpy as np

_INTERLACE = ((0, 8), (4, 8), (2, 4), (1, 2))


def lzw_encode(indices, min_size):
    """The LZW code stream of ``indices`` as GIF sub-blocks' payload bytes."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    out, acc, nacc = bytearray(), 0, 0
    size = min_size + 1

    def emit(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += size
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

    def reset():
        return {(i,): i for i in range(clear)}, eoi + 1, min_size + 1, 0

    table, nxt, size, emitted = reset()
    emit(clear)
    w = ()
    for k in (int(v) for v in indices):
        if w + (k,) in table:
            w = w + (k,)
            continue
        emit(table[w])
        emitted += 1
        if emitted >= 2 and nxt < 4096:  # the decoder adds an entry now
            if nxt == (1 << size) - 1 and size < 12:
                size += 1
            nxt += 1
        if len(table) + 2 < 4096:
            table[w + (k,)] = len(table) + 2
        else:
            emit(clear)
            table, nxt, size, emitted = reset()
        w = (k,)
    if w:
        emit(table[w])
    emit(eoi)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def _blocks(data):
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\0"


def _palette(pal, bits):
    pal = np.asarray(pal, np.uint8).reshape(-1, 3)
    full = np.zeros((1 << bits, 3), np.uint8)
    full[:len(pal)] = pal
    return full.tobytes()


def write_gif(indices, global_palette=None, local_palette=None, screen=None, offset=(0, 0),
              interlace=False, transparency=None, min_code_size=None, version=b"GIF89a",
              global_bits=None, local_bits=None, trailer=True):
    """A one-frame GIF of the palette ``indices`` (H, W), placed at
    ``offset`` (x, y) on a ``screen`` (W, H), the frame's size by default.
    Palettes are (N, 3) arrays written into tables of 2^bits entries."""
    indices = np.asarray(indices, np.uint8)
    h, w = indices.shape
    sw, sh = screen or (w + offset[0], h + offset[1])
    head = version + struct.pack("<HHBBB", sw, sh, 0, 0, 0)
    flags = 0
    if global_palette is not None:
        gbits = global_bits or max(1, int(np.ceil(np.log2(max(len(global_palette), 2)))))
        flags = 0x80 | 0x70 | (gbits - 1)
        head = head[:10] + bytes([flags]) + head[11:] + _palette(global_palette, gbits)
    body = b""
    if transparency is not None:
        body += b"\x21\xf9\x04" + struct.pack("<BHB", 1, 0, transparency) + b"\0"
    lflags = 0x40 if interlace else 0
    lpal = b""
    if local_palette is not None:
        lbits = local_bits or max(1, int(np.ceil(np.log2(max(len(local_palette), 2)))))
        lflags |= 0x80 | (lbits - 1)
        lpal = _palette(local_palette, lbits)
    body += b"\x2c" + struct.pack("<HHHHB", offset[0], offset[1], w, h, lflags) + lpal
    rows = [r for start, step in _INTERLACE for r in range(start, h, step)] if interlace \
        else range(h)
    stream = indices[list(rows)].ravel()
    size = min_code_size or max(2, int(indices.max()).bit_length())
    body += bytes([size]) + _blocks(lzw_encode(stream, size))
    return head + body + (b";" if trailer else b"")
