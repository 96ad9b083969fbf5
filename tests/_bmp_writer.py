"""RLE8 and RLE4 BMP files, which Pillow reads but does not write: an
encoder of rows into encoded and absolute runs, and a writer of any RLE
stream (deltas, an early end of bitmap) behind a 40-byte header. Pillow
decodes them, so its decode stays the judge of the port's.

The encoder keeps RLE4's absolute runs to even lengths, as Pillow 12.1
reads an odd one a pixel short.
"""

import struct

import numpy as np


def _row_ops(row, rle4):
    out, i, w = bytearray(), 0, len(row)
    while i < w:
        j = i
        while j + 1 < w and row[j + 1] == row[i] and j - i < 254:
            j += 1
        run = j - i + 1
        if run >= 2 or w - i < 4:
            v = int(row[i])
            out += bytes([run, (v << 4) | v if rle4 else v])
            i += run
            continue
        j = i
        while j < w and j - i < 254 and not (j + 1 < w and row[j + 1] == row[j]):
            j += 1
        n = j - i
        if rle4:
            n -= n % 2
        if n < 3:
            v = int(row[i])
            out += bytes([1, (v << 4) | v if rle4 else v])
            i += 1
            continue
        vals = [int(v) for v in row[i:i + n]]
        data = bytes((vals[k] << 4) | vals[k + 1] for k in range(0, n, 2)) if rle4 else bytes(vals)
        out += bytes([0, n]) + data + (b"\0" if len(data) % 2 else b"")
        i += n
    return bytes(out)


def rle_encode(indices, rle4=False, top_down=False):
    """The RLE stream of palette ``indices`` (H, W): rows in file order, each
    ended by end-of-line, the last by end-of-bitmap."""
    rows = np.asarray(indices)
    if not top_down:
        rows = rows[::-1]
    ops = [_row_ops(r, rle4) for r in rows]
    return b"".join(o + b"\0\0" for o in ops[:-1]) + ops[-1] + b"\0\1"


def write_bmp_rle(width, height, palette, stream, rle4=False, top_down=False, bits=None):
    """A BMP of the RLE ``stream`` with a BGRX palette from ``palette`` (N, 3)."""
    pal = np.asarray(palette, np.uint8).reshape(-1, 3)
    table = np.concatenate([pal[:, ::-1], np.zeros((len(pal), 1), np.uint8)], 1).tobytes()
    head = struct.pack("<IiiHHIIiiII", 40, width, -height if top_down else height, 1,
                       bits or (4 if rle4 else 8), 2 if rle4 else 1, len(stream), 2835, 2835,
                       len(pal), 0)
    offset = 14 + len(head) + len(table)
    return (b"BM" + struct.pack("<IHHI", offset + len(stream), 0, 0, offset) + head + table
            + stream)
