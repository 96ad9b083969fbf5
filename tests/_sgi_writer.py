"""SGI image files, verbatim or RLE, of 1 or 2 bytes a sample (Pillow writes
only the verbatim form): rows bottom-up, channel after channel, and for RLE
the offset and length tables, each row's packets (runs and copies of at
most 127 samples, then a zero terminator). Pillow decodes them, so its
decode stays the judge of the port's.
"""

import struct

import numpy as np


def rle_row(row, bpc):
    """One channel's row -> SGI RLE packets (a 16-bit header for bpc 2)."""
    out, i, w = bytearray(), 0, len(row)

    def sample(v):
        return int(v).to_bytes(bpc, "big")

    def head(v):
        return int(v).to_bytes(bpc, "big")
    while i < w:
        j = i
        while j + 1 < w and row[j + 1] == row[i] and j - i + 1 < 127:
            j += 1
        if j - i + 1 >= 3:
            out += head(j - i + 1) + sample(row[i])
            i = j + 1
            continue
        j = i
        while j < w and j - i < 127 and not (j + 2 < w and row[j] == row[j + 1] == row[j + 2]):
            j += 1
        out += head(0x80 | (j - i)) + b"".join(sample(v) for v in row[i:j])
        i = j
    return bytes(out + head(0))


def write_sgi(samples, bpc=1, rle=False, dimension=None):
    """An SGI file of ``samples``: (H, W) grey or (H, W, 3|4), values below
    256 ** bpc, top row first."""
    a = np.asarray(samples)
    if a.ndim == 2:
        a = a[:, :, None]
    height, width, zsize = a.shape
    if dimension is None:
        dimension = 3 if zsize > 1 else 2
    head = struct.pack(">HBBHHHHIII", 474, int(rle), bpc, dimension, width, height, zsize, 0,
                       256 ** bpc - 1, 0)
    head = head + bytes(512 - len(head))
    planes = [a[::-1, :, c] for c in range(zsize)]  # bottom row first
    if not rle:
        return head + b"".join(p.astype(">u1" if bpc == 1 else ">u2").tobytes() for p in planes)
    rows = [rle_row(p[y], bpc) for p in planes for y in range(height)]
    offset = 512 + 8 * len(rows)
    starts, lengths = [], []
    for r in rows:
        starts.append(offset)
        lengths.append(len(r))
        offset += len(r)
    tables = struct.pack(f">{len(rows)}I", *starts) + struct.pack(f">{len(rows)}I", *lengths)
    return head + tables + b"".join(rows)
