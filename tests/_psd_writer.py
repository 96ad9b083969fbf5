"""Adobe Photoshop (PSD) files of any mode, depth, channel count and
compression of the merged image, for the tests: Pillow reads PSD but
cannot write it.

    write_psd(planes, mode, depth=8, compression=0, color_data=b"",
              resources=(), layer_data=b"", version=1)

``planes`` is a list of (H, W) uint8 arrays, one per channel (for depth 1,
arrays of 0 and 1, one bit per pixel). The file is the header (signature,
version, channels, height, width, depth, mode), the colour-mode data, the
image resources (each ``(id, name, data)`` with the Pascal name and data
padded to even lengths), the layer and mask section as given, and the
merged image: raw channel planes (compression 0), or PackBits (compression
1) with each row encoded alone and the row byte counts of every channel
first, as Photoshop writes them. Other compression numbers are written with
the raw planes after them.
"""

import struct

import numpy as np


def packbits(row):
    """Apple PackBits of one row: runs of 2 to 128 equal bytes as
    (257 - n, byte), everything else as literals of up to 128 bytes."""
    row = bytes(row)
    out, i, literal = bytearray(), 0, bytearray()

    def flush():
        while literal:
            chunk = literal[:128]
            out.append(len(chunk) - 1)
            out.extend(chunk)
            del literal[:128]

    while i < len(row):
        j = i
        while j + 1 < len(row) and row[j + 1] == row[i] and j - i < 127:
            j += 1
        if j > i:
            flush()
            out.extend((257 - (j - i + 1), row[i]))
            i = j + 1
        else:
            literal.append(row[i])
            i += 1
    flush()
    return bytes(out)


def _rows(plane, depth):
    plane = np.asarray(plane, np.uint8)
    if depth == 1:
        return [np.packbits(r).tobytes() for r in plane]
    return [r.tobytes() for r in plane]


def write_psd(planes, mode, depth=8, compression=0, color_data=b"", resources=(),
              layer_data=b"", version=1):
    height, width = np.asarray(planes[0]).shape
    head = b"8BPS" + struct.pack(">H6xHIIHH", version, len(planes), height, width, depth, mode)
    out = bytearray(head)
    out += struct.pack(">I", len(color_data)) + color_data
    block = bytearray()
    for rid, name, data in resources:
        pascal = bytes([len(name)]) + name
        block += b"8BIM" + struct.pack(">H", rid) + pascal + b"\0" * (len(pascal) & 1)
        block += struct.pack(">I", len(data)) + data + b"\0" * (len(data) & 1)
    out += struct.pack(">I", len(block)) + block
    out += struct.pack(">I", len(layer_data)) + layer_data
    out += struct.pack(">H", compression)
    rows = [_rows(p, depth) for p in planes]
    if compression == 1:
        encoded = [[packbits(r) for r in channel] for channel in rows]
        out += b"".join(struct.pack(">H", len(r)) for channel in encoded for r in channel)
        out += b"".join(r for channel in encoded for r in channel)
    else:
        out += b"".join(r for channel in rows for r in channel)
    return bytes(out)
