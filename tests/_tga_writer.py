"""TGA files of every image type, depth, origin and colour map that Pillow
reads, including what its writer does not make (1-bit, 15/16-bit colour,
colour maps with a first entry, 16-bit colour-map entries, right-to-left
rows, RLE packets of any split). Pillow decodes them, so its decode stays
the judge of the port's.
"""

import struct

import numpy as np


def pack_rows(pixels, depth):
    """(H, W) indices or grey, (H, W, 2) grey and alpha, (H, W) 16-bit words
    or (H, W, 3|4) RGB(A) -> the rows' bytes, top row first, as TGA stores
    pixels (BGR order, 1-bit rows packed MSB first)."""
    a = np.asarray(pixels)
    if depth == 1:
        return b"".join(np.packbits(row.astype(np.uint8) & 1).tobytes() for row in a)
    if depth == 16 and a.ndim == 2:
        return a.astype("<u2").tobytes()
    if a.ndim == 3 and a.shape[2] >= 3:
        a = np.concatenate([a[:, :, 2::-1], a[:, :, 3:]], axis=2)
    return a.astype(np.uint8).tobytes()


def rle_packets(data, unit, rng=None, max_run=128):
    """Row bytes -> TGA RLE packets of ``unit``-byte pixels: runs where pixels
    repeat (never across the row: ``data`` is one row), raw packets else.
    With ``rng`` the packets are cut at random lengths."""
    px = [data[i:i + unit] for i in range(0, len(data), unit)]
    out, i = bytearray(), 0
    while i < len(px):
        j = i
        while j + 1 < len(px) and px[j + 1] == px[i] and j - i + 1 < max_run:
            j += 1
        if j > i:
            out += bytes([0x80 | (j - i)]) + px[i]
            i = j + 1
            continue
        j = i + 1
        limit = max_run if rng is None else int(rng.integers(1, max_run + 1))
        while j < len(px) and j - i < limit and px[j] != px[j - 1]:
            j += 1
        out += bytes([j - i - 1]) + b"".join(px[i:j])
        i = j
    return bytes(out)


def write_tga(pixels, image_type, depth, origin="bottom_left", colour_map=None, map_start=0,
              map_depth=24, image_id=b"", rle_rng=None, rows_raw=None):
    """A TGA file of ``pixels`` (see ``pack_rows``); ``image_type`` 1, 2, 3 or
    9, 10, 11 (RLE); ``origin`` "bottom_left", "top_left", "bottom_right" or
    "top_right"; ``colour_map`` (N, 3) RGB entries (16-bit entries as words
    with ``map_depth`` 16) from ``map_start``. ``rows_raw`` replaces the
    encoded pixel bytes (for raw packets across rows)."""
    a = np.asarray(pixels)
    height, width = a.shape[:2]
    flags = {"bottom_left": 0, "bottom_right": 0x10, "top_left": 0x20, "top_right": 0x30}[origin]
    rows = a
    if flags & 0x10:
        rows = rows[:, ::-1]
    if not flags & 0x20:
        rows = rows[::-1]
    cmap = b""
    if colour_map is not None:
        cm = np.asarray(colour_map)
        cmap = cm.astype("<u2").tobytes() if map_depth == 16 else \
            cm[:, ::-1].astype(np.uint8).tobytes()
    head = struct.pack("<BBBHHBHHHHBB", len(image_id), colour_map is not None, image_type,
                       map_start if colour_map is not None else 0,
                       len(colour_map) if colour_map is not None else 0,
                       map_depth if colour_map is not None else 0, 0, 0, width, height, depth,
                       flags)
    if rows_raw is not None:
        body = rows_raw
    elif image_type & 8:
        unit = max(depth // 8, 1)
        body = b"".join(rle_packets(pack_rows(r[None], depth), unit, rle_rng) for r in rows)
    else:
        body = pack_rows(rows, depth)
    return head + image_id + cmap + body
