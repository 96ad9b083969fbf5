"""The directory formats of images: ICO and CUR (a directory of frames,
each a PNG stream or a DIB: a BMP without its file header, its height
doubled for the AND mask that follows the pixels) and DCX (a directory of
PCX pages), with PCX pages of the planar layouts Pillow reads but does not
write (1 bit in 2 or 4 planes). Pillow writes ICO with PNG or 32-bit DIB
frames only, and neither CUR nor DCX; it decodes them all, so its decode
stays the judge of the port's.
"""

import struct

import numpy as np


def dib(indices_or_rgb, bits, palette=None, and_mask=None, colours_used=0):
    """A DIB frame: a 40-byte header with the doubled height, the palette
    (BGRX) for ``bits`` <= 8, the XOR rows bottom-up padded to 4 bytes, the
    AND mask (1 bit a pixel, rows padded to 4 bytes)."""
    a = np.asarray(indices_or_rgb)
    h, w = a.shape[:2]
    head = struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, bits, 0, 0, 0, 0, colours_used, 0)
    pal = b""
    if bits <= 8:
        p = np.asarray(palette, np.uint8)
        pal = np.concatenate([p[:, ::-1], np.zeros((len(p), 1), np.uint8)], 1).tobytes()
    stride = ((w * bits + 31) >> 3) & ~3
    rows = []
    for row in a[::-1]:
        if bits <= 8:
            v = np.zeros(stride * 8 // bits, np.uint8)
            v[:w] = row
            raw = np.packbits(np.unpackbits(v[:, None], axis=1)[:, 8 - bits:]).tobytes() \
                if bits < 8 else v.tobytes()
        elif bits == 24:
            raw = row[:, ::-1].astype(np.uint8).tobytes()
        else:  # 32: BGRA
            raw = np.concatenate([row[:, 2::-1], row[:, 3:4] if row.shape[1] > 3 else
                                  np.full((w, 1), 255)], 1).astype(np.uint8).tobytes()
        rows.append(raw + bytes(stride - len(raw)))
    if and_mask is None:
        and_mask = np.zeros((h, w), np.uint8)
    mstride = ((w + 31) >> 3) & ~3
    mask = b"".join(np.packbits(np.concatenate([r, np.zeros(mstride * 8 - w, np.uint8)]))
                    .tobytes() for r in np.asarray(and_mask)[::-1])
    return head + pal + b"".join(rows) + mask


def write_icon(frames, kind=1, entries=None):
    """An ICO (``kind`` 1) or CUR (2) of ``frames``: (width, height, bpp,
    colours, frame bytes) each; ``entries`` overrides directory fields of
    frame i (a dict of width, height, colours, planes, bpp, size, offset)."""
    out = bytearray(struct.pack("<HHH", 0, kind, len(frames)))
    offset = 6 + 16 * len(frames)
    dirs = []
    for i, (w, h, bpp, colours, data) in enumerate(frames):
        e = dict(width=w % 256, height=h % 256, colours=colours, planes=1, bpp=bpp,
                 size=len(data), offset=offset)
        e.update((entries or {}).get(i, {}))
        dirs.append(struct.pack("<BBBBHHII", e["width"], e["height"], e["colours"], 0,
                                e["planes"], e["bpp"], e["size"], e["offset"]))
        offset += len(data)
    out += b"".join(dirs)
    for f in frames:
        out += f[4]
    return bytes(out)


def pcx_planar(indices, planes, palette16, header_stride=None, version=3):
    """A PCX page of 1-bit ``planes`` (2 or 4) over 4-bit indices, with a
    16-colour header palette, RLE-coded as PCX codes literal bytes. The
    header's bytes per line is ``header_stride`` (by default the width's
    bytes, made even); the lines hold as many bytes as Pillow reads: the
    width's, one more where the header's count differs and the width's is
    odd."""
    a = np.asarray(indices)
    h, w = a.shape
    need = (w + 7) // 8
    header_stride = header_stride or need + need % 2
    stride = need + (need % 2 if header_stride != need else 0)
    head = struct.pack("<BBBBHHHHHH", 10, version, 1, 1, 0, 0, w - 1, h - 1, 72, 72)
    head += np.asarray(palette16, np.uint8).reshape(48).tobytes() + bytes([0, planes])
    head += struct.pack("<HH", header_stride, 1)
    head += bytes(128 - len(head))
    body = bytearray()
    for row in a:
        line = b""
        for p in range(planes):
            bits = np.zeros(stride * 8, np.uint8)
            bits[:w] = (row >> p) & 1
            line += np.packbits(bits).tobytes()
        i = 0
        while i < len(line):  # runs of equal bytes, else literals (0xC0 and up as runs of 1)
            j = i
            while j + 1 < len(line) and line[j + 1] == line[i] and j - i < 62:
                j += 1
            if j > i or line[i] >= 0xC0:
                body += bytes([0xC0 | (j - i + 1), line[i]])
            else:
                body.append(line[i])
            i = j + 1
    return head + bytes(body)


def write_dcx(pages):
    """A DCX container of PCX page bytes: the magic, the page offsets, a zero."""
    offset = 4 + 4 * (len(pages) + 1)
    table = []
    for p in pages:
        table.append(offset)
        offset += len(p)
    return struct.pack(f"<I{len(pages) + 1}I", 0x3ADE68B1, *table, 0) + b"".join(pages)
