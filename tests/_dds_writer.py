"""DDS files of any pixel format, which Pillow reads but writes only in part
(it writes DXT1/3/5, BC2, BC3, BC5 and uncompressed RGB, RGBA, L and LA): a
header for a FourCC, a DX10 header with its DXGI format, or an uncompressed
layout with its masks, followed by the surface as given. A surface of seeded
random blocks exercises every BCn mode; Pillow decodes the file, so its
decode stays the judge of the port's.
"""

import struct

import numpy as np

DDPF_ALPHAPIXELS, DDPF_FOURCC, DDPF_PALETTE8, DDPF_RGB, DDPF_LUMINANCE = 0x1, 0x4, 0x20, 0x40, \
    0x20000
# the DXGI formats Pillow 12.1 reads
DXGI = {"R8G8B8A8": 28, "R8G8B8A8_SRGB": 29, "BC1": 71, "BC2": 74, "BC3": 77, "BC4": 80,
        "BC5": 83, "BC5_SNORM": 84, "BC6H_UF16": 95, "BC6H_SF16": 96, "BC7": 98,
        "BC7_SRGB": 99}
BLOCK_BYTES = {"DXT1": 8, "DXT3": 16, "DXT5": 16, "BC4U": 8, "ATI1": 8, "BC5U": 16, "ATI2": 16,
               "BC5S": 16, "BC1": 8, "BC2": 16, "BC3": 16, "BC4": 8, "BC5": 16, "BC5_SNORM": 16,
               "BC6H_UF16": 16, "BC6H_SF16": 16, "BC7": 16, "BC7_SRGB": 16}


def write_dds(width, height, surface=b"", fourcc=None, dxgi=None, pfflags=None, bitcount=0,
              masks=(0, 0, 0, 0), palette=None, header_size=124):
    """A DDS file: a FourCC (``fourcc="DXT1"``), or a DX10 header (``dxgi``,
    a name of ``DXGI`` or a number), or with ``pfflags`` an uncompressed
    layout (``bitcount``, ``masks``; a 1024-byte RGBA ``palette`` for
    ``DDPF_PALETTE8``)."""
    if dxgi is not None:
        fourcc = "DX10"
    if pfflags is None:
        pfflags = DDPF_FOURCC
    code = struct.unpack("<I", fourcc.encode())[0] if fourcc else 0
    head = b"DDS " + struct.pack("<7I", header_size, 0x1007, height, width, 0, 0, 0)
    head += bytes(44) + struct.pack("<4I", 32, pfflags, code, bitcount)
    head += struct.pack("<4I", *masks) + struct.pack("<5I", 0x1000, 0, 0, 0, 0)
    if fourcc == "DX10":
        head += struct.pack("<5I", DXGI.get(dxgi, dxgi), 3, 0, 1, 0)
    if palette is not None:
        head += bytes(palette)
    return head + bytes(surface)


def random_blocks(rng, count, size, mode=None):
    """``count`` blocks of ``size`` seeded bytes. With ``mode`` (a BC7 mode
    0-7, or a BC6H mode header of 2 or 5 bits given as ``("bc6", bits)``)
    each block's first bits are set to select it."""
    blocks = rng.integers(0, 256, (count, size), dtype=np.uint8)
    if isinstance(mode, int):
        blocks[:, 0] = (blocks[:, 0] << (mode + 1)) | (1 << mode)
    elif mode is not None:
        bits = mode[1]
        width = 2 if bits < 2 else 5
        blocks[:, 0] = (blocks[:, 0] & ((0xFF << width) & 0xFF)) | bits
    return blocks.tobytes()


def block_count(width, height):
    return ((width + 3) // 4) * ((height + 3) // 4)


def encode_bc7_mode6(rgb):
    """(H, W, 3) uint8, H and W multiples of 4 -> BC7 blocks in mode 6 (one
    subset, 7-bit endpoints with a p-bit each, 4-bit indices): each block's
    channel minimum and maximum as the endpoints, each pixel's projection on
    the line between them as its index. A plain encoder, enough to give a
    texture of a photograph."""
    a = np.asarray(rgb, np.int64)
    h, w = a.shape[:2]
    out = bytearray()
    for by in range(0, h, 4):
        for bx in range(0, w, 4):
            px = a[by:by + 4, bx:bx + 4].reshape(16, 3)
            lo, hi = px.min(0), px.max(0)
            e0, e1 = lo & 0xFE, hi | 1  # p-bits 0 and 1
            d = e1 - e0
            t = ((px - e0) @ d) / max(int(d @ d), 1)
            idx = np.clip(np.rint(t * 15), 0, 15).astype(np.int64)
            q0, q1, p0, p1 = lo >> 1, hi >> 1, 0, 1
            if idx[0] >= 8:  # the anchor's top bit is implied 0: swap the ends
                q0, q1, p0, p1, idx = q1, q0, p1, p0, 15 - idx
            bits = [0] * 6 + [1]
            for c in range(3):
                bits += [(int(q0[c]) >> i) & 1 for i in range(7)]
                bits += [(int(q1[c]) >> i) & 1 for i in range(7)]
            bits += [1] * 14 + [p0, p1]  # alpha 127 | p
            bits += [(int(idx[0]) >> i) & 1 for i in range(3)]
            for v in idx[1:]:
                bits += [(int(v) >> i) & 1 for i in range(4)]
            out += bytes(sum(bits[8 * k + i] << i for i in range(8)) for k in range(16))
    return bytes(out)
