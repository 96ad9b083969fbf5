"""Classic TIFF files with what Pillow's writer does not make: either byte
order, strips of any height or tiles, chunky or planar samples, 1- to
16-bit samples, the predictor, min-is-white and palette images, extra
samples, and LZW, Deflate and PackBits of this module's own. Pillow decodes
them, so its decode stays the judge of the port's.

The LZW coder mirrors libtiff's decoder (tif_lzw.c): codes MSB first from
9 bits, the code size grows one code early (when the entry 2^size - 2 is
added), the table is cleared before it fills.
"""

import struct
import zlib

import numpy as np

COMPRESSION = {"none": 1, "lzw": 5, "deflate": 8, "packbits": 32773}


def lzw_encode(data):
    clear, eoi = 256, 257
    out = bytearray()
    acc = nacc = 0
    size = 9

    def emit(code):
        nonlocal acc, nacc
        acc = (acc << size) | code
        nacc += size
        while nacc >= 8:
            out.append((acc >> (nacc - 8)) & 0xFF)
            nacc -= 8
        acc &= (1 << nacc) - 1

    def reset():
        return {bytes([i]): i for i in range(256)}, 258, 9, 0

    table, nxt, size, emitted = reset()
    emit(clear)
    w = b""
    for k in data:
        wk = w + bytes([k])
        if wk in table:
            w = wk
            continue
        emit(table[w])
        emitted += 1
        if emitted >= 2:  # the decoder adds an entry now
            nxt += 1
            if nxt > (1 << size) - 2 and size < 12:
                size += 1
        if len(table) + 2 < 4094:
            table[wk] = len(table) + 2
        else:
            emit(clear)
            table, nxt, size, emitted = reset()
        w = bytes([k])
    if w:
        emit(table[w])
        emitted += 1
        if emitted >= 2:
            nxt += 1
            if nxt > (1 << size) - 2 and size < 12:
                size += 1
    emit(eoi)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def packbits_encode(data):
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j - i >= 2:
            out += bytes([(257 - (j - i + 1)) & 0xFF, data[i]])
            i = j + 1
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + bytes(data[i:j])
        i = j
    return bytes(out)


def _compress(raw, kind):
    if kind == "none":
        return raw
    if kind == "lzw":
        return lzw_encode(raw)
    if kind == "deflate":
        return zlib.compress(raw)
    return packbits_encode(raw)


def _pack_rows(plane, bits, order):
    """(H, W, S) samples -> (H, row bytes) with each row padded to a byte."""
    h, w, s = plane.shape
    flat = plane.reshape(h, w * s).astype(np.uint32)
    if bits in (16, 32):
        return flat.astype(f"{order}u{bits // 8}").view(np.uint8).reshape(h, -1)
    if bits == 8:
        return flat.astype(np.uint8)
    bitplanes = ((flat[:, :, None] >> np.arange(bits - 1, -1, -1)) & 1).astype(np.uint8)
    return np.packbits(bitplanes.reshape(h, -1), axis=1)


def _difference(plane, stride):
    """Horizontal differencing (predictor 2) on (H, W, S) samples."""
    h, w, s = plane.shape
    flat = plane.reshape(h, w * s).astype(np.int64)
    diff = flat.copy()
    diff[:, stride:] = flat[:, stride:] - flat[:, :-stride]
    return diff.reshape(h, w, s)


def write_tiff(samples, photometric, bits, compression="none", predictor=1, big_endian=False,
               planar=False, tile=None, rows_per_strip=None, palette=None, extra_samples=None,
               sample_format=None, extra_tags=()):
    """A one-image classic TIFF of ``samples`` (H, W, S) integers of ``bits``
    bits (1 to 16, or 32 as stored bits). ``tile`` is (width, length);
    ``palette`` a (2^bits, 3) array of 16-bit values; ``extra_tags`` (tag,
    type, values) entries added as given."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[:, :, None]
    h, w, spp = samples.shape
    order = ">" if big_endian else "<"
    mask = (1 << bits) - 1  # predictor differences wrap at the sample size
    if planar:
        planes = [samples[:, :, i:i + 1] for i in range(spp)]
        stride = 1
    else:
        planes = [samples]
        stride = spp
    if predictor == 2:
        planes = [_difference(p, stride) & mask for p in planes]
    chunks = []
    if tile:
        tw, tl = tile
        for p in planes:
            across, down = -(-w // tw), -(-h // tl)
            padded = np.zeros((down * tl, across * tw, p.shape[2]), np.int64)
            padded[:h, :w] = p
            for ty in range(down):
                for tx in range(across):
                    block = padded[ty * tl:(ty + 1) * tl, tx * tw:(tx + 1) * tw]
                    chunks.append(_pack_rows(block, bits, order).tobytes())
    else:
        rps = rows_per_strip or h
        for p in planes:
            rows = _pack_rows(p, bits, order)
            chunks += [rows[y:y + rps].tobytes() for y in range(0, h, rps)]
    data = [_compress(c, compression) for c in chunks]

    out = bytearray(b"MM\0*" if big_endian else b"II*\0")
    out += struct.pack(order + "I", 0)
    offsets = []
    for d in data:
        offsets.append(len(out))
        out += d
        if len(out) % 2:
            out += b"\0"
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * spp),
            (259, 3, [COMPRESSION[compression]]), (262, 3, [photometric]), (277, 3, [spp]),
            (284, 3, [2 if planar else 1])]
    if tile:
        tags += [(322, 4, [tile[0]]), (323, 4, [tile[1]]), (324, 4, offsets),
                 (325, 4, [len(d) for d in data])]
    else:
        tags += [(273, 4, offsets), (278, 4, [rows_per_strip or h]),
                 (279, 4, [len(d) for d in data])]
    if predictor != 1:
        tags.append((317, 3, [predictor]))
    if palette is not None:
        pal = np.asarray(palette, np.int64)
        tags.append((320, 3, list(pal[:, 0]) + list(pal[:, 1]) + list(pal[:, 2])))
    if extra_samples is not None:
        tags.append((338, 3, list(extra_samples)))
    if sample_format is not None:
        tags.append((339, 3, [sample_format] * spp))
    tags += list(extra_tags)
    tags.sort(key=lambda t: t[0])
    ifd_at = len(out)
    out[4:8] = struct.pack(order + "I", ifd_at)
    codes = {1: "B", 2: "B", 3: "H", 4: "I", 7: "B", 11: "f", 12: "d", 16: "Q"}
    ifd = bytearray(struct.pack(order + "H", len(tags)))
    heap = bytearray()
    heap_at = ifd_at + 2 + 12 * len(tags) + 4
    for tag, typ, values in tags:
        payload = struct.pack(order + codes[typ] * len(values), *[int(v) for v in values]) \
            if typ not in (11, 12) else struct.pack(order + codes[typ] * len(values), *values)
        ifd += struct.pack(order + "HHI", tag, typ, len(values))
        if len(payload) <= 4:
            ifd += payload + b"\0" * (4 - len(payload))
        else:
            ifd += struct.pack(order + "I", heap_at + len(heap))
            heap += payload
            if len(heap) % 2:
                heap += b"\0"
    ifd += struct.pack(order + "I", 0)
    return bytes(out + ifd + heap)
