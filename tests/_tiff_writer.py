"""TIFF files with what Pillow's writer does not make: either byte order,
strips of any height or tiles, chunky or planar samples, 1- to 16-bit
samples, the predictor, min-is-white and palette images, extra samples,
subsampled YCbCr, BigTIFF, JPEG strips and tiles with a JPEGTables stream,
and LZW, Deflate and PackBits of this module's own. Pillow decodes them, so
its decode stays the judge of the port's.

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


def _ycbcr_units(plane, sub):
    """(H, W, 3) YCbCr samples -> (unit rows, units across * (h * v + 2))
    as a contiguous YCbCr TIFF stores them: each h x v unit's luma in raster
    order, then the Cb and Cr of its top-left sample; edges repeat."""
    sh, sv = sub
    hh, ww, _ = plane.shape
    across, down = -(-ww // sh), -(-hh // sv)
    ys = np.minimum(np.arange(down * sv), hh - 1)
    xs = np.minimum(np.arange(across * sh), ww - 1)
    full = plane[ys[:, None], xs[None, :]]
    luma = full[:, :, 0].reshape(down, sv, across, sh).transpose(0, 2, 1, 3).reshape(
        down, across, sv * sh)
    chroma = full[::sv, ::sh, 1:]
    return np.concatenate([luma, chroma], axis=2).reshape(down, -1)


def write_tiff(samples, photometric, bits, compression="none", predictor=1, big_endian=False,
               planar=False, tile=None, rows_per_strip=None, palette=None, extra_samples=None,
               sample_format=None, extra_tags=(), ycbcr_subsampling=None, bigtiff=False,
               chunks=None):
    """A one-image TIFF of ``samples`` (H, W, S) integers of ``bits`` bits (1
    to 16, or 32 as stored bits). ``tile`` is (width, length); ``palette`` a
    (2^bits, 3) array of 16-bit values; ``extra_tags`` (tag, type, values)
    entries added as given (type 7 takes bytes). ``ycbcr_subsampling`` (h,
    v) packs YCbCr samples in units and writes the tag; ``bigtiff`` writes
    BigTIFF (8-byte offsets, LONG8 strip and tile tags); ``chunks`` are the
    strips or tiles already compressed (``compression`` is then the tag's
    number)."""
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
    if chunks is not None:
        data = list(chunks)
    elif ycbcr_subsampling:
        units = _ycbcr_units(samples, ycbcr_subsampling)
        rps = rows_per_strip or h
        data = [_compress(units[y // ycbcr_subsampling[1]:
                                -(-(y + rps) // ycbcr_subsampling[1])].astype(np.uint8).tobytes(),
                          compression) for y in range(0, h, rps)]
    else:
        data = None
    chunks = []
    if data is not None:
        pass
    elif tile:
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
    if data is None:
        data = [_compress(c, compression) for c in chunks]

    if bigtiff:
        out = bytearray(b"MM\0+" if big_endian else b"II+\0")
        out += struct.pack(order + "HHQ", 8, 0, 0)
    else:
        out = bytearray(b"MM\0*" if big_endian else b"II*\0")
        out += struct.pack(order + "I", 0)
    offsets = []
    for d in data:
        offsets.append(len(out))
        out += d
        if len(out) % 2:
            out += b"\0"
    long_ = 16 if bigtiff else 4
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * spp),
            (259, 3, [COMPRESSION.get(compression, compression)]), (262, 3, [photometric]),
            (277, 3, [spp]), (284, 3, [2 if planar else 1])]
    if tile:
        tags += [(322, 4, [tile[0]]), (323, 4, [tile[1]]), (324, long_, offsets),
                 (325, long_, [len(d) for d in data])]
    else:
        tags += [(273, long_, offsets), (278, 4, [rows_per_strip or h]),
                 (279, long_, [len(d) for d in data])]
    if ycbcr_subsampling:
        tags.append((530, 3, list(ycbcr_subsampling)))
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
    if bigtiff:
        out[8:16] = struct.pack(order + "Q", ifd_at)
    else:
        out[4:8] = struct.pack(order + "I", ifd_at)
    codes = {1: "B", 2: "B", 3: "H", 4: "I", 7: "B", 8: "h", 9: "i", 11: "f", 12: "d",
             16: "Q", 17: "q", 18: "Q"}
    inline, entry, count = (8, "HHQ", "Q") if bigtiff else (4, "HHI", "H")
    ifd = bytearray(struct.pack(order + count, len(tags)))
    heap = bytearray()
    heap_at = ifd_at + len(ifd) + (20 if bigtiff else 12) * len(tags) + inline
    for tag, typ, values in tags:
        if isinstance(values, bytes):
            payload = values
        elif typ == 5:  # RATIONAL, values as (numerator, denominator)
            payload = b"".join(struct.pack(order + "II", *v) for v in values)
        elif typ in (11, 12):
            payload = struct.pack(order + codes[typ] * len(values), *values)
        else:
            payload = struct.pack(order + codes[typ] * len(values), *[int(v) for v in values])
        ifd += struct.pack(order + entry, tag, typ, len(values))
        if len(payload) <= inline:
            ifd += payload + b"\0" * (inline - len(payload))
        else:
            ifd += struct.pack(order + ("Q" if bigtiff else "I"), heap_at + len(heap))
            heap += payload
            if len(heap) % 2:
                heap += b"\0"
    ifd += struct.pack(order + ("Q" if bigtiff else "I"), 0)
    return bytes(out + ifd + heap)


def _markers(jpeg):
    """(marker, segment bytes) of a JPEG stream up to its first SOS; then
    ("scan", the rest)."""
    out, pos = [], 2
    while True:
        marker = jpeg[pos + 1]
        if marker == 0xDA:
            out.append(("scan", jpeg[pos:]))
            return out
        length = struct.unpack(">H", jpeg[pos + 2:pos + 4])[0]
        out.append((marker, jpeg[pos:pos + 2 + length]))
        pos += 2 + length


def jpeg_chunks(samples, sampling, tile=None, rows_per_strip=None, write=None, **jpeg_args):
    """JPEG-in-TIFF strips or tiles of ``samples`` (H, W, S) uint8 and the
    JPEGTables stream: each chunk an abbreviated JPEG (its SOF and scans)
    of the strip, cropped at the image's edge, or of the whole tile, the
    edge repeated; the tables (DQT, DHT, DAC) once in the tables stream.
    ``write`` is a writer of tests/_jpeg_writer.py (write_jpeg by default)
    given ``sampling`` and ``jpeg_args``. Returns (chunks, tables)."""
    import _jpeg_writer

    write = write or _jpeg_writer.write_jpeg
    samples = np.asarray(samples, np.uint8)
    if samples.ndim == 2:
        samples = samples[:, :, None]
    h, w, _ = samples.shape
    regions = []
    if tile:
        tw, tl = tile
        for y in range(0, h, tl):
            for x in range(0, w, tw):
                ys = np.minimum(np.arange(y, y + tl), h - 1)
                xs = np.minimum(np.arange(x, x + tw), w - 1)
                regions.append(samples[ys[:, None], xs[None, :]])
    else:
        rps = rows_per_strip or h
        regions = [samples[y:y + rps] for y in range(0, h, rps)]
    chunks, tables = [], None
    for region in regions:
        parts = _markers(write([region[:, :, i] for i in range(region.shape[2])], sampling,
                               **jpeg_args))
        table_parts = b"".join(seg for m, seg in parts if m in (0xDB, 0xC4, 0xCC))
        tables = tables or b"\xff\xd8" + table_parts + b"\xff\xd9"
        chunks.append(b"\xff\xd8" + b"".join(seg for m, seg in parts
                                              if m not in (0xDB, 0xC4, 0xCC)
                                              and not (isinstance(m, int) and 0xE0 <= m <= 0xEF)))
    return chunks, tables
