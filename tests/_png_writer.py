"""A small PNG writer in numpy for the image-input tests: every colour type
and bit depth, Adam7 interlacing and a chosen cycle of row filters, which
Pillow cannot all write (it writes neither Adam7 nor 16-bit RGB). It also
wrote the PNG fixtures under ``data/corpus/image_modes/`` (see that
directory's MANIFEST.json)."""

import struct
import zlib

import numpy as np

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
# colour type -> samples per pixel; the legal bit depths
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# every (colour type, depth)
MODES = [(colour, depth) for colour, depths in DEPTHS.items() for depth in depths]


def _pack(samples, depth):
    """(h, n) integer samples -> (h, bytes) packed rows."""
    if depth == 8:
        return samples.astype(np.uint8)
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(samples.shape[0], -1)
    per = 8 // depth
    h, n = samples.shape
    padded = np.concatenate([samples, np.zeros((h, (-n) % per), samples.dtype)], axis=1)
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint16)
    return (padded.reshape(h, -1, per).astype(np.uint16) << shifts).sum(-1).astype(np.uint8)


def _filter(rows, bpp, kinds):
    out = []
    prev = np.zeros(rows.shape[1], np.int32)
    for y, row in enumerate(rows.astype(np.int32)):
        kind = kinds[y % len(kinds)]
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])[:len(row)]
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])[:len(row)]
        if kind == 0:
            f = row
        elif kind == 1:
            f = row - left
        elif kind == 2:
            f = row - prev
        elif kind == 3:
            f = row - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            f = row - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(bytes([kind]) + (f & 255).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(samples, colour, depth, interlace=0, palette=None, kinds=(0, 1, 2, 3, 4),
              extra=()):
    """PNG bytes of ``samples`` (h, w, channels) integers at the file's bit
    depth; ``palette`` (n, 3) for colour type 3; ``extra`` (type, body)
    chunks go before the image data."""
    samples = np.asarray(samples)
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)

    def image(sub):
        sh, sw = sub.shape[:2]
        if sh == 0 or sw == 0:
            return b""
        return _filter(_pack(sub.reshape(sh, sw * c), depth), bpp, kinds)

    raw = b"".join(image(samples[y0::dy, x0::dx]) for x0, y0, dx, dy in ADAM7) \
        if interlace else image(samples)
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour,
                                                             0, 0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    for kind, body in extra:
        out += chunk(kind, body)
    return out + chunk(b"IDAT", zlib.compress(raw, 9)) + chunk(b"IEND", b"")


def mode_samples(colour, depth, shape, seed):
    """Seeded samples (and a palette for colour type 3) of one mode: smooth
    ramps with noise, so that every filter sees structure; 16-bit grey
    holds values above 255, where PIL's clip and the loader's high byte part."""
    rng = np.random.default_rng(seed)
    h, w = shape
    top = 2**depth - 1
    ramp = (np.add.outer(np.arange(h), np.arange(w)) * top // max(1, h + w - 2))
    samples = np.stack([(ramp + rng.integers(0, max(2, top // 8 + 1), (h, w))) % (top + 1)
                        for _ in range(CHANNELS[colour])], axis=-1)
    palette = None
    if colour == 3:
        n = min(top + 1, 3 + 5 * depth)
        palette = rng.integers(0, 256, (n, 3))
        samples = samples % n
    if colour == 0 and depth == 16:
        samples[0, 0, 0], samples[-1, -1, 0] = 5000, 200
    return samples, palette
