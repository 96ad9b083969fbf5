"""Writes data/corpus/image_formats/ and its MANIFEST.json: the WebP, GIF,
TIFF, netpbm and RLE BMP fixtures that the port's decoders are held to, and
the JPEG processes beside baseline (arithmetic coding, lossless, block
smoothing).

    python tests/_image_formats_corpus.py

Each file is a crop of data/corpus/gallery/gt_1.png (or samples drawn from
a numpy seed) written by Pillow or by a writer under tests/ (_webp_writer,
_gif_writer, _tiff_writer, _bmp_writer, _jpeg_writer; netpbm is written
here). The
manifest holds each file's writer and parameters, its shape and the SHA-256
of Pillow's ``np.asarray(Image.open(f).convert("RGB"))`` bytes; entries with
``refused`` are files the port refuses by name. Regenerate only with the
Pillow the manifest names (12.1: libwebp 1.6.0, libtiff 4.7.1): the digests
are its decodes. The ``timing`` files (a 96 x 128 crop in each decoder's
format) are what chip_smoke.py times and serves.
"""

import hashlib
import io
import json
import struct
import sys
from pathlib import Path

import numpy as np
import PIL
from PIL import Image

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _bmp_writer import rle_encode, write_bmp_rle  # noqa: E402
from _gif_writer import write_gif  # noqa: E402
from _jpeg_writer import (drop_scans, write_jpeg, write_jpeg_arith,  # noqa: E402
                          write_jpeg_lossless)
from _tiff_writer import jpeg_chunks, write_tiff  # noqa: E402
from _webp_writer import write_webp  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "data/corpus/image_formats"
SOURCE = "data/corpus/gallery/gt_1.png"
GALLERY = np.asarray(Image.open(ROOT / SOURCE).convert("RGB"))
KINDS = {".webp": "webp", ".gif": "gif", ".tif": "tiff", ".pbm": "pnm", ".pgm": "pnm",
         ".ppm": "pnm", ".bmp": "bmp", ".jpg": "jpeg"}
# the progressive scan script of libjpeg's jpeg_simple_progression for YCbCr
# (components, Ss, Se, Ah, Al), as Pillow writes it
SIMPLE_PROGRESSION = [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
                      ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                      ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
                      ((0,), 1, 63, 1, 0)]


def crop(top, left, h, w):
    return GALLERY[top:top + h, left:left + w]


def pil_save(img, fmt, **save):
    buf = io.BytesIO()
    img.save(buf, fmt, **save)
    return buf.getvalue()


def rgba(rgb, seed):
    """rgb with an alpha plane from a seed, its top rows transparent."""
    a = np.random.default_rng(seed).integers(0, 256, rgb.shape[:2], dtype=np.uint8)
    a[: rgb.shape[0] // 3] = 0
    return Image.fromarray(np.dstack([rgb, a]))


def planes(rgb, mode="YCbCr"):
    img = np.asarray(Image.fromarray(rgb).convert(mode))
    return [img[:, :, i] for i in range(img.shape[2])] if img.ndim == 3 else [img]


def lab_bytes(rgb):
    """An image's CIELab bytes by a rough formula (PIL's own RGB to LAB goes
    through LittleCMS and is not repeatable here): L from the luma, a and
    b from colour differences, as signed bytes."""
    r, g, b = (rgb[:, :, i].astype(np.int64) for i in range(3))
    lab = np.stack([(299 * r + 587 * g + 114 * b) // 1000, (r - g) // 2, (g - b) // 2], -1)
    return (lab % 256).astype(np.uint8)


def patched_sof(data, marker=None, precision=None):
    """``data`` with its frame header's marker or precision replaced."""
    out = bytearray(data)
    at = next(i for i in range(len(out) - 1) if out[i] == 0xFF and 0xC0 <= out[i + 1] <= 0xCF
              and out[i + 1] not in (0xC4, 0xC8, 0xCC))
    if marker is not None:
        out[at + 1] = marker
    if precision is not None:
        out[at + 4] = precision
    return bytes(out)


def jpeg_fixtures(rng):
    """The JPEG processes beside baseline: arithmetic coding, lossless, the
    progressive files libjpeg smooths, and the refused processes."""
    img, tile = crop(150, 220, 48, 64), crop(100, 200, 96, 128)
    odd = crop(30, 300, 37, 45)
    yield "jpeg_arith_seq_420_48x64.jpg", "tests/_jpeg_writer.py", \
        {"crop": [150, 220, 48, 64], "coder": "arithmetic", "sampling": "2x2,1x1,1x1",
         "quality_step": 6}, write_jpeg_arith(planes(img), [(2, 2), (1, 1), (1, 1)])
    yield "jpeg_arith_seq_422_restart_dac_37x45.jpg", "tests/_jpeg_writer.py", \
        {"crop": [30, 300, 37, 45], "coder": "arithmetic", "sampling": "2x1,1x1,1x1",
         "quality_step": 4, "restart_interval": 3, "dac": [[0, 0x52], [1, 0x31], [16, 2],
                                                           [17, 30]]}, \
        write_jpeg_arith(planes(odd), [(2, 1), (1, 1), (1, 1)], 4, restart_interval=3,
                         dac=[(0, 0x52), (1, 0x31), (16, 2), (17, 30)])
    yield "jpeg_arith_prog_420_restart_48x64.jpg", "tests/_jpeg_writer.py", \
        {"crop": [150, 220, 48, 64], "coder": "arithmetic", "sampling": "2x2,1x1,1x1",
         "scans": "libjpeg's simple progression", "restart_interval": 2}, \
        write_jpeg_arith(planes(img), [(2, 2), (1, 1), (1, 1)], scans=SIMPLE_PROGRESSION,
                         restart_interval=2)
    yield "jpeg_arith_grey_37x45.jpg", "tests/_jpeg_writer.py", \
        {"crop": [30, 300, 37, 45], "coder": "arithmetic", "mode": "L", "quality_step": 2}, \
        write_jpeg_arith(planes(odd, "L"), [(1, 1)], 2)
    for pred in range(1, 8):
        yield f"jpeg_lossless_p{pred}_24x32.jpg", "tests/_jpeg_writer.py", \
            {"crop": [150, 220, 24, 32], "process": "lossless", "predictor": pred,
             "components": "RGB, ids 1 2 3, no marker"}, \
            write_jpeg_lossless(planes(img[:24, :32], "RGB"), pred, marker=None)
    yield "jpeg_lossless_grey_pt3_restart_37x45.jpg", "tests/_jpeg_writer.py", \
        {"crop": [30, 300, 37, 45], "process": "lossless", "mode": "L", "predictor": 5,
         "point_transform": 3, "restart_interval": 90}, \
        write_jpeg_lossless(planes(odd, "L"), 5, pt=3, restart_interval=90)
    yield "jpeg_lossless_420_adobe_rgb_37x45.jpg", "tests/_jpeg_writer.py", \
        {"crop": [30, 300, 37, 45], "process": "lossless", "predictor": 4,
         "sampling": "2x2,1x1,1x1", "marker": "Adobe, transform 0", "restart_interval": 23}, \
        write_jpeg_lossless(planes(odd, "RGB"), 4, sampling=[(2, 2), (1, 1), (1, 1)],
                            marker="adobe0", restart_interval=23)
    yield "jpeg_lossless_separate_scans_v2_37x45.jpg", "tests/_jpeg_writer.py", \
        {"crop": [30, 300, 37, 45], "process": "lossless", "predictor": 6,
         "sampling": "1x2,1x1,1x1", "scans": "one a component", "restart_interval": 45,
         "ids": [82, 71, 66]}, \
        write_jpeg_lossless(planes(odd, "RGB"), 6, sampling=[(1, 2), (1, 1), (1, 1)],
                            marker=None, ids=[82, 71, 66], separate_scans=True,
                            restart_interval=45)
    cmyk = np.dstack([odd, odd[:, :, 0] // 2])
    yield "jpeg_lossless_cmyk_37x45.jpg", "tests/_jpeg_writer.py", \
        {"crop": [30, 300, 37, 45], "process": "lossless", "predictor": 7,
         "components": "C, M, Y = RGB, K = red / 2"}, \
        write_jpeg_lossless([cmyk[:, :, i] for i in range(4)], 7, marker=None)
    prog = pil_save(Image.fromarray(img), "JPEG", quality=85, progressive=True)
    yield "jpeg_smooth_unrefined_48x64.jpg", "PIL, then tests/_jpeg_writer.py drop_scans", \
        {"crop": [150, 220, 48, 64], "quality": 85, "progressive": True,
         "scans_kept": [0, 1, 2, 3, 4, 5]}, drop_scans(prog, set(range(6)))
    yield "jpeg_smooth_dc_only_48x64.jpg", "PIL, then tests/_jpeg_writer.py drop_scans", \
        {"crop": [150, 220, 48, 64], "quality": 85, "progressive": True, "scans_kept": [0]}, \
        drop_scans(prog, {0})
    unsent = [sc for k, sc in enumerate(SIMPLE_PROGRESSION) if k not in (1, 5, 9)]
    yield "jpeg_smooth_arith_low_ac_unsent_37x45.jpg", "tests/_jpeg_writer.py", \
        {"crop": [30, 300, 37, 45], "coder": "arithmetic", "sampling": "2x2,1x1,1x1",
         "scans": "libjpeg's simple progression without scans 1, 5 and 9 (luma AC 1-5 never "
                  "sent, 6-63 left at Al 2)"}, \
        write_jpeg_arith(planes(odd), [(2, 2), (1, 1), (1, 1)], scans=unsent)
    t = {"crop": [100, 200, 96, 128], "timing": True}
    yield "timing_jpeg_baseline.jpg", "PIL", dict(t, quality=90), \
        pil_save(Image.fromarray(tile), "JPEG", quality=90)
    yield "timing_jpeg_arith.jpg", "tests/_jpeg_writer.py", dict(t, coder="arithmetic"), \
        write_jpeg_arith(planes(tile), [(2, 2), (1, 1), (1, 1)])
    yield "timing_jpeg_lossless.jpg", "tests/_jpeg_writer.py", dict(t, process="lossless",
                                                                    predictor=7), \
        write_jpeg_lossless(planes(tile, "RGB"), 7, marker=None)
    tprog = pil_save(Image.fromarray(tile), "JPEG", quality=90, progressive=True)
    yield "timing_jpeg_smooth.jpg", "PIL, then tests/_jpeg_writer.py drop_scans", \
        dict(t, quality=90, progressive=True, scans_kept=[0, 1, 2, 3, 4, 5]), \
        drop_scans(tprog, set(range(6)))
    base = write_jpeg(planes(odd), [(2, 2), (1, 1), (1, 1)])
    yield "jpeg_12bit_stub.jpg", "tests/_jpeg_writer.py", {"precision_byte": 12}, \
        patched_sof(base, precision=12), "12-bit"
    yield "jpeg_hierarchical_sof5_stub.jpg", "tests/_jpeg_writer.py", {"sof": "0xC5"}, \
        patched_sof(base, marker=0xC5), "hierarchical"
    lossless = write_jpeg_lossless(planes(odd[:8, :8], "RGB"), 1, marker=None)
    yield "jpeg_lossless_arith_sof11_stub.jpg", "tests/_jpeg_writer.py", {"sof": "0xCB"}, \
        patched_sof(lossless, marker=0xCB), "lossless arithmetic-coded"
    yield "jpeg_lossless_jfif_ycbcr_8x8.jpg", "tests/_jpeg_writer.py", \
        {"process": "lossless", "marker": "JFIF"}, \
        write_jpeg_lossless(planes(odd[:8, :8]), 1, marker="jfif"), "lossless file in YCbCr"


def tiff_fixtures(rng):
    """TIFF variants: JPEG-compressed, YCbCr, CMYK, 32-bit and float grey,
    BigTIFF."""
    img, tile = crop(150, 220, 48, 64), crop(100, 200, 96, 128)
    odd = crop(30, 300, 37, 45)
    ycc = np.asarray(Image.fromarray(img).convert("YCbCr"))
    ycc_odd = np.asarray(Image.fromarray(odd).convert("YCbCr"))
    chunks, tables = jpeg_chunks(ycc, [(2, 2), (1, 1), (1, 1)], rows_per_strip=16)
    yield "tiff_jpeg_compression.tif", "tests/_tiff_writer.py", \
        {"crop": [150, 220, 48, 64], "compression": "jpeg", "photometric": 6,
         "ycbcr_subsampling": [2, 2], "rows_per_strip": 16, "jpeg_tables": True}, \
        write_tiff(ycc, 6, 8, 7, rows_per_strip=16, chunks=chunks, ycbcr_subsampling=(2, 2),
                   extra_tags=[(347, 7, tables)])
    chunks, tables = jpeg_chunks(ycc_odd, [(2, 1), (1, 1), (1, 1)], tile=(32, 16),
                                 restart_interval=2)
    yield "tiff_jpeg_ycbcr422_tiles_37x45.tif", "tests/_tiff_writer.py", \
        {"crop": [30, 300, 37, 45], "compression": "jpeg", "photometric": 6,
         "ycbcr_subsampling": [2, 1], "tile": [32, 16], "restart_interval": 2}, \
        write_tiff(ycc_odd, 6, 8, 7, tile=(32, 16), chunks=chunks, ycbcr_subsampling=(2, 1),
                   extra_tags=[(347, 7, tables)])
    chunks, tables = jpeg_chunks(odd, [(1, 1)] * 3, rows_per_strip=8, write=write_jpeg_arith,
                                 adobe_transform=0)
    yield "tiff_jpeg_arith_rgb_strips_37x45.tif", "tests/_tiff_writer.py", \
        {"crop": [30, 300, 37, 45], "compression": "jpeg", "photometric": 2,
         "coder": "arithmetic", "rows_per_strip": 8}, \
        write_tiff(odd, 2, 8, 7, rows_per_strip=8, chunks=chunks, extra_tags=[(347, 7, tables)])
    for mode in ("RGB", "L", "CMYK", "YCbCr"):
        yield f"tiff_pil_jpeg_{mode}.tif", "PIL", \
            {"crop": [30, 300, 37, 45], "mode": mode, "compression": "jpeg", "quality": 80}, \
            pil_save(Image.fromarray(odd).convert(mode), "TIFF", compression="jpeg", quality=80)
    for sub, comp in (((2, 2), "lzw"), ((4, 2), "deflate"), ((1, 1), "packbits")):
        yield f"tiff_ycbcr{sub[0]}{sub[1]}_{comp}_37x45.tif", "tests/_tiff_writer.py", \
            {"crop": [30, 300, 37, 45], "photometric": 6, "ycbcr_subsampling": list(sub),
             "compression": comp, "rows_per_strip": 8}, \
            write_tiff(ycc_odd, 6, 8, comp, ycbcr_subsampling=sub, rows_per_strip=8)
    yield "tiff_ycbcr21_coefficients_orientation6_37x45.tif", "tests/_tiff_writer.py", \
        {"crop": [30, 300, 37, 45], "photometric": 6, "ycbcr_subsampling": [2, 1],
         "compression": "lzw", "ycbcr_coefficients": "0.2125 0.7154 0.0721",
         "reference_black_white": "16 235 128 240 128 240", "orientation": 6}, \
        write_tiff(ycc_odd, 6, 8, "lzw", ycbcr_subsampling=(2, 1), rows_per_strip=8,
                   extra_tags=[(529, 5, [(2125, 10000), (7154, 10000), (721, 10000)]),
                               (532, 5, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1),
                                         (240, 1)]),
                               (274, 3, [6])])
    k = (255 - odd.max(axis=2)).astype(np.int64)
    cmyk = np.dstack([255 - odd.astype(np.int64) - k[:, :, None], k]).clip(0, 255)
    yield "tiff_cmyk_none_37x45.tif", "tests/_tiff_writer.py", \
        {"crop": [30, 300, 37, 45], "photometric": 5, "cmyk": "k = 255 - max(rgb)"}, \
        write_tiff(cmyk, 5, 8)
    yield "tiff_cmyk_planar_lzw_be_37x45.tif", "tests/_tiff_writer.py", \
        {"crop": [30, 300, 37, 45], "photometric": 5, "planar": True, "compression": "lzw",
         "big_endian": True}, write_tiff(cmyk, 5, 8, "lzw", planar=True, big_endian=True)
    yield "tiff_cmyk16_deflate_p2_37x45.tif", "tests/_tiff_writer.py", \
        {"crop": [30, 300, 37, 45], "photometric": 5, "bits": 16, "compression": "deflate",
         "predictor": 2, "samples": "8-bit value * 257 + seeded low byte"}, \
        write_tiff(cmyk * 257 - rng.integers(0, 200, cmyk.shape).clip(0, cmyk * 257), 5, 16,
                   "deflate", 2)
    yield "tiff_cmykx_packbits_37x45.tif", "tests/_tiff_writer.py", \
        {"crop": [30, 300, 37, 45], "photometric": 5, "extra_samples": [0],
         "compression": "packbits"}, \
        write_tiff(np.dstack([cmyk, k]), 5, 8, "packbits", extra_samples=[0])
    yield "tiff_pil_cmyk_lzw.tif", "PIL", {"crop": [30, 300, 37, 45], "mode": "CMYK",
                                           "compression": "tiff_lzw"}, \
        pil_save(Image.fromarray(odd).convert("CMYK"), "TIFF", compression="tiff_lzw")
    grey = odd[:, :, 1].astype(np.float64)
    floats = np.float32(grey * 1.3 - 40 + rng.random(grey.shape))
    floats[0, :6] = [np.nan, np.inf, -np.inf, -0.5, 254.99, 255.0]
    yield "tiff_float32.tif", "tests/_tiff_writer.py", \
        {"crop": [30, 300, 37, 45], "bits": 32, "sample_format": 3,
         "samples": "1.3 * green - 40 + seeded [0, 1), first row NaN, inf, -inf, -0.5, "
                    "254.99, 255"}, \
        write_tiff(floats.view(np.uint32).astype(np.int64), 1, 32, sample_format=3)
    yield "tiff_float32_min_is_white_be_16x20.tif", "tests/_tiff_writer.py", \
        {"crop": [30, 300, 16, 20], "bits": 32, "sample_format": 3, "big_endian": True,
         "photometric": 0}, \
        write_tiff(floats[:16, :20].view(np.uint32).astype(np.int64), 0, 32, "none",
                   big_endian=True, sample_format=3)
    ints = (grey.astype(np.int64) * 3 - 200)
    yield "tiff_int32_signed_lzw_p2_37x45.tif", "tests/_tiff_writer.py", \
        {"crop": [30, 300, 37, 45], "bits": 32, "sample_format": 2, "compression": "lzw",
         "predictor": 2, "samples": "3 * green - 200"}, \
        write_tiff(ints & 0xFFFFFFFF, 1, 32, "lzw", 2, sample_format=2)
    yield "tiff_int32_unsigned_16x20.tif", "tests/_tiff_writer.py", \
        {"crop": [30, 300, 16, 20], "bits": 32, "samples": "3 * green - 200, mod 2^32"}, \
        write_tiff(ints[:16, :20] & 0xFFFFFFFF, 1, 32)
    yield "tiff_pil_I_deflate.tif", "PIL", {"crop": [30, 300, 37, 45], "mode": "I",
                                            "samples": "3 * green - 200",
                                            "compression": "tiff_deflate"}, \
        pil_save(Image.fromarray(ints.astype(np.int32), "I"), "TIFF", compression="tiff_deflate")
    yield "tiff_bigtiff_lzw_37x45.tif", "tests/_tiff_writer.py", \
        {"crop": [30, 300, 37, 45], "bigtiff": True, "compression": "lzw", "predictor": 2,
         "rows_per_strip": 7}, \
        write_tiff(odd, 2, 8, "lzw", 2, bigtiff=True, rows_per_strip=7)
    yield "tiff_bigtiff_tiles_37x45.tif", "tests/_tiff_writer.py", \
        {"crop": [30, 300, 37, 45], "bigtiff": True, "compression": "deflate",
         "tile": [16, 16]}, write_tiff(odd, 2, 8, "deflate", bigtiff=True, tile=(16, 16))
    yield "tiff_bigtiff_big_endian_stub.tif", "tests/_tiff_writer.py", \
        {"bigtiff": True, "big_endian": True}, \
        write_tiff(odd[:4, :4], 2, 8, bigtiff=True, big_endian=True), "big-endian BigTIFF"
    yield "tiff_cielab_8x8.tif", "PIL", {"crop": [30, 300, 8, 8], "mode": "LAB",
                                         "samples": "lab_bytes of the crop"}, \
        pil_save(Image.fromarray(lab_bytes(odd[:8, :8]), "LAB"), "TIFF")
    lab = np.stack(np.meshgrid(np.arange(0, 256, 7), np.arange(0, 256, 5), indexing="ij"), -1)
    lab = np.concatenate([lab[:, :, :1], lab], axis=2).reshape(37, 52, 3)
    lab[:, :, 0] = np.arange(37 * 52).reshape(37, 52) % 256
    yield "tiff_cielab_lzw_sweep_37x52.tif", "tests/_tiff_writer.py", \
        {"photometric": 8, "compression": "lzw",
         "samples": "L = index mod 256, a every 7th byte, b every 5th byte (signed)"}, \
        write_tiff(lab, 8, 8, "lzw")
    t = {"crop": [100, 200, 96, 128], "timing": True}
    tycc = np.asarray(Image.fromarray(tile).convert("YCbCr"))
    chunks, tables = jpeg_chunks(tycc, [(2, 2), (1, 1), (1, 1)], rows_per_strip=16)
    yield "timing_tiff_jpeg.tif", "tests/_tiff_writer.py", \
        dict(t, compression="jpeg", photometric=6, ycbcr_subsampling=[2, 2], rows_per_strip=16), \
        write_tiff(tycc, 6, 8, 7, rows_per_strip=16, chunks=chunks, ycbcr_subsampling=(2, 2),
                   extra_tags=[(347, 7, tables)])
    yield "timing_tiff_ycbcr.tif", "tests/_tiff_writer.py", \
        dict(t, compression="deflate", photometric=6, ycbcr_subsampling=[2, 2],
             rows_per_strip=16), \
        write_tiff(tycc, 6, 8, "deflate", ycbcr_subsampling=(2, 2), rows_per_strip=16)
    tk = (255 - tile.max(axis=2)).astype(np.int64)
    tcmyk = np.dstack([255 - tile.astype(np.int64) - tk[:, :, None], tk]).clip(0, 255)
    yield "timing_tiff_cmyk.tif", "tests/_tiff_writer.py", \
        dict(t, photometric=5, cmyk="k = 255 - max(rgb)", compression="deflate", predictor=2), \
        write_tiff(tcmyk, 5, 8, "deflate", 2)
    yield "timing_tiff_float32.tif", "tests/_tiff_writer.py", \
        dict(t, bits=32, sample_format=3, compression="deflate", samples="green"), \
        write_tiff(np.float32(tile[:, :, 1]).view(np.uint32).astype(np.int64), 1, 32, "deflate",
                   sample_format=3)
    yield "timing_tiff_cielab.tif", "tests/_tiff_writer.py", \
        dict(t, photometric=8, samples="lab_bytes of the tile", compression="deflate",
             predictor=2), write_tiff(lab_bytes(tile).astype(np.int64), 8, 8, "deflate", 2)
    yield "timing_tiff_bigtiff.tif", "tests/_tiff_writer.py", \
        dict(t, bigtiff=True, compression="deflate", predictor=2), \
        write_tiff(tile, 2, 8, "deflate", 2, bigtiff=True)


def netpbm(magic, samples, maxval=None, plain=False):
    h, w = samples.shape[:2]
    head = b"%s\n# a comment\n%d %d\n" % (magic, w, h)
    if maxval is not None:
        head += b"%d\n" % maxval
    if plain:
        toks = [str(int(v)) for v in samples.ravel()]
        lines = (" ".join(toks[i:i + 12]) for i in range(0, len(toks), 12))
        return head + "\n".join(lines).encode() + b"\n"
    if magic == b"P4":
        return head + np.packbits(samples.astype(np.uint8), axis=1).tobytes()
    return head + samples.astype(np.uint8 if maxval < 256 else ">u2").tobytes()


def fixtures():
    """(file name, writer, parameters, bytes) or with a fifth item, the
    refusal the port names."""
    rng = np.random.default_rng(2026)
    small, tile = crop(40, 60, 17, 33), crop(100, 200, 96, 128)
    big = crop(64, 200, 256, 360)
    yield "webp_lossy_q10_17x33.webp", "PIL", {"crop": [40, 60, 17, 33], "quality": 10}, \
        pil_save(Image.fromarray(small), "WEBP", quality=10)
    yield "webp_lossy_q50_17x33.webp", "PIL", {"crop": [40, 60, 17, 33], "quality": 50}, \
        pil_save(Image.fromarray(small), "WEBP", quality=50)
    yield "webp_lossy_q90_17x33.webp", "PIL", {"crop": [40, 60, 17, 33], "quality": 90}, \
        pil_save(Image.fromarray(small), "WEBP", quality=90)
    yield "webp_lossy_1x1.webp", "PIL", {"crop": [7, 9, 1, 1], "quality": 50}, \
        pil_save(Image.fromarray(crop(7, 9, 1, 1)), "WEBP", quality=50)
    yield "webp_lossy_7x13.webp", "PIL", {"crop": [300, 30, 7, 13], "quality": 50}, \
        pil_save(Image.fromarray(crop(300, 30, 7, 13)), "WEBP", quality=50)
    yield "webp_lossy_256x360.webp", "PIL", {"crop": [64, 200, 256, 360], "quality": 75}, \
        pil_save(Image.fromarray(big), "WEBP", quality=75)
    yield "webp_lossy_alpha_17x33.webp", "PIL", \
        {"crop": [40, 60, 17, 33], "quality": 50, "alpha_seed": 1}, \
        pil_save(rgba(small, 1), "WEBP", quality=50)
    yield "webp_lossless_alpha_17x33.webp", "PIL", \
        {"crop": [40, 60, 17, 33], "lossless": True, "exact": False, "alpha_seed": 2}, \
        pil_save(rgba(small, 2), "WEBP", lossless=True, exact=False)
    yield "webp_lossless_exact_alpha_17x33.webp", "PIL", \
        {"crop": [40, 60, 17, 33], "lossless": True, "exact": True, "alpha_seed": 2}, \
        pil_save(rgba(small, 2), "WEBP", lossless=True, exact=True)
    yield "webp_lossless_7x13.webp", "PIL", {"crop": [300, 30, 7, 13], "lossless": True}, \
        pil_save(Image.fromarray(crop(300, 30, 7, 13)), "WEBP", lossless=True)
    yield "webp_lossless_palette_48x64.webp", "PIL", \
        {"crop": [200, 100, 48, 64], "quantize": 12, "lossless": True}, \
        pil_save(Image.fromarray(crop(200, 100, 48, 64)).quantize(12).convert("RGB"), "WEBP",
                 lossless=True)
    yield "webp_simple_filter_partitions_48x64.webp", "tests/_webp_writer.py", \
        {"crop": [200, 100, 48, 64], "quality": 60, "filter_type": 0, "filter_strength": 80,
         "filter_sharpness": 5, "partitions": 3, "segments": 2}, \
        write_webp(crop(200, 100, 48, 64), 60, filter_type=0, filter_strength=80,
                   filter_sharpness=5, partitions=3, segments=2)
    frames = [Image.fromarray(small), Image.fromarray(small[::-1].copy())]
    yield "webp_animated_17x33.webp", "PIL", {"crop": [40, 60, 17, 33], "frames": 2}, \
        pil_save(frames[0], "WEBP", save_all=True, append_images=frames[1:], quality=50), \
        "animated WebP"

    pal = rng.integers(0, 256, (256, 3))
    grey = np.repeat(np.arange(256)[:, None], 3, 1)
    idx = rng.integers(0, 16, (17, 33))
    yield "gif_pil_48x64.gif", "PIL", {"crop": [200, 100, 48, 64]}, \
        pil_save(Image.fromarray(crop(200, 100, 48, 64)), "GIF")
    yield "gif_global_17x33.gif", "tests/_gif_writer.py", {"seed": 2026, "colours": 16}, \
        write_gif(idx, pal[:16])
    yield "gif_local_17x33.gif", "tests/_gif_writer.py", \
        {"seed": 2026, "colours": 16, "local_palette": True}, \
        write_gif(idx, pal[:4], local_palette=pal[16:32])
    yield "gif_interlaced_17x33.gif", "tests/_gif_writer.py", \
        {"seed": 2026, "colours": 16, "interlace": True}, write_gif(idx, pal[:16], interlace=True)
    yield "gif_transparency_17x33.gif", "tests/_gif_writer.py", \
        {"seed": 2026, "colours": 16, "transparency": 3}, write_gif(idx, pal[:16], transparency=3)
    yield "gif_grey_17x33.gif", "tests/_gif_writer.py", {"seed": 2026, "grey_ramp": 16}, \
        write_gif(idx, grey[:16])
    yield "gif_offset_frame_17x33_on_24x40.gif", "tests/_gif_writer.py", \
        {"seed": 2026, "colours": 16, "screen": [40, 24], "offset": [5, 4], "transparency": 2}, \
        write_gif(idx, pal[:16], screen=(40, 24), offset=(5, 4), transparency=2)

    rgb, g8 = crop(120, 40, 17, 33).astype(np.int64), crop(120, 40, 17, 33)[:, :, 1]
    for comp in ("none", "lzw", "deflate", "packbits"):
        for pred in (1, 2):
            yield f"tiff_rgb_{comp}_p{pred}.tif", "tests/_tiff_writer.py", \
                {"crop": [120, 40, 17, 33], "compression": comp, "predictor": pred}, \
                write_tiff(rgb, 2, 8, comp, pred)
    yield "tiff_pil_adobe_deflate.tif", "PIL", \
        {"crop": [120, 40, 17, 33], "compression": "tiff_adobe_deflate"}, \
        pil_save(Image.fromarray(crop(120, 40, 17, 33)), "TIFF", compression="tiff_adobe_deflate")
    yield "tiff_rgb_lzw_strips_be.tif", "tests/_tiff_writer.py", \
        {"crop": [120, 40, 17, 33], "compression": "lzw", "predictor": 2, "rows_per_strip": 5,
         "big_endian": True}, write_tiff(rgb, 2, 8, "lzw", 2, True, rows_per_strip=5)
    yield "tiff_rgb_deflate_tiles.tif", "tests/_tiff_writer.py", \
        {"crop": [120, 40, 17, 33], "compression": "deflate", "tile": [16, 16]}, \
        write_tiff(rgb, 2, 8, "deflate", tile=(16, 16))
    yield "tiff_rgb_lzw_planar_tiles_be.tif", "tests/_tiff_writer.py", \
        {"crop": [120, 40, 17, 33], "compression": "lzw", "planar": True, "tile": [16, 32],
         "big_endian": True}, write_tiff(rgb, 2, 8, "lzw", planar=True, tile=(16, 32),
                                         big_endian=True)
    yield "tiff_rgb_lzw_orientation6.tif", "tests/_tiff_writer.py", \
        {"crop": [120, 40, 17, 33], "compression": "lzw", "orientation": 6}, \
        write_tiff(rgb, 2, 8, "lzw", extra_tags=[(274, 3, [6])])
    yield "tiff_rgb_none_planar.tif", "tests/_tiff_writer.py", \
        {"crop": [120, 40, 17, 33], "compression": "none", "planar": True}, \
        write_tiff(rgb, 2, 8, "none", planar=True)
    r16 = rng.integers(0, 65536, (17, 33, 3))
    yield "tiff_rgb16_lzw_p2_be.tif", "tests/_tiff_writer.py", \
        {"seed": 2026, "bits": 16, "compression": "lzw", "predictor": 2, "big_endian": True}, \
        write_tiff(r16, 2, 16, "lzw", 2, True)
    a8 = np.dstack([rgb, rng.integers(0, 256, (17, 33))])
    for es in (0, 1, 2):
        yield f"tiff_rgba_extra{es}_packbits.tif", "tests/_tiff_writer.py", \
            {"crop": [120, 40, 17, 33], "alpha_seed": 2026, "extra_samples": [es],
             "compression": "packbits"}, write_tiff(a8, 2, 8, "packbits", extra_samples=[es])
    bits1 = (g8 > 120).astype(np.int64)
    yield "tiff_bilevel_packbits.tif", "tests/_tiff_writer.py", \
        {"crop": [120, 40, 17, 33], "bits": 1, "threshold": 120, "compression": "packbits"}, \
        write_tiff(bits1, 1, 1, "packbits")
    yield "tiff_bilevel_min_is_white_be.tif", "tests/_tiff_writer.py", \
        {"crop": [120, 40, 17, 33], "bits": 1, "photometric": 0, "big_endian": True}, \
        write_tiff(bits1, 0, 1, "none", big_endian=True)
    yield "tiff_grey8_min_is_white_lzw.tif", "tests/_tiff_writer.py", \
        {"crop": [120, 40, 17, 33], "bits": 8, "photometric": 0, "compression": "lzw"}, \
        write_tiff(g8, 0, 8, "lzw")
    g16 = g8.astype(np.int64) * 3 - 100
    g16 = np.clip(g16, 0, 65535)
    yield "tiff_grey16_deflate_p2.tif", "tests/_tiff_writer.py", \
        {"crop": [120, 40, 17, 33], "bits": 16, "samples": "3 * green - 100, clipped",
         "compression": "deflate", "predictor": 2}, write_tiff(g16, 1, 16, "deflate", 2)
    yield "tiff_grey16_none_be.tif", "tests/_tiff_writer.py", \
        {"crop": [120, 40, 17, 33], "bits": 16, "samples": "3 * green - 100, clipped",
         "big_endian": True}, write_tiff(g16, 1, 16, "none", big_endian=True)
    tpal = rng.integers(0, 65536, (256, 3))
    yield "tiff_palette4_lzw.tif", "tests/_tiff_writer.py", \
        {"seed": 2026, "bits": 4, "compression": "lzw"}, \
        write_tiff(rng.integers(0, 16, (17, 33)), 3, 4, "lzw", palette=tpal[:16])
    yield "tiff_palette8_none_be.tif", "tests/_tiff_writer.py", \
        {"crop": [120, 40, 17, 33], "bits": 8, "big_endian": True}, \
        write_tiff(g8, 3, 8, "none", big_endian=True, palette=tpal)
    for mode, comp in (("RGB", "tiff_lzw"), ("L", "tiff_deflate"), ("1", "packbits"),
                       ("P", "tiff_lzw")):
        img = Image.fromarray(crop(120, 40, 17, 33)).convert(mode)
        yield f"tiff_pil_{mode}_{comp}.tif", "PIL", \
            {"crop": [120, 40, 17, 33], "mode": mode, "compression": comp}, \
            pil_save(img, "TIFF", compression=comp)
    base = write_tiff(g8, 1, 8, "none")
    yield "tiff_ccitt_g4.tif", "tests/_tiff_writer.py", {"compression_tag": 4}, \
        base.replace(struct.pack("<HHII", 259, 3, 1, 1), struct.pack("<HHII", 259, 3, 1, 4)), \
        "CCITT"

    pgm, ppm = crop(250, 300, 13, 17)[:, :, 0], crop(250, 300, 13, 17)
    bits = (pgm > 128).astype(np.int64)
    yield "pbm_p1.pbm", "netpbm", {"crop": [250, 300, 13, 17], "magic": "P1", "threshold": 128}, \
        netpbm(b"P1", bits, plain=True)
    yield "pbm_p4.pbm", "netpbm", {"crop": [250, 300, 13, 17], "magic": "P4", "threshold": 128}, \
        netpbm(b"P4", bits)
    for maxval in (255, 1000, 65535):
        scaled_g = (pgm.astype(np.int64) * maxval) // 255
        scaled_c = (ppm.astype(np.int64) * maxval) // 255
        for magic, samples, plain in ((b"P2", scaled_g, True), (b"P3", scaled_c, True),
                                      (b"P5", scaled_g, False), (b"P6", scaled_c, False)):
            ext = "pgm" if magic in (b"P2", b"P5") else "ppm"
            yield f"{ext}_{magic.decode().lower()}_max{maxval}.{ext}", "netpbm", \
                {"crop": [250, 300, 13, 17], "magic": magic.decode(), "maxval": maxval,
                 "samples": "value * maxval // 255"}, netpbm(magic, samples, maxval, plain)

    bpal = rng.integers(0, 256, (256, 3))
    i8 = (crop(10, 10, 17, 33)[:, :, 2] // 16).astype(np.int64) * 3
    i8[:, :12] = i8[:, :1]
    yield "bmp_rle8_17x33.bmp", "tests/_bmp_writer.py", {"crop": [10, 10, 17, 33], "rle4": False}, \
        write_bmp_rle(33, 17, bpal, rle_encode(i8))
    i4 = i8 // 3
    yield "bmp_rle4_17x33.bmp", "tests/_bmp_writer.py", {"crop": [10, 10, 17, 33], "rle4": True}, \
        write_bmp_rle(33, 17, bpal[:16], rle_encode(i4, rle4=True), rle4=True)
    yield "bmp_rle8_top_down_17x33.bmp", "tests/_bmp_writer.py", \
        {"crop": [10, 10, 17, 33], "rle4": False, "top_down": True}, \
        write_bmp_rle(33, 17, bpal, rle_encode(i8, top_down=True), top_down=True)
    deltas = bytes([3, 7, 0, 2, 1, 1, 2, 2, 0, 0, 4, 9, 0, 0, 0, 2, 1, 0, 5, 6, 0, 0,
                    8, 11, 0, 1])
    yield "bmp_rle8_deltas_8x4.bmp", "tests/_bmp_writer.py", \
        {"stream": deltas.hex(), "rle4": False}, write_bmp_rle(8, 4, bpal, deltas)
    yield "bmp_rle4_deltas_8x4.bmp", "tests/_bmp_writer.py", \
        {"stream": deltas.hex(), "rle4": True}, write_bmp_rle(8, 4, bpal[:16], deltas, rle4=True)
    early = bytes([8, 5, 0, 0, 4, 6, 0, 1])
    yield "bmp_rle8_early_end_8x4.bmp", "tests/_bmp_writer.py", \
        {"stream": early.hex(), "rle4": False}, write_bmp_rle(8, 4, bpal, early), \
        "ends before the image is complete"

    yield from jpeg_fixtures(rng)
    yield from tiff_fixtures(rng)

    timing = Image.fromarray(tile)
    t = {"crop": [100, 200, 96, 128], "timing": True}
    yield "timing_webp_lossy.webp", "PIL", dict(t, quality=80), pil_save(timing, "WEBP", quality=80)
    yield "timing_webp_lossless.webp", "PIL", dict(t, lossless=True), \
        pil_save(timing, "WEBP", lossless=True)
    yield "timing_gif.gif", "PIL", dict(t), pil_save(timing, "GIF")
    yield "timing_tiff_lzw.tif", "PIL", dict(t, compression="tiff_lzw"), \
        pil_save(timing, "TIFF", compression="tiff_lzw")
    yield "timing_ppm.ppm", "PIL", dict(t), pil_save(timing, "PPM")
    q = np.asarray(timing.quantize(64))
    qpal = np.asarray(timing.quantize(64).getpalette()[:192]).reshape(64, 3)
    yield "timing_bmp_rle8.bmp", "tests/_bmp_writer.py", dict(t, quantize=64), \
        write_bmp_rle(128, 96, qpal, rle_encode(q))


def main():
    OUT.mkdir(parents=True, exist_ok=True)
    entries = []
    for item in fixtures():
        name, writer, params, data = item[:4]
        (OUT / name).write_bytes(data)
        entry = {"file": f"data/corpus/image_formats/{name}", "format": KINDS[Path(name).suffix],
                 "writer": writer, "params": params}
        if len(item) == 5:
            entry["refused"] = item[4]
        else:
            rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), np.uint8)
            entry["shape"] = list(rgb.shape)
            entry["sha256_pil_rgb"] = hashlib.sha256(rgb.tobytes()).hexdigest()
        entries.append(entry)
    manifest = {
        "purpose": "Fixtures of the formats the JAX package opens through PIL beside PNG and "
                   "baseline JPEG: the port's WebP, GIF, TIFF, netpbm and RLE BMP decoders and "
                   "its JPEG decoder's arithmetic, lossless and smoothing paths are held to "
                   "PIL's convert('RGB') decode of each file (sha256_pil_rgb, of the uint8 HWC "
                   "array's bytes); entries with 'refused' are variants the port refuses by "
                   "name, as PIL refuses or misreads them.",
        "pil": PIL.__version__,
        "source": SOURCE,
        "recipe": "python tests/_image_formats_corpus.py",
        "files": entries,
    }
    (OUT / "MANIFEST.json").write_text(json.dumps(manifest, indent=1) + "\n")
    total = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"{len(entries)} files, {total} bytes")


if __name__ == "__main__":
    main()
