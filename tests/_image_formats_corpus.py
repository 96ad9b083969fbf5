"""Writes data/corpus/image_formats/ and its MANIFEST.json: the WebP, GIF,
TIFF, netpbm and RLE BMP fixtures that the port's decoders are held to, and
the JPEG processes beside baseline (arithmetic coding, lossless, block
smoothing); data/corpus/texture_formats/ and its MANIFEST.json: the
DDS, TGA, ICO, CUR, QOI, PCX, DCX and SGI fixtures; and
data/corpus/psd_dib_anim/ and its MANIFEST.json: animated WebP, PSD and
DIB.

    python tests/_image_formats_corpus.py

Each file is a crop of data/corpus/gallery/gt_1.png (or samples drawn from
a numpy seed) written by Pillow or by a writer under tests/ (_webp_writer,
_gif_writer, _tiff_writer, _bmp_writer, _jpeg_writer, _dds_writer,
_tga_writer, _ico_writer, _sgi_writer, _psd_writer; netpbm is written
here; a DIB is a BMP without its 14-byte file header). The
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
from _dds_writer import (DDPF_ALPHAPIXELS, DDPF_PALETTE8, DDPF_RGB,  # noqa: E402
                         block_count, encode_bc7_mode6, random_blocks, write_dds)
from _gif_writer import write_gif  # noqa: E402
from _ico_writer import dib, pcx_planar, write_dcx, write_icon  # noqa: E402
from _jpeg_writer import (drop_scans, write_jpeg, write_jpeg_arith,  # noqa: E402
                          write_jpeg_lossless)
from _psd_writer import write_psd  # noqa: E402
from _sgi_writer import write_sgi  # noqa: E402
from _tga_writer import write_tga  # noqa: E402
from _tiff_writer import jpeg_chunks, write_tiff  # noqa: E402
from _webp_writer import animation, anmf, write_webp  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "data/corpus/image_formats"
TEXTURES = ROOT / "data/corpus/texture_formats"
LAYERED = ROOT / "data/corpus/psd_dib_anim"
SOURCE = "data/corpus/gallery/gt_1.png"
GALLERY = np.asarray(Image.open(ROOT / SOURCE).convert("RGB"))
KINDS = {".webp": "webp", ".gif": "gif", ".tif": "tiff", ".pbm": "pnm", ".pgm": "pnm",
         ".ppm": "pnm", ".bmp": "bmp", ".jpg": "jpeg", ".dds": "dds", ".tga": "tga",
         ".ico": "ico", ".cur": "cur", ".qoi": "qoi", ".pcx": "pcx", ".dcx": "dcx",
         ".sgi": "sgi", ".psd": "psd", ".dib": "dib"}
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


def psd_cmyk(rgb):
    """An image's CMYK planes as a PSD stores them, ink inverted (0 is full
    ink): k = 255 - max(rgb), c, m, y = 255 - rgb - k, as the TIFF
    fixtures take them."""
    k = 255 - rgb.max(axis=2).astype(np.int64)
    cmyk = np.dstack([255 - rgb.astype(np.int64) - k[:, :, None], k]).clip(0, 255)
    return [(255 - cmyk[:, :, i]).astype(np.uint8) for i in range(4)]


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
        pil_save(frames[0], "WEBP", save_all=True, append_images=frames[1:], quality=50)

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


def bc_modes(rng, count, modes, size=16):
    """``count`` seeded blocks a mode, the modes in turn."""
    per = [random_blocks(rng, count, size, m) for m in modes]
    return b"".join(p[i * size:(i + 1) * size] for i in range(count) for p in per)


def texture_fixtures(rng):
    """The DDS, TGA, ICO, CUR, QOI, PCX, DCX and SGI fixtures, as ``fixtures``
    yields them."""
    small, tiny = crop(40, 60, 17, 33), crop(200, 100, 13, 17)
    tile = crop(100, 200, 96, 128)
    c = {"crop": [40, 60, 17, 33]}
    ct = {"crop": [200, 100, 13, 17]}
    # DDS: Pillow's encoders, then the writer's headers over seeded blocks
    for fmt, img in (("DXT1", Image.fromarray(small)), ("DXT3", rgba(small, 3)),
                     ("DXT5", rgba(small, 5)), ("BC5", Image.fromarray(small))):
        yield f"dds_{fmt.lower()}_pil_17x33.dds", "PIL", dict(c, pixel_format=fmt), \
            pil_save(img, "DDS", pixel_format=fmt)
    raw = random_blocks(rng, 64, 8)
    punch = np.frombuffer(raw, np.uint8).reshape(64, 8).copy()
    lo, hi = punch[:, 0:2].copy(), punch[:, 2:4].copy()
    swap = lo.view("<u2")[:, 0] > hi.view("<u2")[:, 0]
    punch[swap, 0:2], punch[swap, 2:4] = hi[swap], lo[swap]  # colour 0 <= colour 1
    yield "dds_dxt1_three_colour_32x32.dds", "tests/_dds_writer.py", \
        {"seed": 2026, "fourcc": "DXT1", "blocks": "c0 <= c1: three colours and black"}, \
        write_dds(32, 32, punch.tobytes(), fourcc="DXT1")
    for name, kw, size in (("ati1", dict(fourcc="ATI1"), 8), ("bc4u", dict(fourcc="BC4U"), 8),
                           ("bc4_dx10", dict(dxgi="BC4"), 8), ("ati2", dict(fourcc="ATI2"), 16),
                           ("bc5s", dict(fourcc="BC5S"), 16),
                           ("bc5_snorm_dx10", dict(dxgi="BC5_SNORM"), 16),
                           ("bc1_dx10", dict(dxgi="BC1"), 8), ("bc2_dx10", dict(dxgi="BC2"), 16),
                           ("bc3_dx10", dict(dxgi="BC3"), 16)):
        yield f"dds_{name}_random_19x13.dds", "tests/_dds_writer.py", \
            dict(kw, seed=2026, blocks="random"), \
            write_dds(19, 13, random_blocks(rng, block_count(19, 13), size), **kw)
    bc6 = [("bc6", b) for b in (0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 3, 7, 11, 15, 19, 23, 27,
                                31)]
    for fmt in ("BC6H_UF16", "BC6H_SF16"):
        yield f"dds_{fmt.lower()}_modes_36x32.dds", "tests/_dds_writer.py", \
            {"seed": 2026, "dxgi": fmt, "blocks": "4 random blocks of each of the 18 mode codes"}, \
            write_dds(36, 32, bc_modes(rng, 4, bc6), dxgi=fmt)
    modes = list(range(8))
    yield "dds_bc7_modes_32x18.dds", "tests/_dds_writer.py", \
        {"seed": 2026, "dxgi": "BC7", "blocks": "5 random blocks of each mode, then empty ones"}, \
        write_dds(32, 18, bc_modes(rng, 5, modes) + bytes(16 * 5), dxgi="BC7")
    padded = np.pad(small, ((0, 3), (0, 3), (0, 0)), mode="edge")
    yield "dds_bc7_mode6_17x33.dds", "tests/_dds_writer.py", \
        dict(c, dxgi="BC7_SRGB", encoder="mode 6, channel range endpoints"), \
        write_dds(33, 17, encode_bc7_mode6(padded), dxgi="BC7_SRGB")
    for mode in ("RGB", "RGBA", "L", "LA"):
        yield f"dds_{mode.lower()}_pil_13x17.dds", "PIL", dict(ct, mode=mode), \
            pil_save(Image.fromarray(tiny).convert(mode), "DDS")
    t16 = tiny.astype(np.int64)
    r565 = ((t16[:, :, 0] >> 3) << 11) | ((t16[:, :, 1] >> 2) << 5) | (t16[:, :, 2] >> 3)
    yield "dds_r5g6b5_13x17.dds", "tests/_dds_writer.py", dict(ct, masks="F800 07E0 001F"), \
        write_dds(17, 13, r565.astype("<u2").tobytes(), pfflags=DDPF_RGB, bitcount=16,
                  masks=(0xF800, 0x7E0, 0x1F, 0))
    odd = rng.integers(0, 1 << 24, (13, 17)).astype("<u4")
    yield "dds_odd_masks_13x17.dds", "tests/_dds_writer.py", \
        {"seed": 2026, "bitcount": 24, "masks": "0x3 << 3, 0x3F0 << 6, 0x5, alpha 0xC00000",
         "truncated_by": 7}, \
        write_dds(17, 13, b"".join(int(v).to_bytes(3, "little") for v in odd.ravel())[:-7],
            pfflags=DDPF_RGB | DDPF_ALPHAPIXELS, bitcount=24,
            masks=(0x3 << 3, 0x3F0 << 6, 0x5, 0xC00000))
    palette = rng.integers(0, 256, 1024, dtype=np.uint8)
    yield "dds_palette8_13x17.dds", "tests/_dds_writer.py", {"seed": 2026, "palette": "RGBA"}, \
        write_dds(17, 13, rng.integers(0, 256, 13 * 17, dtype=np.uint8).tobytes(),
                  pfflags=DDPF_PALETTE8, bitcount=8, palette=palette)
    yield "dds_r8g8b8a8_dx10_13x17.dds", "tests/_dds_writer.py", dict(ct, dxgi="R8G8B8A8"), \
        write_dds(17, 13, np.asarray(rgba(tiny, 7)).tobytes(), dxgi="R8G8B8A8")
    yield "dds_bc1_srgb_dxgi72_stub.dds", "tests/_dds_writer.py", {"dxgi": 72}, \
        write_dds(4, 4, bytes(8), dxgi=72), "DXGI format 72"
    yield "dds_dxt2_stub.dds", "tests/_dds_writer.py", {"fourcc": "DXT2"}, \
        write_dds(4, 4, bytes(16), fourcc="DXT2"), "pixel format 'DXT2'"

    # TGA: each image type, depth, origin and colour map
    yield "tga_rgb_pil_13x17.tga", "PIL", ct, pil_save(Image.fromarray(tiny), "TGA")
    yield "tga_rgba_pil_13x17.tga", "PIL", dict(ct, mode="RGBA"), pil_save(rgba(tiny, 9), "TGA")
    yield "tga_l_pil_13x17.tga", "PIL", dict(ct, mode="L"), \
        pil_save(Image.fromarray(tiny).convert("L"), "TGA")
    yield "tga_la_pil_13x17.tga", "PIL", dict(ct, mode="LA"), \
        pil_save(Image.fromarray(tiny).convert("LA"), "TGA")
    yield "tga_rle_pil_17x33.tga", "PIL", dict(c, compression="tga_rle"), \
        pil_save(Image.fromarray(small), "TGA", compression="tga_rle")
    yield "tga_p_rle_pil_13x17.tga", "PIL", dict(ct, mode="P", compression="tga_rle"), \
        pil_save(Image.fromarray(tiny).quantize(16), "TGA", compression="tga_rle")
    words = ((t16[:, :, 0] >> 3) << 10) | ((t16[:, :, 1] >> 3) << 5) | (t16[:, :, 2] >> 3)
    yield "tga_type2_16bit_top_right_13x17.tga", "tests/_tga_writer.py", \
        dict(ct, depth=16, origin="top_right"), write_tga(words | 0x8000, 2, 16, "top_right")
    yield "tga_type10_32bit_rle_top_left_13x17.tga", "tests/_tga_writer.py", \
        dict(ct, depth=32, origin="top_left", rle="random packet cuts"), \
        write_tga(np.asarray(rgba(tiny, 4)), 10, 32, "top_left", rle_rng=rng)
    idx = (tiny[:, :, 0] // 32).astype(np.int64)
    cmap = rng.integers(0, 256, (8, 3))
    yield "tga_type1_map_start_bottom_right_13x17.tga", "tests/_tga_writer.py", \
        dict(ct, map_start=3, map_entries=8, indices="red // 32 + 0..2, some past the map"), \
        write_tga(idx + (idx % 3), 1, 8, "bottom_right", cmap, map_start=3, image_id=b"ssr")
    yield "tga_type9_map16_rle_13x17.tga", "tests/_tga_writer.py", \
        dict(ct, map_depth=16, rle=True), \
        write_tga(idx, 9, 8, "bottom_left", rng.integers(0, 65536, 8), map_depth=16,
                  rle_rng=rng)
    yield "tga_type3_1bit_13x17.tga", "tests/_tga_writer.py", dict(ct, depth=1, threshold=128), \
        write_tga(tiny[:, :, 1] > 128, 3, 1, "top_left")
    yield "tga_type11_grey_map_rle_13x17.tga", "tests/_tga_writer.py", \
        dict(ct, depth=8, colour_map="a grey image read through its map, as PIL does"), \
        write_tga(idx, 11, 8, "bottom_left", cmap, rle_rng=rng)
    rows = b"".join(bytes(r) for r in tiny[::-1, :, ::-1].reshape(13, -1))
    raw = b"".join(bytes([len(rows[i:i + 384]) // 3 - 1]) + rows[i:i + 384]
                   for i in range(0, len(rows), 384))
    yield "tga_type10_raw_packets_across_rows_13x17.tga", "tests/_tga_writer.py", \
        dict(ct, rle="raw packets of 128 pixels, across rows"), \
        write_tga(tiny, 10, 24, rows_raw=raw)
    yield "tga_type11_1bit_rle_stub.tga", "tests/_tga_writer.py", {"depth": 1, "rle": True}, \
        write_tga(np.zeros((2, 8), np.uint8), 11, 1, rows_raw=bytes([0x81, 0])), "1-bit"

    # ICO and CUR
    yield "ico_png_pil_17x33.ico", "PIL", dict(c, sizes=[[16, 16], [33, 17]]), \
        pil_save(Image.fromarray(small), "ICO", sizes=[(16, 16), (33, 17)])
    yield "ico_bmp_pil_17x33.ico", "PIL", dict(c, sizes=[[33, 17]], bitmap_format="bmp"), \
        pil_save(Image.fromarray(small), "ICO", sizes=[(33, 17)], bitmap_format="bmp")
    pal = rng.integers(0, 256, (256, 3))
    frames = [(16, 16, 1, 2, dib(rng.integers(0, 2, (16, 16)), 1, pal[:2])),
              (24, 24, 4, 16, dib(rng.integers(0, 16, (24, 24)), 4, pal[:16])),
              (24, 24, 8, 0, dib(crop(0, 0, 24, 24)[:, :, 0] // 2, 8, pal)),
              (24, 24, 24, 0, dib(crop(0, 0, 24, 24), 24)),
              (20, 12, 32, 0, dib(np.asarray(rgba(crop(0, 0, 12, 20), 2)), 32))]
    yield "ico_dib_depths_24x24.ico", "tests/_ico_writer.py", \
        {"seed": 2026, "frames": "1-bit 16x16, 4-bit 24x24, 8-bit 24x24, 24-bit 24x24, 32-bit "
                                 "20x12: PIL reads the 4-bit 24x24"}, write_icon(frames)
    yield "ico_dib_8bit_first_24x24.ico", "tests/_ico_writer.py", \
        {"seed": 2026, "frames": "the 8-bit and 24-bit 24x24 frames"}, write_icon(frames[2:4])
    yield "ico_dib_1bit_16x16.ico", "tests/_ico_writer.py", {"seed": 2026, "bits": 1}, \
        write_icon(frames[:1])
    cur = [(16, 16, 0, 0, dib(crop(0, 0, 16, 16), 24)),
           (24, 20, 0, 0, dib(crop(30, 30, 20, 24)[:, :, 1] // 2, 8, pal)),
           (20, 30, 0, 0, dib(crop(30, 30, 30, 20), 24))]
    yield "cur_three_cursors_24x20.cur", "tests/_ico_writer.py", \
        {"crop": [30, 30, 20, 24], "frames": "16x16, 24x20, 20x30: PIL reads 24x20"}, \
        write_icon(cur, kind=2)

    # QOI, PCX, DCX, SGI
    yield "qoi_rgb_pil_17x33.qoi", "PIL", c, pil_save(Image.fromarray(small), "QOI")
    yield "qoi_rgba_pil_17x33.qoi", "PIL", dict(c, alpha_seed=6), pil_save(rgba(small, 6), "QOI")
    for mode in ("1", "L", "P", "RGB"):
        img = Image.fromarray(tiny).convert(mode) if mode != "P" else \
            Image.fromarray(tiny).quantize(32)
        yield f"pcx_{mode.lower()}_pil_13x17.pcx", "PIL", dict(ct, mode=mode), pil_save(img, "PCX")
    yield "pcx_rgb_width1_pil_13x1.pcx", "PIL", \
        {"crop": [200, 100, 13, 1], "quirk": "PIL writes lines its reader finds short"}, \
        pil_save(Image.fromarray(crop(200, 100, 13, 1)), "PCX"), "truncated"
    for planes in (2, 4):
        yield f"pcx_planar{planes}_13x17.pcx", "tests/_ico_writer.py", \
            {"seed": 2026, "planes": planes}, \
            pcx_planar(rng.integers(0, 1 << planes, (13, 17)), planes,
                       rng.integers(0, 256, (16, 3)))
    yield "dcx_two_pages_13x17.dcx", "tests/_ico_writer.py", \
        dict(ct, pages=["RGB", "P, whose palette ends the file"]), \
        write_dcx([pil_save(Image.fromarray(tiny), "PCX"),
                   pil_save(Image.fromarray(tiny).quantize(8), "PCX")])
    yield "sgi_rgb_pil_13x17.sgi", "PIL", ct, pil_save(Image.fromarray(tiny), "SGI")
    yield "sgi_l_pil_13x17.sgi", "PIL", dict(ct, mode="L"), \
        pil_save(Image.fromarray(tiny).convert("L"), "SGI")
    yield "sgi_rgba_16bit_pil_13x17.sgi", "PIL", dict(ct, mode="RGBA", bpc=2), \
        pil_save(rgba(tiny, 8), "SGI", bpc=2)
    yield "sgi_rgb_rle_17x33.sgi", "tests/_sgi_writer.py", dict(c, rle=True), \
        write_sgi(small, 1, rle=True)
    yield "sgi_rgba_rle_16bit_13x17.sgi", "tests/_sgi_writer.py", \
        dict(ct, rle=True, bpc=2, samples="value * 257 + seeded low byte"), \
        write_sgi(np.asarray(rgba(tiny, 5)).astype(np.int64) * 256 +
                  rng.integers(0, 256, (13, 17, 4)), 2, rle=True)
    yield "sgi_grey_dim1_rle_13x17.sgi", "tests/_sgi_writer.py", \
        dict(ct, rle=True, dimension=1), write_sgi(tiny[:, :, 2], 1, rle=True, dimension=1)

    t = {"crop": [100, 200, 96, 128], "timing": True}
    timing = Image.fromarray(tile)
    yield "timing_dds_bc1.dds", "PIL", dict(t, pixel_format="DXT1"), \
        pil_save(timing, "DDS", pixel_format="DXT1")
    yield "timing_dds_bc7.dds", "tests/_dds_writer.py", dict(t, dxgi="BC7", encoder="mode 6"), \
        write_dds(128, 96, encode_bc7_mode6(tile), dxgi="BC7")
    yield "timing_tga_rle.tga", "PIL", dict(t, compression="tga_rle"), \
        pil_save(timing, "TGA", compression="tga_rle")
    yield "timing_ico_png.ico", "PIL", dict(t, sizes=[[128, 96]]), \
        pil_save(timing, "ICO", sizes=[(128, 96)])
    q = timing.quantize(256)
    qpal = np.asarray(q.getpalette()[:768]).reshape(-1, 3)
    yield "timing_cur_dib8.cur", "tests/_ico_writer.py", dict(t, quantize=256, bits=8), \
        write_icon([(128, 96, 0, 0, dib(np.asarray(q), 8, np.pad(qpal, ((0, 256 - len(qpal)),
                                                                    (0, 0)))))], kind=2)
    yield "timing_qoi.qoi", "PIL", dict(t), pil_save(timing, "QOI")
    yield "timing_pcx_rgb.pcx", "PIL", dict(t), pil_save(timing, "PCX")
    yield "timing_dcx_p.dcx", "tests/_ico_writer.py", dict(t, quantize=256), \
        write_dcx([pil_save(q, "PCX")])
    yield "timing_sgi_rle.sgi", "tests/_sgi_writer.py", dict(t, rle=True), \
        write_sgi(tile, 1, rle=True)


def psd_dib_anim_fixtures(rng):
    """The animated WebP, PSD and DIB fixtures, as ``fixtures`` yields them."""
    small, tile = crop(40, 60, 17, 33), crop(100, 200, 96, 128)
    c, t = {"crop": [40, 60, 17, 33]}, {"crop": [100, 200, 96, 128], "timing": True}
    frames = [Image.fromarray(small), Image.fromarray(small[::-1].copy()),
              Image.fromarray(255 - small)]
    yield "webp_anim_lossy_3_frames_17x33.webp", "PIL", dict(c, frames=3, quality=50), \
        pil_save(frames[0], "WEBP", save_all=True, append_images=frames[1:], quality=50)
    border = np.dstack([small, np.full(small.shape[:2], 200, np.uint8)])
    border[:3, :, 3] = border[:, :4, 3] = 0  # Pillow's encoder crops the frame: an offset
    yield "webp_anim_lossless_alpha_offset_17x33.webp", "PIL", \
        dict(c, frames=2, lossless=True, transparent=[3, 4]), \
        pil_save(Image.fromarray(border), "WEBP", save_all=True, lossless=True,
                 append_images=[Image.fromarray(small)])
    part = Image.fromarray(small[:9, :14])
    yield "webp_anim_built_offset_no_blend_40x30.webp", "tests/_webp_writer.py", \
        {"crop": [40, 60, 9, 14], "canvas": [40, 30], "offset": [6, 4], "flags": 3,
         "quality": 60, "frames": 2}, \
        animation((40, 30), anmf(6, 4, part, 3, quality=60), anmf(0, 0, part, lossless=True))

    rgb = [small[:, :, i] for i in range(3)]
    q = Image.fromarray(small).quantize(64)
    pal = np.zeros((256, 3), np.uint8)
    pal[:64] = np.asarray(q.getpalette()[:192]).reshape(64, 3)
    red = small[:, :, 0]
    for name, chans, mode, kw in (
            ("bitmap", [red > np.median(red)], 0, dict(depth=1)),
            ("grey", rgb[1:2], 1, {}),
            ("indexed", [np.asarray(q)], 2, dict(color_data=pal.T.tobytes())),
            ("rgb", rgb, 3, {}),
            ("rgba", rgb + [small[:, :, 0] // 2], 3, {}),
            ("cmyk", psd_cmyk(small), 4, {}),
            ("multichannel", rgb, 7, {}),
            ("duotone", rgb[2:], 8, dict(color_data=bytes(range(40)))),
            ("lab", planes(small, "LAB"), 9, {}),
            ("rgb_resources_layers", rgb, 3, dict(
                resources=[(1039, b"icc", b"\1\2\3"), (1005, b"", bytes(16))],
                layer_data=struct.pack(">I", 8) + bytes(8)))):
        for compression, label in ((0, "raw"), (1, "packbits")):
            yield f"psd_{name}_{label}_17x33.psd", "tests/_psd_writer.py", \
                dict(c, mode=mode, channels=len(chans), compression=compression,
                     **{k: v for k, v in kw.items() if k == "depth"}), \
                write_psd(chans, mode, compression=compression, **kw)
    for name, kw, refused in (("psb", dict(version=2), "PSB"),
                              ("rgb_16bit", dict(depth=16), "16-bit RGB"),
                              ("rgb_zip", dict(compression=2), "ZIP compression")):
        yield f"psd_{name}_stub.psd", "tests/_psd_writer.py", dict(c, **kw), \
            write_psd([p[:2, :3] for p in rgb], 3, **kw), refused

    yield "dib_rgb24_17x33.dib", "PIL", dict(c, cut=14), pil_save(Image.fromarray(small),
                                                                  "BMP")[14:]
    yield "dib_palette8_17x33.dib", "PIL", dict(c, quantize=64, cut=14), pil_save(q, "BMP")[14:]
    idx = rng.integers(0, 6, (9, 14))
    yield "dib_rle8_9x14.dib", "tests/_bmp_writer.py", {"seed": 2026, "cut": 14}, \
        write_bmp_rle(14, 9, rng.integers(0, 256, (256, 3)), rle_encode(idx))[14:]

    tile_img = Image.fromarray(tile)
    yield "timing_webp_anim.webp", "PIL", dict(t, frames=2, quality=90), \
        pil_save(tile_img, "WEBP", save_all=True, quality=90,
                 append_images=[Image.fromarray(tile[::-1].copy())])
    trgb = [tile[:, :, i] for i in range(3)]
    yield "timing_psd_rgb_packbits.psd", "tests/_psd_writer.py", dict(t, mode=3, compression=1), \
        write_psd(trgb, 3, compression=1)
    yield "timing_psd_cmyk_raw.psd", "tests/_psd_writer.py", dict(t, mode=4, compression=0), \
        write_psd(psd_cmyk(tile), 4)
    yield "timing_psd_lab_packbits.psd", "tests/_psd_writer.py", dict(t, mode=9, compression=1), \
        write_psd(planes(tile, "LAB"), 9, compression=1)
    yield "timing_dib_rgb24.dib", "PIL", dict(t, cut=14), pil_save(tile_img, "BMP")[14:]


def write_corpus(out, items, purpose, one_line_entries=False):
    out.mkdir(parents=True, exist_ok=True)
    entries = []
    for item in items:
        name, writer, params, data = item[:4]
        (out / name).write_bytes(data)
        entry = {"file": str((out / name).relative_to(ROOT)), "format": KINDS[Path(name).suffix],
                 "writer": writer, "params": params}
        if len(item) == 5:
            entry["refused"] = item[4]
        else:
            try:
                rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), np.uint8)
            except Exception as e:
                raise RuntimeError(f"PIL does not decode {name}") from e
            entry["shape"] = list(rgb.shape)
            entry["sha256_pil_rgb"] = hashlib.sha256(rgb.tobytes()).hexdigest()
        entries.append(entry)
    manifest = {
        "purpose": purpose,
        "pil": PIL.__version__,
        "source": SOURCE,
        "recipe": "python tests/_image_formats_corpus.py",
        "files": entries,
    }
    text = json.dumps(manifest, indent=1)
    if one_line_entries:  # the same JSON, an entry a line
        lines = [json.dumps(e) for e in entries]
        text = json.dumps({**manifest, "files": []}, indent=1).replace(
            '"files": []', '"files": [\n  ' + ",\n  ".join(lines) + "\n ]")
    (out / "MANIFEST.json").write_text(text + "\n")
    total = sum(p.stat().st_size for p in out.iterdir())
    print(f"{out.name}: {len(entries)} files, {total} bytes")


def main():
    write_corpus(
        OUT, fixtures(),
        "Fixtures of the formats the JAX package opens through PIL beside PNG and "
        "baseline JPEG: the port's WebP, GIF, TIFF, netpbm and RLE BMP decoders and "
        "its JPEG decoder's arithmetic, lossless and smoothing paths are held to "
        "PIL's convert('RGB') decode of each file (sha256_pil_rgb, of the uint8 HWC "
        "array's bytes); entries with 'refused' are variants the port refuses by "
        "name, as PIL refuses or misreads them.")
    write_corpus(
        TEXTURES, texture_fixtures(np.random.default_rng(2026)),
        "Fixtures of the texture and icon formats the JAX package opens through PIL: "
        "the port's DDS (uncompressed and BC1-BC7), TGA, ICO, CUR, QOI, PCX, DCX and "
        "SGI decoders are held to PIL's convert('RGB') decode of each file "
        "(sha256_pil_rgb, of the uint8 HWC array's bytes); entries with 'refused' are "
        "variants that PIL refuses too, refused by the port by name.", one_line_entries=True)
    write_corpus(
        LAYERED, psd_dib_anim_fixtures(np.random.default_rng(2026)),
        "Fixtures of animated WebP (the first frame on its canvas), PSD (the merged "
        "image) and DIB: the port's decoders are held to PIL's convert('RGB') decode "
        "of each file (sha256_pil_rgb, of the uint8 HWC array's bytes); entries with "
        "'refused' are variants that PIL refuses too, refused by the port by name.",
        one_line_entries=True)


if __name__ == "__main__":
    main()
