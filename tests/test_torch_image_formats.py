"""The port's decoders of the formats that the JAX package opens through PIL
beside PNG and JPEG (WebP, GIF, TIFF, netpbm, RLE BMP; the JPEG processes
beside baseline are in test_torch_jpeg_variants.py) against the JAX
package's readers (``read_img`` and ``_read_img_u8``, which are PIL's
``convert("RGB")``) and its daemon's decode, bit for bit: the committed
fixtures (data/corpus/image_formats/MANIFEST.json), files generated from a
numpy seed, and the refusals. Every case is exact, so no test states a
bound.

The damaged-input sweep runs the decoders in a subprocess with a capped
address space, so that a crash or a runaway allocation fails the test and
not the worker: each truncated or flipped file must be refused, or decode
equal to PIL's decode of it."""

import hashlib
import io
import json
import struct
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from _bmp_writer import rle_encode, write_bmp_rle
from _dds_writer import write_dds
from _gif_writer import write_gif
from _ico_writer import write_dcx, write_icon
from _tiff_writer import jpeg_chunks, write_tiff
from _webp_writer import write_webp
from simplesr_tpu.data.pipeline import _read_img_u8 as jax_read_img_u8
from simplesr_tpu.data.pipeline import read_img as jax_read_img
from simplesr_tpu_torch.data import DataPipeline
from simplesr_tpu_torch.data.image import decode_image, image_kind, read_img, read_rgb_u8
from simplesr_tpu_torch.data.native_loader import NativeLoader
from simplesr_tpu_torch.data.png import decode_png, encode_png
from simplesr_tpu_torch.tools import http_gateway, serve
from simplesr_tpu_torch.train import save_model
from simplesr_tpu_torch.train.generator import Generator

ROOT = Path(__file__).resolve().parents[1]
MANIFEST = json.loads((ROOT / "data/corpus/image_formats/MANIFEST.json").read_text())
DECODED = [e for e in MANIFEST["files"] if "refused" not in e]
REFUSED = [e for e in MANIFEST["files"] if "refused" in e]
GALLERY = np.asarray(Image.open(ROOT / "data/corpus/gallery/gt_16.png").convert("RGB"))


def _pil(data):
    """The JAX daemon's decode of a request body (tools/serve.py)."""
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), np.uint8)


def _digest(a):
    return hashlib.sha256(np.ascontiguousarray(a, np.uint8).tobytes()).hexdigest()


def _save(img, fmt, **save):
    buf = io.BytesIO()
    img.save(buf, fmt, **save)
    return buf.getvalue()


@pytest.mark.parametrize("entry", DECODED, ids=lambda e: Path(e["file"]).name)
def test_committed_fixtures_read_as_the_jax_readers(entry):
    path = ROOT / entry["file"]
    data = path.read_bytes()
    want = jax_read_img_u8(str(path))
    assert _digest(want) == entry["sha256_pil_rgb"] and list(want.shape) == entry["shape"]
    got = read_rgb_u8(path)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(read_img(path), jax_read_img(str(path)))
    np.testing.assert_array_equal(decode_image(data), serve.decode_image(data))


@pytest.mark.parametrize("entry", REFUSED, ids=lambda e: Path(e["file"]).name)
def test_refused_fixtures_name_what_they_are(entry):
    with pytest.raises(ValueError, match=entry["refused"]):
        read_rgb_u8(ROOT / entry["file"])


def test_the_fixtures_cover_the_matrix():
    names = [Path(e["file"]).name for e in MANIFEST["files"]]
    params = [e["params"] for e in MANIFEST["files"]]
    assert {p.get("quality") for p in params} >= {10, 50, 90}
    assert any(e["shape"][:2] == [256, 360] for e in DECODED)
    assert any("alpha_seed" in p and not p.get("lossless") for p in params)
    assert {p.get("exact") for p in params if p.get("lossless")} >= {True, False}
    assert {tuple(e["shape"][:2]) for e in DECODED if e["format"] == "webp"} >= {
        (1, 1), (7, 13), (17, 33)}
    for key in ("local_palette", "interlace", "transparency", "grey_ramp", "offset"):
        assert any(key in p for p in params), key
    tiffs = [p for e, p in zip(MANIFEST["files"], params) if e["format"] == "tiff"]
    assert {(p.get("compression"), p.get("predictor")) for p in tiffs} >= {
        (c, k) for c in ("none", "lzw", "deflate", "packbits") for k in (1, 2)}
    assert any(p.get("tile") for p in tiffs) and any(p.get("planar") for p in tiffs)
    assert any(p.get("rows_per_strip") for p in tiffs) and any(p.get("big_endian") for p in tiffs)
    assert {p.get("bits") for p in tiffs} >= {1, 16} and any("orientation" in p for p in tiffs)
    assert any(p.get("photometric") == 0 for p in tiffs)
    assert {p.get("compression") for p in tiffs if p.get("photometric") == 6} >= {
        "jpeg", "lzw", "deflate"}
    assert {tuple(p["ycbcr_subsampling"]) for p in tiffs if "ycbcr_subsampling" in p} >= {
        (1, 1), (2, 1), (2, 2), (4, 2)}
    assert any("reference_black_white" in p for p in tiffs)
    assert any(p.get("compression") == "jpeg" and p.get("tile") for p in tiffs)
    assert {p.get("mode") for p in tiffs if p.get("compression") == "jpeg"} >= {
        "RGB", "L", "CMYK", "YCbCr"}
    assert any(p.get("photometric") == 5 and p.get("bits") == 16 for p in tiffs)
    assert any(p.get("photometric") == 5 and p.get("planar") for p in tiffs)
    assert {p.get("sample_format", 1) for p in tiffs if p.get("bits") == 32} >= {1, 2, 3}
    assert any(p.get("bigtiff") and p.get("tile") for p in tiffs)
    assert sum(p.get("photometric") == 8 or p.get("mode") == "LAB" for p in tiffs) >= 2
    assert any("palette" in n for n in names)
    assert {(p["magic"], p.get("maxval")) for p in params if "magic" in p} >= {
        (m, v) for m in ("P2", "P3", "P5", "P6") for v in (255, 1000, 65535)} | {
        ("P1", None), ("P4", None)}
    assert {p.get("rle4") for p in params if "stream" in p} == {False, True}
    assert sum(p.stat().st_size for p in (ROOT / "data/corpus/image_formats").iterdir()) < 512 << 10


# ---------------------------------------------------------- generated files

def _generated(rng):
    """(name, bytes) of each format, written from seeded samples."""
    crop = GALLERY[int(rng.integers(0, 100)):, int(rng.integers(0, 100)):][:23, :37]
    idx = rng.integers(0, 200, crop.shape[:2])
    pal = rng.integers(0, 256, (256, 3))
    yield "webp lossy", _save(Image.fromarray(crop), "WEBP", quality=int(rng.integers(1, 100)))
    yield "webp lossless", _save(Image.fromarray(crop), "WEBP", lossless=True)
    yield "webp settings", write_webp(crop, 70, filter_type=int(rng.integers(0, 2)),
                                      filter_sharpness=int(rng.integers(0, 8)),
                                      partitions=int(rng.integers(0, 4)))
    yield "gif", write_gif(idx, pal, interlace=bool(rng.integers(0, 2)),
                           transparency=int(rng.integers(0, 200)))
    for comp in ("none", "lzw", "deflate", "packbits"):
        yield f"tiff {comp}", write_tiff(crop.astype(np.int64), 2, 8, comp,
                                         predictor=int(rng.integers(1, 3)),
                                         big_endian=bool(rng.integers(0, 2)),
                                         rows_per_strip=int(rng.integers(1, 24)))
    g16 = rng.integers(0, 400, crop.shape[:2])
    yield "tiff grey16 tiles", write_tiff(g16, 1, 16, "lzw", 2, tile=(16, 16))
    yield "tiff orientation", write_tiff(crop.astype(np.int64), 2, 8, "packbits",  # PIL turns it
                                         extra_tags=[(274, 3, [int(rng.integers(1, 9))])])
    ycc = np.asarray(Image.fromarray(crop).convert("YCbCr"))
    sub = [(1, 1), (2, 1), (2, 2), (4, 2), (4, 4), (1, 2), (4, 1)][int(rng.integers(0, 7))]
    yield "tiff ycbcr", write_tiff(ycc, 6, 8,
                                   ["lzw", "deflate", "packbits"][int(rng.integers(0, 3))],
                                   ycbcr_subsampling=sub,
                                   rows_per_strip=sub[1] * int(rng.integers(1, 6)))
    sampling = [(sub[0] % 3, sub[1] % 3), (1, 1), (1, 1)]
    tile = (16 * int(rng.integers(1, 3)), 16 * int(rng.integers(1, 3))) \
        if rng.random() < 0.5 else None
    chunks, tables = jpeg_chunks(ycc, sampling, tile=tile, rows_per_strip=16,
                                 quality_step=int(rng.integers(1, 20)))
    yield "tiff jpeg", write_tiff(ycc, 6, 8, 7, tile=tile, rows_per_strip=16, chunks=chunks,
                                  ycbcr_subsampling=sampling[0], extra_tags=[(347, 7, tables)])
    k = (255 - crop.max(axis=2)).astype(np.int64)
    cmyk = np.dstack([255 - crop.astype(np.int64) - k[:, :, None], k]).clip(0, 255)
    yield "tiff cmyk", write_tiff(cmyk, 5, 8, ["none", "lzw", "packbits"][int(rng.integers(0, 3))],
                                  big_endian=bool(rng.integers(0, 2)),
                                  planar=bool(rng.integers(0, 2)))
    floats = np.float32(crop[:, :, 0] * rng.random() * 2 - rng.integers(0, 100))
    yield "tiff float", write_tiff(floats.view(np.uint32).astype(np.int64), 1, 32,
                                   ["none", "deflate"][int(rng.integers(0, 2))], sample_format=3)
    yield "tiff int32", write_tiff((crop[:, :, 2].astype(np.int64) * 2 - 100) & 0xFFFFFFFF, 1, 32,
                                   "lzw", int(rng.integers(1, 3)), sample_format=2)
    yield "tiff cielab", write_tiff(rng.integers(0, 256, crop.shape), 8, 8,
                                    ["none", "lzw", "packbits"][int(rng.integers(0, 3))],
                                    rows_per_strip=int(rng.integers(1, 24)))
    yield "bigtiff", write_tiff(crop.astype(np.int64), 2, 8, "deflate", bigtiff=True,
                                rows_per_strip=int(rng.integers(1, 24)))
    yield "ppm", b"P6 37 23 255\n" + crop.tobytes()
    yield "pgm 16-bit", b"P5 37 23 4095\n" + (crop[:, :, 0].astype(">u2") * 16).tobytes()
    yield "bmp rle8", write_bmp_rle(37, 23, pal, rle_encode(idx))
    yield "bmp rle4", write_bmp_rle(37, 23, pal[:16], rle_encode(idx % 16, rle4=True), rle4=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generated_files_read_as_the_jax_readers(seed, tmp_path):
    for k, (name, data) in enumerate(_generated(np.random.default_rng(seed))):
        path = tmp_path / f"f{k}"
        path.write_bytes(data)
        want = jax_read_img_u8(str(path))
        np.testing.assert_array_equal(read_rgb_u8(path), want, err_msg=name)
        np.testing.assert_array_equal(read_img(path), jax_read_img(str(path)), err_msg=name)
        np.testing.assert_array_equal(serve.decode_image(data), _pil(data), err_msg=name)


def test_the_native_loader_reads_webp_gif_and_tiff_files():
    loader = NativeLoader(2)
    entries = [e for e in DECODED if e["format"] in ("webp", "gif", "tiff")]
    assert len(entries) > 30
    for e in entries:
        path = str(ROOT / e["file"])
        assert loader.image_size(path) == tuple(e["shape"][:2])
        assert _digest(loader.load_image_u8(path)) == e["sha256_pil_rgb"]


def test_kinds_by_magic_bytes():
    cases = {b"RIFF\0\0\0\0WEBPVP8 ": "webp", b"GIF87a": "gif", b"GIF89a": "gif",
             b"II*\0": "tiff", b"MM\0*": "tiff", b"II+\0": "tiff", b"P6 1 1": "pnm",
             b"P1\n": "pnm", b"BM": "bmp", b"RIFF\0\0\0\0WAVE": None, b"PK\3\4": None}
    for head, kind in cases.items():
        assert image_kind(head) == kind, head


# -------------------------------------------------------------- refusals

def _tiff_with(**tags):
    """An 8 x 4 grey TIFF, then each tag=value patched into its entry."""
    data = bytearray(write_tiff(np.zeros((4, 8), np.int64), 1, 8))
    ifd = struct.unpack("<I", data[4:8])[0]
    numbers = {"compression": 259, "photometric": 262, "fill_order": 266}
    for key, value in tags.items():
        tag = numbers[key]
        for i in range(struct.unpack("<H", data[ifd:ifd + 2])[0]):
            e = ifd + 2 + 12 * i
            if struct.unpack("<H", data[e:e + 2])[0] == tag:
                data[e + 8:e + 10] = struct.pack("<H", value)
                break
        else:
            entry = struct.pack("<HHIHH", tag, 3, 1, value, 0)
            n = struct.unpack("<H", data[ifd:ifd + 2])[0]
            data[ifd:ifd + 2] = struct.pack("<H", n + 1)
            data[ifd + 2 + 12 * n:ifd + 2 + 12 * n] = entry
    return bytes(data)


def _bmp_compressed(kind):
    head = struct.pack("<IiiHHIIiiII", 40, 4, 2, 1, 24, kind, 8, 0, 0, 0, 0)
    return b"BM" + struct.pack("<IHHI", 62, 0, 0, 54) + head + bytes(8)


REFUSALS = {
    "old-style JPEG": lambda: _tiff_with(compression=6),
    "CCITT": lambda: _tiff_with(compression=4),
    "16-bit CIELab": lambda: write_tiff(np.zeros((2, 3, 3), np.int64), 8, 16),
    "big-endian BigTIFF": lambda: write_tiff(np.zeros((2, 3), np.int64), 1, 8, bigtiff=True,
                                            big_endian=True),
    "uncompressed YCbCr": lambda: write_tiff(np.zeros((2, 4, 3), np.int64), 6, 8,
                                             ycbcr_subsampling=(2, 2)),
    "fill order 2": lambda: _tiff_with(fill_order=2),
    "BMP JPEG compression": lambda: _bmp_compressed(4),
    "BMP PNG compression": lambda: _bmp_compressed(5),
    "BMP ALPHABITFIELDS compression": lambda: _bmp_compressed(6),
    "netpbm Pf": lambda: b"Pf\n1 1\n-1.0\n" + bytes(4),
}


@pytest.mark.parametrize("what", REFUSALS)
def test_refusals_name_the_variant_and_the_roadmap(what):
    data = REFUSALS[what]()
    with pytest.raises(ValueError, match=f"{what}.*ROADMAP.md, Queue 1, item 3"):
        decode_image(data)
    if what.startswith("BMP"):  # PIL 12.1 refuses these compressions too
        with pytest.raises(OSError, match="Unsupported BMP compression"):
            _pil(data)


def _jpeg_tiff():
    ycc = np.asarray(Image.fromarray(GALLERY[:20, :30]).convert("YCbCr"))
    chunks, tables = jpeg_chunks(ycc, [(2, 2), (1, 1), (1, 1)], rows_per_strip=16)
    return write_tiff(ycc, 6, 8, 7, rows_per_strip=16, chunks=chunks, ycbcr_subsampling=(2, 2),
                      extra_tags=[(347, 7, tables)])


# variants the port refused before it had their decoders
FORMERLY_REFUSED = {
    "JPEG-in-TIFF": _jpeg_tiff,
    "floating-point": lambda: write_tiff(np.full((2, 3), 0x42C80000, np.int64), 1, 32,
                                         sample_format=3),
    "BigTIFF": lambda: write_tiff(GALLERY[:5, :7].astype(np.int64), 2, 8, "lzw", bigtiff=True),
    "CMYK": lambda: write_tiff(np.dstack([GALLERY[:4, :8], GALLERY[:4, :8, :1]]), 5, 8),
    "CIELab": lambda: write_tiff(GALLERY[:4, :8].astype(np.int64), 8, 8),
    "animated WebP": lambda: _save(Image.fromarray(GALLERY[:8, :8]), "WEBP", save_all=True,
                                   append_images=[Image.fromarray(GALLERY[8:16, :8])],
                                   quality=50),
}


@pytest.mark.parametrize("what", FORMERLY_REFUSED)
def test_formerly_refused_variants_decode_as_pil(what):
    data = FORMERLY_REFUSED[what]()
    np.testing.assert_array_equal(decode_image(data), _pil(data))


def test_cielab_sweep_decodes_as_pils_littlecms_transform():
    """A million 8-bit Lab values (every L, a and b bytes in steps of 4 from
    a seeded start) through Pillow's LittleCMS transform and the port's
    table of it: equal everywhere."""
    start = np.random.default_rng(7).integers(0, 4, 2)
    lab = np.stack(np.meshgrid(np.arange(256), np.arange(start[0], 256, 4),
                               np.arange(start[1], 256, 4), indexing="ij"), -1)
    data = write_tiff(lab.reshape(1024, 1024, 3), 8, 8, "deflate", rows_per_strip=128)
    np.testing.assert_array_equal(decode_image(data), _pil(data))


def _dib_header(width, height):
    return struct.pack("<IiiHHIIiiII", 40, width, height, 1, 24, 0, 0, 0, 0, 0, 0)


@pytest.mark.parametrize("fmt", ["webp", "gif", "tiff", "pnm", "dds", "tga", "qoi", "pcx", "dcx",
                                 "sgi", "ico", "cur"])
def test_bombs_are_refused_before_decoding(fmt):
    """Headers past twice PIL's MAX_IMAGE_PIXELS, as PIL refuses them."""
    if fmt == "webp":  # a 16384 x 16384 lossless header
        bits = 0x2f | ((16383 | (16383 << 14)) << 8)
        payload = bits.to_bytes(5, "little") + b"\0"
        body = b"WEBP" + b"VP8L" + struct.pack("<I", len(payload)) + payload
        data = b"RIFF" + struct.pack("<I", len(body)) + body
    elif fmt == "gif":
        data = write_gif(np.zeros((2, 2), np.uint8), [[0, 0, 0]], screen=(60000, 60000))
    elif fmt == "tiff":
        data = bytearray(write_tiff(np.zeros((2, 2), np.int64), 1, 8))
        for tag in (256, 257):  # width and length
            data = bytes(data).replace(struct.pack("<HHII", tag, 4, 1, 2),
                                       struct.pack("<HHII", tag, 4, 1, 60000))
    elif fmt == "pnm":
        data = b"P6 60000 60000 255\n" + bytes(16)
    elif fmt == "dds":
        data = write_dds(60000, 60000, bytes(64), fourcc="DXT1")
    elif fmt == "tga":  # 65535 x 65535, the largest a TGA header holds
        data = struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, 65535, 65535, 24, 0) + \
            bytes(64)
    elif fmt == "qoi":
        data = b"qoif" + struct.pack(">II", 60000, 60000) + b"\3\0" + bytes(64)
    elif fmt in ("pcx", "dcx"):
        data = b"\x0a\x05\x01\x08" + struct.pack("<6H", 0, 0, 59999, 59999, 72, 72) + \
            bytes(49) + b"\x01" + struct.pack("<HH", 60000, 1) + bytes(958)
        if fmt == "dcx":
            data = write_dcx([data])
    elif fmt == "sgi":
        data = struct.pack(">HBBHHHH", 474, 0, 1, 3, 60000, 60000, 3) + bytes(600)
    else:  # an icon's or a cursor's DIB, its height doubled
        data = write_icon([(0, 0, 24, 0, _dib_header(60000, 120000) + bytes(64))],
                          kind=1 if fmt == "ico" else 2)
    with pytest.raises(ValueError, match="exceeds the limit"):
        decode_image(data)


# ---------------------------------------------------------------- gateway

def test_gateway_answers_a_webp_body_as_the_png_of_its_pixels(tmp_path):
    gen = Generator.srresnet(2, num_blocks=1, num_filters=8, batch_norm=False,
                             dtype="float32", seed=3, device="cpu")
    model = str(tmp_path / "tiny.msgpack")
    save_model(gen.module_config(), gen.variables, model)
    img = GALLERY[20:36, 30:50]
    webp = _save(Image.fromarray(img), "WEBP", lossless=True)
    np.testing.assert_array_equal(decode_image(webp), img)
    ready, stop, box = threading.Event(), threading.Event(), {}
    thread = threading.Thread(target=http_gateway.serve_http, args=(model, 2, 0), daemon=True,
                              kwargs=dict(ready_event=ready, stop_event=stop, device="cpu",
                                          on_server=lambda s: box.update(s=s)))
    thread.start()
    assert ready.wait(60)
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    url = f"http://127.0.0.1:{box['s'].server_address[1]}/upscale"
    try:
        replies = []
        for body in (webp, encode_png(img)):
            with opener.open(urllib.request.Request(url, data=body), timeout=60) as r:
                assert r.status == 200 and r.headers.get("Content-Type") == "image/png"
                replies.append(decode_png(r.read()))
        assert replies[0].shape == (32, 40, 3)
        np.testing.assert_array_equal(replies[0], replies[1])
    finally:
        stop.set()
        thread.join(timeout=30)


def test_a_training_folder_reads_every_format_as_the_jax_pipeline(tmp_path):
    """Both pipelines list every file of a folder (the JAX package's
    _IMG_EXTENSIONS filters nothing); the port's C++ loader reads the PNG,
    WebP, GIF and TIFF files, numpy the BMP and netpbm ones."""
    rng = np.random.default_rng(5)
    img = GALLERY[:40, :48]
    Image.fromarray(img).save(tmp_path / "a.png")
    (tmp_path / "b.bmp").write_bytes(write_bmp_rle(48, 40, rng.integers(0, 256, (256, 3)),
                                                   rle_encode(rng.integers(0, 4, (40, 48)))))
    (tmp_path / "c.webp").write_bytes(_save(Image.fromarray(img), "WEBP", quality=60))
    (tmp_path / "d.gif").write_bytes(_save(Image.fromarray(img), "GIF"))
    (tmp_path / "e.tif").write_bytes(_save(Image.fromarray(img), "TIFF", compression="tiff_lzw"))
    (tmp_path / "f.ppm").write_bytes(b"P6 48 40 255\n" + img.tobytes())
    pipe = DataPipeline(hr_img_path=str(tmp_path), scale=2, train_val_split=0.2, batch_size=2,
                        crop_size=(16, 16, 3), num_crops=1, random_seed=1, device="cpu")
    listed = sorted(pipe.train_imgs + pipe.val_imgs)
    assert [Path(p).name for p in listed] == ["a.png", "b.bmp", "c.webp", "d.gif", "e.tif",
                                              "f.ppm"]
    for path in listed:
        np.testing.assert_array_equal(pipe._decoded(path), jax_read_img_u8(path), err_msg=path)
        assert pipe._image_hw(path) == (40, 48)


# ------------------------------------------------------------------ damage

SWEEP = """
import hashlib, io, json, resource, sys
resource.setrlimit(resource.RLIMIT_AS, (4 << 30, 4 << 30))  # a runaway decode fails here
import numpy as np
from PIL import Image
from simplesr_tpu_torch.data.image import decode_image

def digest(img):
    return hashlib.sha256(np.ascontiguousarray(img, np.uint8).tobytes()).hexdigest()

out = []
for path in sys.argv[1:]:
    data = open(path, "rb").read()
    try:
        port = digest(decode_image(data))
    except ValueError:
        out.append([None, None])
        continue
    try:  # PIL's decode, where the port decodes: the JAX daemon's
        out.append([port, digest(np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))])
    except Exception as e:  # PIL's refusals take many types
        out.append([port, repr(e)])
print(json.dumps(out))
"""

SWEEP_SOURCES = ["webp_lossy_q50_17x33.webp", "webp_lossy_alpha_17x33.webp",
                 "webp_lossless_alpha_17x33.webp", "gif_interlaced_17x33.gif",
                 "gif_offset_frame_17x33_on_24x40.gif", "tiff_rgb_lzw_p2.tif",
                 "tiff_rgb_deflate_tiles.tif", "tiff_bilevel_packbits.tif",
                 "tiff_rgb_none_planar.tif", "ppm_p6_max1000.ppm", "ppm_p3_max255.ppm",
                 "pbm_p4.pbm", "bmp_rle8_17x33.bmp", "bmp_rle4_17x33.bmp",
                 # the JPEG processes and TIFF variants of the slice after
                 "jpeg_arith_seq_422_restart_dac_37x45.jpg",
                 "jpeg_arith_prog_420_restart_48x64.jpg",
                 "jpeg_lossless_420_adobe_rgb_37x45.jpg", "jpeg_lossless_p4_24x32.jpg",
                 "jpeg_smooth_unrefined_48x64.jpg", "tiff_jpeg_compression.tif",
                 "tiff_ycbcr22_lzw_37x45.tif", "tiff_cmyk16_deflate_p2_37x45.tif",
                 "tiff_float32.tif", "tiff_bigtiff_lzw_37x45.tif"]
# the texture and icon formats (data/corpus/texture_formats)
TEXTURE_SWEEP_SOURCES = ["dds_bc7_mode6_17x33.dds", "dds_bc6h_sf16_modes_36x32.dds",
                         "dds_odd_masks_13x17.dds", "dds_palette8_13x17.dds",
                         "tga_rle_pil_17x33.tga", "tga_type1_map_start_bottom_right_13x17.tga",
                         "ico_dib_depths_24x24.ico", "ico_png_pil_17x33.ico",
                         "cur_three_cursors_24x20.cur", "qoi_rgba_pil_17x33.qoi",
                         "pcx_rgb_pil_13x17.pcx", "pcx_planar4_13x17.pcx",
                         "dcx_two_pages_13x17.dcx", "sgi_rgba_rle_16bit_13x17.sgi",
                         "sgi_rgb_pil_13x17.sgi"]


def _variants(data, rng, truncations=8, flips=24):
    out = [data[:int(rng.integers(1, len(data)))] for _ in range(truncations)]
    for _ in range(flips):
        d = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            i = int(rng.integers(0, len(d)))
            flip = d[i] ^ (1 << int(rng.integers(0, 8)))
            d[i] = int(rng.integers(0, 256)) if rng.random() < 0.5 else flip
        out.append(bytes(d))
    return out


def test_damaged_inputs_are_refused_or_decode_as_pil(tmp_path):
    rng = np.random.default_rng(2026)
    cases = []
    sources = [("image_formats", n) for n in SWEEP_SOURCES] + \
        [("texture_formats", n) for n in TEXTURE_SWEEP_SOURCES]
    for corpus, name in sources:
        data = (ROOT / "data/corpus" / corpus / name).read_bytes()
        for k, variant in enumerate(_variants(data, rng)):
            path = tmp_path / f"{name}_{k}"
            path.write_bytes(variant)
            cases.append((name.split("_")[0], path))
    proc = subprocess.run([sys.executable, "-c", SWEEP, *(str(p) for _, p in cases)],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    tally = {}
    for (fmt, path), (got, pil) in zip(cases, json.loads(proc.stdout)):
        if got is None:
            kind = "refused"
        else:
            assert got == pil, f"{path.name}: the port decodes it, PIL gives {pil}"
            kind = "as PIL"
        tally[fmt, kind] = tally.get((fmt, kind), 0) + 1
    # the sweep reached both outcomes for every format
    for fmt in ("webp", "gif", "tiff", "ppm", "bmp", "jpeg", "dds", "tga", "ico", "cur", "qoi",
                "pcx", "dcx", "sgi"):
        assert tally.get((fmt, "refused")) and tally.get((fmt, "as PIL")), (fmt, tally)
