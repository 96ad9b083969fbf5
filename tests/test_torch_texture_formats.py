"""The port's decoders of the texture and icon formats that the JAX package
opens through PIL (DDS with its BC1-BC7 blocks, TGA, ICO, CUR, QOI, PCX,
DCX, SGI) against the JAX package's readers (``read_img`` and
``_read_img_u8``, PIL's ``convert("RGB")``) and its daemon's decode, bit for
bit: the committed fixtures (data/corpus/texture_formats/MANIFEST.json),
files generated from a numpy seed (seeded random BCn blocks in every BC6H
and BC7 mode among them), the refusals, and the dispatch: the kind the port
reads a file as is the format PIL's ``Image.open`` opens it as, TGA (which
has no magic) after every other kind. Every case is exact, so no test
states a bound. The damaged-input sweep and the bomb test of
test_torch_image_formats.py cover these kinds too."""

import hashlib
import io
import json
import struct
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from _dds_writer import (DDPF_ALPHAPIXELS, DDPF_LUMINANCE, DDPF_PALETTE8, DDPF_RGB,
                         block_count, random_blocks, write_dds)
from _ico_writer import dib, pcx_planar, write_dcx, write_icon
from _sgi_writer import write_sgi
from _tga_writer import write_tga
from simplesr_tpu.data.pipeline import _read_img_u8 as jax_read_img_u8
from simplesr_tpu.data.pipeline import read_img as jax_read_img
from simplesr_tpu_torch.data.image import decode_image, file_kind, image_kind, read_img, read_rgb_u8
from simplesr_tpu_torch.data.native_loader import NativeLoader
from simplesr_tpu_torch.data.png import decode_png, encode_png
from simplesr_tpu_torch.tools import http_gateway, serve
from simplesr_tpu_torch.train import save_model
from simplesr_tpu_torch.train.generator import Generator

ROOT = Path(__file__).resolve().parents[1]
CORPUS = ROOT / "data/corpus/texture_formats"
MANIFEST = json.loads((CORPUS / "MANIFEST.json").read_text())
DECODED = [e for e in MANIFEST["files"] if "refused" not in e]
REFUSED = [e for e in MANIFEST["files"] if "refused" in e]
GALLERY = np.asarray(Image.open(ROOT / "data/corpus/gallery/gt_16.png").convert("RGB"))
NEW_KINDS = ("dds", "tga", "ico", "cur", "qoi", "pcx", "dcx", "sgi")
# PIL's format names where they are not the port's kinds
PIL_FORMATS = {"PPM": "pnm"}


def _pil(data):
    """The JAX daemon's decode of a request body (tools/serve.py)."""
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), np.uint8)


def _pil_kind(data):
    """The format PIL opens ``data`` as, as the port names it, or None."""
    try:
        fmt = Image.open(io.BytesIO(data)).format
    except Exception:  # PIL's refusals take many types
        return None
    return PIL_FORMATS.get(fmt, fmt.lower())


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
    np.testing.assert_array_equal(read_rgb_u8(path), want)
    np.testing.assert_array_equal(read_img(path), jax_read_img(str(path)))
    np.testing.assert_array_equal(serve.decode_image(data), _pil(data))
    assert file_kind(path) == image_kind(data) == entry["format"] == _pil_kind(data)


@pytest.mark.parametrize("entry", REFUSED, ids=lambda e: Path(e["file"]).name)
def test_refused_fixtures_are_refused_by_pil_too(entry):
    data = (ROOT / entry["file"]).read_bytes()
    with pytest.raises(ValueError, match=entry["refused"]):
        decode_image(data)
    with pytest.raises(Exception):  # PIL's refusals take many types
        _pil(data)


def test_the_fixtures_cover_the_formats_and_stay_small():
    formats = {e["format"] for e in DECODED}
    assert formats == set(NEW_KINDS)
    timing = {e["format"] for e in DECODED if e["params"].get("timing")}
    assert timing == set(NEW_KINDS)
    assert all(e["shape"] == [96, 128, 3] for e in DECODED if e["params"].get("timing"))
    names = [Path(e["file"]).name for e in DECODED]
    for key in ("dxt1", "dxt3", "dxt5", "ati1", "bc4u", "bc4_dx10", "ati2", "bc5s",
                "bc5_snorm", "bc6h_uf16", "bc6h_sf16", "bc7", "r8g8b8a8", "palette8", "r5g6b5"):
        assert any(key in n for n in names), key
    assert sum(p.stat().st_size for p in CORPUS.iterdir()) < 300_000


# ---------------------------------------------------------- generated files

def _dds_cases(rng):
    """(name, bytes) of every FourCC and DXGI format the port reads, and
    each uncompressed layout, over seeded samples."""
    w, h = int(rng.integers(1, 23)), int(rng.integers(1, 23))
    n = block_count(w, h)
    for fourcc, size in (("DXT1", 8), ("DXT3", 16), ("DXT5", 16), ("BC4U", 8), ("ATI1", 8),
                         ("BC5U", 16), ("ATI2", 16), ("BC5S", 16)):
        yield f"dds {fourcc}", write_dds(w, h, random_blocks(rng, n, size), fourcc=fourcc)
    for fmt in ("BC1", "BC2", "BC3", "BC4", "BC5", "BC5_SNORM", "BC6H_UF16", "BC6H_SF16", "BC7",
                "BC7_SRGB", 70, 73, 76, 79, 82, 97):
        size = 8 if fmt in ("BC1", "BC4", 70, 79) else 16
        yield f"dds {fmt}", write_dds(w, h, random_blocks(rng, n, size), dxgi=fmt)
    for fmt in ("R8G8B8A8", 27, "R8G8B8A8_SRGB"):
        yield f"dds {fmt}", write_dds(w, h, rng.integers(0, 256, 4 * w * h, dtype=np.uint8)
                                      .tobytes(), dxgi=fmt)
    bits = int(rng.choice([8, 16, 24, 32]))
    masks = tuple(int(m) for m in rng.integers(0, 1 << bits, 4))
    short = int(rng.integers(0, 4))  # the RGB decoder reads zeros past the end
    yield "dds masks", write_dds(w, h, rng.integers(0, 256, w * h * bits // 8 - short,
                                                    dtype=np.uint8).tobytes(),
                                 pfflags=DDPF_RGB | int(rng.integers(0, 2)), bitcount=bits,
                                 masks=masks)
    yield "dds L", write_dds(w, h, rng.integers(0, 256, w * h, dtype=np.uint8).tobytes(),
                             pfflags=DDPF_LUMINANCE, bitcount=8)
    yield "dds LA", write_dds(w, h, rng.integers(0, 256, 2 * w * h, dtype=np.uint8).tobytes(),
                              pfflags=DDPF_LUMINANCE | DDPF_ALPHAPIXELS, bitcount=16)
    yield "dds P", write_dds(w, h, rng.integers(0, 256, w * h, dtype=np.uint8).tobytes(),
                             pfflags=DDPF_PALETTE8, bitcount=8,
                             palette=rng.integers(0, 256, 1024, dtype=np.uint8))


def _tga_cases(rng):
    h, w = int(rng.integers(1, 20)), int(rng.integers(1, 20))
    origin = ["bottom_left", "top_left", "bottom_right", "top_right"][int(rng.integers(0, 4))]
    image_id = b"id"[:int(rng.integers(0, 3))]
    for image_type, depth in ((2, 16), (2, 24), (2, 32), (10, 16), (10, 24), (10, 32), (3, 1),
                              (3, 8), (3, 16), (11, 8), (11, 16)):
        if depth == 16 and image_type & 7 == 2:
            px = rng.integers(0, 65536, (h, w))
        elif depth == 1:
            px = rng.integers(0, 2, (h, w))
        else:
            px = rng.integers(0, 256, (h, w, depth // 8) if depth > 8 else (h, w))
        px[:, :w // 2] = px[:, :1]  # runs for the RLE packets
        yield f"tga {image_type} {depth}", write_tga(px, image_type, depth, origin,
                                                     image_id=image_id, rle_rng=rng)
    for image_type, map_depth in ((1, 24), (9, 24), (1, 16), (9, 16), (3, 24), (11, 16)):
        entries, start = int(rng.integers(1, 60)), int(rng.integers(0, 40))
        cmap = rng.integers(0, 65536, entries) if map_depth == 16 else \
            rng.integers(0, 256, (entries, 3))
        px = rng.integers(0, entries + start + 4, (h, w))  # some past the map
        yield f"tga map {image_type} {map_depth}", write_tga(
            px, image_type, 8, origin, cmap, start, map_depth, rle_rng=rng)
    rows = rng.integers(0, 256, h * w * 3, dtype=np.uint8).tobytes()
    cut = int(rng.integers(1, 128))  # raw packets that run on into the next rows
    packets = b"".join(bytes([len(rows[i:i + 3 * cut]) // 3 - 1]) + rows[i:i + 3 * cut]
                       for i in range(0, len(rows), 3 * cut))
    yield "tga raw packets across rows", write_tga(np.zeros((h, w, 3), np.uint8), 10, 24,
                                                   origin, rows_raw=packets)


def _icon_cases(rng):
    pal = rng.integers(0, 256, (256, 3))
    frames = []
    for _ in range(int(rng.integers(1, 5))):
        size, bits = int(rng.choice([8, 16, 24, 32])), int(rng.choice([1, 4, 8, 24, 32]))
        px = rng.integers(0, 1 << min(bits, 8), (size, size)) if bits <= 8 else \
            rng.integers(0, 256, (size, size, bits // 8))
        frames.append((size, size, bits, 0, dib(px, bits, pal[:1 << bits] if bits <= 8 else None)))
    img = Image.fromarray(GALLERY[:40, :40])
    yield "ico dib", write_icon(frames)
    yield "ico png", _save(img, "ICO", sizes=[(16, 16), (int(rng.integers(17, 41)),) * 2])
    yield "ico png and dib", write_icon(frames + [(24, 24, 32, 0, _save(img.resize((24, 24)),
                                                                         "PNG"))])
    yield "cur", write_icon(frames, kind=2)


def _other_cases(rng):
    h, w = int(rng.integers(1, 30)), int(rng.integers(1, 30))
    crop = GALLERY[:h, :w]
    alpha = np.dstack([crop, rng.integers(0, 256, (h, w))]).astype(np.uint8)
    yield "qoi rgb", _save(Image.fromarray(crop), "QOI")
    yield "qoi rgba", _save(Image.fromarray(alpha), "QOI")
    for mode in ("1", "L", "RGB"):
        yield f"pcx {mode}", _save(Image.fromarray(crop).convert(mode), "PCX")
    yield "pcx P", _save(Image.fromarray(crop).quantize(int(rng.integers(2, 200))), "PCX")
    for planes in (2, 4):
        yield f"pcx planes {planes}", pcx_planar(
            rng.integers(0, 1 << planes, (h, w)), planes, rng.integers(0, 256, (16, 3)),
            header_stride=int(rng.integers(1, 9)))
    yield "dcx", write_dcx([_save(Image.fromarray(crop).quantize(16), "PCX"),
                            _save(Image.fromarray(crop), "PCX")])
    for z, bpc, rle in ((1, 1, True), (3, 1, True), (4, 2, True), (3, 2, False), (1, 2, True)):
        samples = rng.integers(0, 256 ** bpc, (h, w, z) if z > 1 else (h, w))
        samples[:, :w // 2] = samples[:, :1]
        yield f"sgi {z} {bpc} {rle}", write_sgi(samples, bpc, rle,
                                                dimension=int(rng.integers(1, 3)) if z == 1
                                                else 3)


@pytest.mark.parametrize("group", ["dds", "tga", "icons", "others"])
@pytest.mark.parametrize("seed", [0, 1])
def test_generated_files_read_as_the_jax_readers(group, seed, tmp_path):
    rng = np.random.default_rng([seed, len(group)])
    cases = {"dds": _dds_cases, "tga": _tga_cases, "icons": _icon_cases,
             "others": _other_cases}[group](rng)
    for k, (name, data) in enumerate(cases):
        path = tmp_path / f"f{k}"
        path.write_bytes(data)
        want = jax_read_img_u8(str(path))
        np.testing.assert_array_equal(read_rgb_u8(path), want, err_msg=name)
        np.testing.assert_array_equal(serve.decode_image(data), _pil(data), err_msg=name)
        assert image_kind(data) == _pil_kind(data), name


@pytest.mark.parametrize("fmt", ["BC6H_UF16", "BC6H_SF16", "BC7"])
def test_random_bc6h_and_bc7_blocks_in_every_mode_decode_as_pil(fmt):
    """256 seeded blocks, the modes in turn: BC7's eight and its empty
    block, BC6H's fourteen and its four reserved codes."""
    rng = np.random.default_rng(7)
    if fmt == "BC7":
        modes = list(range(8)) + [None]
    else:
        modes = [("bc6", b) for b in (0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 3, 7, 11, 15, 19, 23,
                                      27, 31)]
    per_mode = [random_blocks(rng, 256, 16, m) for m in modes]
    blocks = b"".join(per_mode[i % len(modes)][16 * i:16 * (i + 1)] for i in range(256))
    if fmt == "BC7":  # the mode-less blocks: a zero first byte
        blocks = bytearray(blocks)
        for i in range(8, 256, 9):
            blocks[16 * i] = 0
    data = write_dds(64, 64, bytes(blocks), dxgi=fmt)
    np.testing.assert_array_equal(decode_image(data), _pil(data))


def test_the_bc_corner_cases_decode_as_pil():
    """BC1's three-colour blocks with black, BC6H's half floats past 1 and
    below 0, BC5's zero blue and BC5S's 128, with the signed endpoints that
    make them."""
    rng = np.random.default_rng(3)
    three = np.frombuffer(random_blocks(rng, 16, 8), np.uint8).reshape(16, 8).copy()
    three[:, 0:2], three[:, 2:4] = 0, 0xFF  # colour 0 < colour 1
    three[:, 4:] = 0xFF  # every pixel index 3: black
    cases = [write_dds(16, 16, three.tobytes(), fourcc="DXT1")]
    for fmt in ("BC5U", "BC5S"):
        ends = np.array([[0x7F, 0x80], [0x80, 0x7F], [0, 0xFF], [0xFF, 0]], np.uint8)
        blocks = np.zeros((16, 16), np.uint8)
        blocks[:, 0:2] = ends[np.arange(16) % 4]
        blocks[:, 8:10] = ends[(np.arange(16) + 1) % 4]
        blocks[:, 2:8] = blocks[:, 10:16] = rng.integers(0, 256, (16, 6))
        cases.append(write_dds(16, 16, blocks.tobytes(), fourcc=fmt))
    for case in cases:
        np.testing.assert_array_equal(decode_image(case), _pil(case))
    assert (decode_image(cases[0]) == 0).all()
    assert (decode_image(cases[1])[:, :, 2] == 0).all()
    assert (decode_image(cases[2])[:, :, 2] == 128).all()


# ---------------------------------------------------------------- dispatch

def _tga_header_after(prefix, depth=8):
    """``prefix`` followed by a TGA header's remaining bytes and pixels: a
    1x1 image whose header PIL's TGA plugin takes (its type is byte 2 of
    ``prefix``)."""
    head = struct.pack("<BBBHHBHHHHBB", 0, 0, 3, 0, 0, 0, 0, 0, 1, 1, depth, 0)
    return prefix + head[len(prefix):] + b"\x07" * 64


CRAFTED = {
    # an icon of no entries: PIL's ICO and CUR plugins pass it on, its TGA takes it
    "ico without entries": _tga_header_after(b"\0\0\1\0\0\0"),
    "cur without entries": _tga_header_after(b"\0\0\2\0\0\0", depth=24),
    # an icon whose directory is cut short
    "ico cut short": b"\0\0\1\0\5\0" + bytes(10),
    # a DIB frame with an empty size: PIL passes the icon on
    "ico empty frame": write_icon([(4, 4, 8, 0, dib(np.zeros((4, 4), np.uint8), 8,
                                                    np.zeros((256, 3)))[:4] + bytes(60))]),
    "ico png frame with a broken CRC": write_icon([(8, 8, 32, 0, bytes(bytearray(
        encode_png(GALLERY[:8, :8]))[:29]) + b"\0\0\0\0" + encode_png(GALLERY[:8, :8])[33:])]),
    "pcx empty box": b"\x0a\x05\x01\x08" + struct.pack("<4H", 5, 0, 4, 9) + bytes(120),
    "pcx short": b"\x0a\x05\x01\x08" + bytes(40),
    "pcx unknown layout": b"\x0a\x05\x01\x04" + struct.pack("<4H", 0, 0, 3, 3) + bytes(200),
    "dcx empty directory": b"\xb1\x68\xde\x3a" + bytes(8),
    "dcx cut short": b"\xb1\x68\xde\x3a\x0c\0\0\0",
    "dds short": b"DDS \x7c\0",
    "dds header size": b"DDS " + bytes(200),
    "dds dx10 cut short": write_dds(4, 4, dxgi="BC1")[:130],
    "dds empty": write_dds(0, 4, bytes(8), fourcc="DXT1"),
    "qoi short": b"qoif\0\0\0\1\0\0\0\1",
    "qoi empty": b"qoif\0\0\0\0\0\0\0\1\3\0" + bytes(8),
    "sgi short": b"\x01\xda\0\1\0\1\0\1",
    "sgi layout": b"\x01\xda\0\1\0\3\0\1\0\1\0\2" + bytes(600),
    "tga type 0": struct.pack("<BBBHHBHHHHBB", 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 8, 0) + bytes(4),
    "tga map depth 15": struct.pack("<BBBHHBHHHHBB", 0, 1, 1, 0, 1, 15, 0, 0, 1, 1, 8, 0)
    + bytes(8),
    "tga short": struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, 1, 1, 24, 0)[:17],
    "mpeg": b"\0\0\1\xb3\x01\x00\x10" + bytes(200),
    # MPEG's magic with an empty size: PIL passes it on to TGA
    "mpeg empty": _tga_header_after(b"\0\0\1\xb3\0\0\0"),
    # a QOI one pixel wide whose first ops read as a GIMP brush's header
    "qoi read as gbr": b"qoif" + struct.pack(">II", 1, 4) + b"\0\0\0\2\0\0\0\1" + bytes(40),
    "spider": struct.pack(">27f", *([1.0, 1.0, 0.0, 0.0, 1.0] + [0.0] * 6 + [1.0, 1.0]
                                    + [0.0] * 8 + [4.0, 4.0] + [0.0] * 4)) + bytes(64),
}


@pytest.mark.parametrize("what", CRAFTED)
def test_crafted_headers_dispatch_as_pil(what):
    data = CRAFTED[what]
    want = _pil_kind(data)
    if want is not None:
        assert image_kind(data) == want
    try:
        got = decode_image(data)
    except ValueError:
        return  # refused: PIL opens it or not, the port names what it refuses
    np.testing.assert_array_equal(got, _pil(data))


def test_icons_without_entries_read_as_their_tga_headers():
    """Bytes that start as an ICO (00 00 01 00) with no entries and hold a
    valid TGA header open in PIL as TGA, mode L (image type 1 without a
    colour map, which PIL then cannot decode); as a CUR (00 00 02 00), as a
    true-colour TGA that decodes. The port reads both as PIL does."""
    ico, cur = CRAFTED["ico without entries"], CRAFTED["cur without entries"]
    assert (Image.open(io.BytesIO(ico)).format, Image.open(io.BytesIO(ico)).mode) == ("TGA", "L")
    assert image_kind(ico) == image_kind(cur) == "tga"
    with pytest.raises(ValueError, match="TGA"):
        decode_image(ico)
    with pytest.raises(ValueError):
        _pil(ico)
    np.testing.assert_array_equal(decode_image(cur), np.full((1, 1, 3), 7, np.uint8))
    np.testing.assert_array_equal(decode_image(cur), _pil(cur))


def test_every_fixture_dispatches_as_pil():
    """Every committed fixture of both image corpora, and short heads of
    them: the port's kind is PIL's format wherever PIL opens the bytes."""
    files = sorted(CORPUS.glob("*.*")) + sorted((ROOT / "data/corpus/image_formats").glob("*.*"))
    checked = 0
    for path in files:
        if path.suffix == ".json":
            continue
        data = path.read_bytes()
        for cut in (len(data), 18, 12):
            want = _pil_kind(data[:cut])
            if want is not None:
                assert image_kind(data[:cut]) == want, (path.name, cut)
                checked += 1
    assert checked > 200


# ------------------------------------------------------ loader and gateway

def test_the_native_loader_reads_the_library_kinds():
    loader = NativeLoader(2)
    entries = [e for e in DECODED if e["format"] in ("dds", "tga", "qoi", "pcx", "dcx", "sgi")]
    assert len(entries) > 40
    for e in entries:
        path = str(ROOT / e["file"])
        assert loader.image_size(path) == tuple(e["shape"][:2])
        assert _digest(loader.load_image_u8(path)) == e["sha256_pil_rgb"]


def test_gateway_answers_dds_tga_and_ico_bodies_as_the_png_of_their_pixels(tmp_path):
    gen = Generator.srresnet(2, num_blocks=1, num_filters=8, batch_norm=False,
                             dtype="float32", seed=3, device="cpu")
    model = str(tmp_path / "tiny.msgpack")
    save_model(gen.module_config(), gen.variables, model)
    names = ("dds_bc7_mode6_17x33.dds", "tga_rle_pil_17x33.tga", "ico_png_pil_17x33.ico")
    bodies = [(CORPUS / n).read_bytes() for n in names]
    pixels = [_pil(b) for b in bodies]
    ready, stop, box = threading.Event(), threading.Event(), {}
    thread = threading.Thread(target=http_gateway.serve_http, args=(model, 2, 0), daemon=True,
                              kwargs=dict(ready_event=ready, stop_event=stop, device="cpu",
                                          on_server=lambda s: box.update(s=s)))
    thread.start()
    assert ready.wait(60)
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    url = f"http://127.0.0.1:{box['s'].server_address[1]}/upscale"
    try:
        for body, img in zip(bodies, pixels):
            replies = []
            for b in (body, encode_png(img)):
                with opener.open(urllib.request.Request(url, data=b), timeout=60) as r:
                    assert r.status == 200
                    replies.append(decode_png(r.read()))
            assert replies[0].shape == (2 * img.shape[0], 2 * img.shape[1], 3)
            np.testing.assert_array_equal(replies[0], replies[1])
    finally:
        stop.set()
        thread.join(timeout=30)
