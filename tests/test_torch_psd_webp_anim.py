"""The port's readers of animated WebP (its first frame on the canvas), PSD
(the merged image) and DIB (a BMP without its file header) against PIL's
``Image.open(f).convert("RGB")``, which the JAX package's read paths and
daemon use (``read_img``, ``_read_img_u8``, tools/serve.py): bit for bit on
every fixture, so no test states a bound. PIL writes the animated WebPs (and
the still WebPs whose bitstreams the hand-built animations wrap),
tests/_psd_writer.py the PSDs (PIL cannot write PSD), and PIL's BMPs with
their 14-byte file header cut off are the DIBs. Every variant PIL refuses
is refused by the port too, by name where it is a variant and not damage."""

import hashlib
import io
import json
import struct
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from _bmp_writer import rle_encode, write_bmp_rle
from _psd_writer import packbits, write_psd
from _webp_writer import animation, anmf, chunk, image_chunks
from simplesr_tpu.data.pipeline import _read_img_u8 as jax_read_img_u8
from simplesr_tpu_torch.data import DataPipeline
from simplesr_tpu_torch.data.image import decode_image, image_kind, read_rgb_u8
from simplesr_tpu_torch.data.native_loader import NativeLoader
from simplesr_tpu_torch.tools import serve

ITEM = "ROADMAP.md, Queue 1, item 3"
ROOT = Path(__file__).resolve().parents[1]
# the committed fixtures, which chip_smoke.py also checks against their digests
MANIFEST = json.loads((ROOT / "data/corpus/psd_dib_anim/MANIFEST.json").read_text())
RNG = np.random.default_rng(2026)
IMG = RNG.integers(0, 256, (23, 37, 3), dtype=np.uint8)
IMG[4:15, 6:30] = IMG[4:15, 6:7]  # flat runs, for PackBits and the encoders


def _pil(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), np.uint8)


def _save(img, fmt, **save):
    buf = io.BytesIO()
    img.save(buf, fmt, **save)
    return buf.getvalue()


def _check(data, kind, tmp_path=None):
    """The port's decode, its daemon's and (given a directory) its file read
    equal PIL's, and the JAX package's file read."""
    assert image_kind(data) == kind
    want = _pil(data)
    np.testing.assert_array_equal(decode_image(data), want)
    np.testing.assert_array_equal(serve.decode_image(data), want)
    if tmp_path is not None:
        path = tmp_path / f"f.{kind}"
        path.write_bytes(data)
        np.testing.assert_array_equal(read_rgb_u8(path), jax_read_img_u8(str(path)))


def _refused_by_both(data, match):
    with pytest.raises(Exception):
        _pil(data)
    with pytest.raises(ValueError, match=match):
        decode_image(data)


@pytest.mark.parametrize("entry", MANIFEST["files"], ids=lambda e: Path(e["file"]).name)
def test_committed_fixtures_read_as_the_jax_readers(entry):
    path = ROOT / entry["file"]
    if "refused" in entry:
        _refused_by_both(path.read_bytes(), f"{entry['refused']}.*{ITEM}")
        return
    want = jax_read_img_u8(str(path))
    digest = hashlib.sha256(np.ascontiguousarray(want).tobytes()).hexdigest()
    assert digest == entry["sha256_pil_rgb"] and list(want.shape) == entry["shape"]
    assert image_kind(path.read_bytes()) == entry["format"]
    np.testing.assert_array_equal(read_rgb_u8(path), want)


def test_the_native_loader_and_a_training_folder_read_them(tmp_path):
    """The training pipeline's readers: the C++ loader reads the animated
    WebPs and PSDs by path; a folder of one of each kind lists and decodes
    every file as the JAX pipeline does (a DIB in numpy)."""
    loader = NativeLoader(2)
    for e in MANIFEST["files"]:
        if e["format"] in ("webp", "psd") and "refused" not in e:
            path = str(ROOT / e["file"])
            assert loader.image_size(path) == tuple(e["shape"][:2])
            digest = hashlib.sha256(loader.load_image_u8(path).tobytes()).hexdigest()
            assert digest == e["sha256_pil_rgb"], path
    folder = ROOT / "data/corpus/psd_dib_anim"
    names = ["timing_webp_anim.webp", "timing_psd_rgb_packbits.psd", "timing_dib_rgb24.dib"]
    for name in names:
        (tmp_path / name).write_bytes((folder / name).read_bytes())
    pipe = DataPipeline(hr_img_path=str(tmp_path), scale=2, train_val_split=0.34, batch_size=1,
                        crop_size=(16, 16, 3), num_crops=1, random_seed=1, device="cpu")
    listed = sorted(pipe.train_imgs + pipe.val_imgs)
    assert sorted(Path(p).name for p in listed) == sorted(names)
    for path in listed:
        np.testing.assert_array_equal(pipe._decoded(path), jax_read_img_u8(path), err_msg=path)
        assert pipe._image_hw(path) == (96, 128)


def test_the_committed_fixtures_cover_the_kinds():
    kinds = {}
    for e in MANIFEST["files"]:
        kinds.setdefault(e["format"], []).append(e)
    assert sorted(kinds) == ["dib", "psd", "webp"]
    psd = [e["params"] for e in kinds["psd"] if "refused" not in e]
    assert {p["mode"] for p in psd} == {0, 1, 2, 3, 4, 7, 8, 9}
    assert {p["compression"] for p in psd} == {0, 1}
    assert {e["refused"] for e in kinds["psd"] if "refused" in e} == {
        "PSB", "16-bit RGB", "ZIP compression"}
    assert all(e["params"].get("frames", 0) >= 2 for e in kinds["webp"])
    # a decoder that returned a constant image would match no fixture, and
    # no two PSD colour modes decode to the same image
    for e in MANIFEST["files"]:
        if "refused" not in e:
            rgb = _pil((ROOT / e["file"]).read_bytes())
            assert rgb.min() < rgb.max(), e["file"]
    modes = {}
    for e in kinds["psd"]:
        if "refused" not in e:
            modes.setdefault(e["sha256_pil_rgb"], set()).add(e["params"]["mode"])
    assert all(len(m) == 1 for m in modes.values()), modes
    assert sum(p.stat().st_size for p in (ROOT / "data/corpus/psd_dib_anim").iterdir()) < \
        256 << 10


# ------------------------------------------------------------ animated WebP

def _rgba(seed, border):
    """An RGBA frame of IMG's size, random in a box and transparent around it
    (PIL's encoder then crops the first frame to the box: an offset)."""
    a = np.zeros(IMG.shape[:2] + (4,), np.uint8)
    rng = np.random.default_rng(seed)
    h, w = IMG.shape[:2]
    a[border:h - border, 2 * border:w - border, :3] = rng.integers(
        0, 256, (h - 2 * border, w - 3 * border, 3))
    a[border:h - border, 2 * border:w - border, 3] = rng.integers(
        1, 256, (h - 2 * border, w - 3 * border))
    return Image.fromarray(a, "RGBA")


PIL_ANIMATIONS = {
    "lossy_2_frames": lambda: _save(Image.fromarray(IMG), "WEBP", save_all=True,
                                    append_images=[Image.fromarray(IMG[::-1].copy())],
                                    quality=50),
    "lossless_3_frames": lambda: _save(Image.fromarray(IMG), "WEBP", save_all=True,
                                       append_images=[Image.fromarray(IMG // 2),
                                                      Image.fromarray(255 - IMG)],
                                       lossless=True),
    "lossy_alpha_offset": lambda: _save(_rgba(1, 3), "WEBP", save_all=True,
                                        append_images=[_rgba(2, 0)], quality=70),
    "lossless_alpha_offset": lambda: _save(_rgba(3, 5), "WEBP", save_all=True,
                                           append_images=[_rgba(4, 1), _rgba(5, 2)],
                                           lossless=True),
    "mixed_frames": lambda: _save(Image.fromarray(IMG), "WEBP", save_all=True,
                                  append_images=[_rgba(6, 2)] * 3, allow_mixed=True,
                                  quality=40, duration=[10, 20, 30, 40], loop=3,
                                  background=(10, 200, 30, 255)),
}


@pytest.mark.parametrize("name", PIL_ANIMATIONS)
def test_pil_animations_read_their_first_frame(name, tmp_path):
    data = PIL_ANIMATIONS[name]()
    assert Image.open(io.BytesIO(data)).n_frames > 1
    _check(data, "webp", tmp_path)


SMALL = Image.fromarray(IMG[:9, :14])
ALPHA = _rgba(7, 0).crop((0, 0, 14, 9))
BUILT = {
    "one_frame_offset_blend": lambda: animation((40, 30), anmf(6, 4, SMALL, 0, quality=60)),
    "one_frame_no_blend_dispose": lambda: animation((40, 30), anmf(26, 20, ALPHA, 3,
                                                                   quality=60)),
    "lossless_alpha_at_the_edge": lambda: animation((20, 13), anmf(6, 4, ALPHA, 1,
                                                                   lossless=True)),
    "lossy_alpha_then_frames": lambda: animation(
        (16, 12), anmf(2, 2, ALPHA.crop((0, 0, 14, 9)), 2, quality=80),
        anmf(0, 0, SMALL, 0, lossless=True), anmf(2, 0, ALPHA, 1, quality=20)),
    "other_chunks_around": lambda: animation(
        (30, 20), chunk(b"ABCD", b"xyz"), anmf(4, 2, SMALL, 0, quality=60),
        chunk(b"EXIF", b"Exif\0\0" + bytes(10)), chunk(b"XMP ", b"<x/>"), vp8x_flags=0x1e),
    # the demuxer sizes a frame by its bitstream, not by its ANMF header
    "anmf_size_not_the_bitstream": lambda: animation(
        (30, 20), anmf(4, 2, SMALL, 0, size=(10, 5), quality=60)),
}


@pytest.mark.parametrize("name", BUILT)
def test_built_animations_read_as_pil(name, tmp_path):
    _check(BUILT[name](), "webp", tmp_path)


DAMAGED = {
    "ANMF chunk before the ANIM chunk": lambda: animation((30, 20), anmf(0, 0, SMALL),
                                                          anim=False),
    "frame outside the canvas": lambda: animation((20, 10), anmf(8, 2, SMALL)),
    "animation without frames": lambda: animation((20, 10)),
    "image chunk outside an ANMF": lambda: animation((14, 9), image_chunks(SMALL)),
    "ANMF frame without an image": lambda: animation((14, 9), anmf(0, 0, SMALL, image=b"")),
    "ALPH chunk before a VP8L": lambda: animation(
        (14, 9), anmf(0, 0, ALPHA, image=chunk(b"ALPH", b"\0" + bytes(126))
                      + image_chunks(ALPHA, lossless=True))),
    "bad ALPH header": lambda: animation(
        (14, 9), anmf(0, 0, ALPHA, image=chunk(b"ALPH", b"\x03" + bytes(126))
                      + image_chunks(SMALL, quality=50))),
}


@pytest.mark.parametrize("what", DAMAGED)
def test_damaged_animations_are_refused_by_both(what):
    _refused_by_both(DAMAGED[what](), what)


def test_animation_chunks_in_a_still_webp_as_pil():
    """Without the animation flag, the demuxer takes an ANIM chunk after the
    image (and an ANMF after that ANIM, as no frame), and refuses an image
    after an ANIM chunk or an ANMF with no ANIM before it."""
    image, anim = image_chunks(SMALL, quality=50), chunk(b"ANIM", bytes(6))
    for chunks in ((image, anim), (image, anim, anmf(0, 0, SMALL, quality=50))):
        _check(animation((14, 9), *chunks, vp8x_flags=0x10, anim=False), "webp")
    _refused_by_both(animation((14, 9), image, vp8x_flags=0x10), "image chunk after an ANIM")
    _refused_by_both(animation((14, 9), image, anmf(0, 0, SMALL), vp8x_flags=0x10, anim=False),
                     "ANMF chunk before the ANIM chunk")


# --------------------------------------------------------------------- PSD

def _planes(n, seed=0, bits=False):
    rng = np.random.default_rng(seed)
    if bits:
        return [rng.integers(0, 2, (11, 21), dtype=np.uint8) for _ in range(n)]
    return [np.ascontiguousarray(np.roll(IMG[..., c % 3], 3 * c, 1)) for c in range(n)]


PALETTE = RNG.integers(0, 256, 768, dtype=np.uint8).tobytes()
RESOURCES = [(1039, b"icc", b"\1\2\3"), (1005, b"", bytes(16)), (1060, b"ab", bytes(7))]
LAYER = struct.pack(">I", 8) + bytes(8)  # a layer info block PIL skips by its length
PSDS = {  # name -> (planes, colour mode, write_psd arguments)
    "bitmap": (_planes(1, bits=True), 0, dict(depth=1)),
    "grey_mode_0": (_planes(1), 0, {}),
    "grey": (_planes(1), 1, {}),
    "grey_extra_channel": (_planes(2), 1, {}),
    "indexed": (_planes(1), 2, dict(color_data=PALETTE)),
    "indexed_without_palette": (_planes(1), 2, {}),
    "rgb": (_planes(3), 3, {}),
    "rgba": (_planes(4), 3, {}),
    "rgb_2_extra_channels": (_planes(5), 3, {}),
    "cmyk": (_planes(4), 4, {}),
    "cmyk_extra_channel": (_planes(5), 4, {}),
    "multichannel": (_planes(3), 7, {}),
    "duotone": (_planes(1), 8, dict(color_data=b"duotone spec" * 3)),
    "lab": (_planes(3), 9, {}),
    "resources_and_layers": (_planes(3), 3, dict(resources=RESOURCES, layer_data=LAYER)),
}


@pytest.mark.parametrize("compression", [0, 1], ids=["raw", "packbits"])
@pytest.mark.parametrize("name", PSDS)
def test_psd_merged_images_read_as_pil(name, compression, tmp_path):
    planes, mode, kwargs = PSDS[name]
    data = write_psd(planes, mode, compression=compression, **kwargs)
    if name.endswith(("extra_channel", "extra_channels")) and compression == 1:
        # PIL reads the row counts of the channels it needs only, so its first
        # stream starts inside the count table: the port reads the same, and
        # where the streams run past the file, both refuse it
        try:
            want = _pil(data)
        except OSError:
            with pytest.raises(ValueError, match="truncated"):
                decode_image(data)
            return
        np.testing.assert_array_equal(decode_image(data), want)
        return
    _check(data, "psd", tmp_path)


def test_psd_packbits_runs_cut_at_row_ends_and_no_ops():
    """Hand-made PackBits streams: a run and a literal past the row's end
    (PIL cuts both) and 0x80 no-ops, in a 1 x 5 grey image of 3 rows."""
    stream = bytes([0xFD, 9, 0x80, 0x03, 1, 2, 3, 4, 0xF9, 7, 0x80, 0x06, 1, 2, 3, 4, 5, 6, 7])
    head = write_psd([np.zeros((3, 5), np.uint8)], 1)[:-15 - 2]
    data = head + struct.pack(">H", 1) + struct.pack(">3H", 5, 7, 8) + stream
    want = _pil(data)
    np.testing.assert_array_equal(want[:, :, 0], [[9, 9, 9, 9, 1], [7, 7, 7, 7, 7],
                                                  [1, 2, 3, 4, 5]])
    np.testing.assert_array_equal(decode_image(data), want)
    assert packbits(b"\1\1\1\2") == bytes([0xFE, 1, 0, 2])


PSD_REFUSED = {
    "PSB": lambda: write_psd(_planes(3), 3, version=2),
    "16-bit RGB": lambda: write_psd(_planes(3), 3, depth=16),
    "32-bit greyscale": lambda: write_psd(_planes(1), 1, depth=32),
    "1-bit greyscale": lambda: write_psd(_planes(1, bits=True), 1, depth=1),
    "8-bit bitmap": lambda: write_psd(_planes(1), 0, depth=16),
    "fewer channels": lambda: write_psd(_planes(2), 3),
    "ZIP compression": lambda: write_psd(_planes(3), 3, compression=2),
    "ZIP compression of the image data with prediction":
        lambda: write_psd(_planes(3), 3, compression=3),
}


@pytest.mark.parametrize("what", PSD_REFUSED)
def test_psd_variants_pil_refuses_are_refused_by_name(what):
    data = PSD_REFUSED[what]()
    assert image_kind(data) == "psd"
    name = {"8-bit bitmap": "16-bit bitmap"}.get(what, what)
    _refused_by_both(data, f"{name}.*{ITEM}")


@pytest.mark.parametrize("cut", [3, 20, 30, 40])
def test_truncated_psds_are_refused_by_both(cut):
    for compression in (0, 1):
        data = write_psd(_planes(3), 3, compression=compression, resources=RESOURCES)
        _refused_by_both(data[:cut] if cut < 40 else data[:-cut], "truncated|PSD")


def test_a_large_raw_psd_without_its_data_is_refused():
    """A header that claims 3000 x 3000 RGB with a few bytes of raw data
    behind it: refused as truncated (the port checks the length before it
    allocates a band)."""
    data = write_psd(_planes(3), 3)
    data = data[:14] + struct.pack(">II", 3000, 3000) + data[22:]
    _refused_by_both(data, "truncated image data")


# --------------------------------------------------------------------- DIB

def _dib(img, **save):
    return _save(img, "BMP", **save)[14:]


PAL_IMG = Image.fromarray(IMG).quantize(16)
DIBS = {
    "rgb24": lambda: _dib(Image.fromarray(IMG)),
    "palette8": lambda: _dib(PAL_IMG),
    "palette4": lambda: _dib(PAL_IMG, bits=4),
    "bilevel": lambda: _dib(Image.fromarray(IMG[..., 0] > 128)),
    "grey": lambda: _dib(Image.fromarray(IMG[..., 1])),
    "rgba32": lambda: _dib(Image.fromarray(np.dstack([IMG, IMG[..., :1]]), "RGBA")),
    "rle8": lambda: write_bmp_rle(7, 5, RNG.integers(0, 256, (256, 3)),
                                  rle_encode(RNG.integers(0, 4, (5, 7))))[14:],
    "os2_core_header": lambda: struct.pack("<IHHHH", 12, 3, 2, 1, 24) + bytes(range(24)),
    "top_down": lambda: struct.pack("<IiiHHIIiiII", 40, 3, -2, 1, 24, 0, 0, 0, 0, 0, 0)
    + bytes(range(100, 124)),
}


@pytest.mark.parametrize("name", DIBS)
def test_dibs_read_as_pil(name, tmp_path):
    data = DIBS[name]()
    assert Image.open(io.BytesIO(data)).format == "DIB"
    _check(data, "dib", tmp_path)


def test_what_is_not_a_dib():
    """PIL's DIB plugin takes only the header sizes BMP knows; a 16-byte
    OS/2 2.x header is no DIB (and no other format): neither reads it."""
    data = struct.pack("<IHHHH", 16, 3, 2, 1, 24) + bytes(40)
    assert image_kind(data) is None
    with pytest.raises(ValueError, match="nor a DIB, PSD"):
        decode_image(data)
    with pytest.raises(Exception):
        _pil(data)
    # a DIB's refused compression is refused by name, as PIL refuses it
    jpeg = struct.pack("<IiiHHIIiiII", 40, 4, 2, 1, 24, 4, 8, 0, 0, 0, 0) + bytes(8)
    _refused_by_both(jpeg, f"JPEG compression.*{ITEM}")
