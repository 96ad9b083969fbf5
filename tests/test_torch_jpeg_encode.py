"""The port's JPEG encoder (``csrc/host/jpeg_encode.cpp``, bound as
``data.native_loader.encode_jpeg``) against Pillow 12.1 over libjpeg-turbo
3.1.3, the encoder the JAX package's campaign reaches through PIL
(scripts/jpg_noise_campaign.py: libjpeg_degrade_01): the same bytes for
gallery crops and random images at every quality and at shapes that
exercise the edge expansion (1 x 1, 7 x 13, 17 x 33, 256 x 360, half a
gallery tile's LR), ``libjpeg_degrade`` equal to PIL's round trip pixel for
pixel, every refusal, and the committed fixtures' digests
(data/corpus/jpeg_encode, which ``chip_smoke.py`` phase 17 (a) checks on
the card). Every case is exact, so no test states a bound."""

import hashlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from simplesr_tpu_torch.data.native_loader import encode_jpeg, libjpeg_degrade

ROOT = Path(__file__).resolve().parents[1]
MANIFEST = json.loads((ROOT / "data/corpus/jpeg_encode/MANIFEST.json").read_text())
GALLERY = np.asarray(Image.open(ROOT / "data/corpus/gallery/gt_1.png").convert("RGB"))
QUALITIES = [1, 10, 30, 50, 75, 90, 95, 100]
SHAPES = [(1, 1), (7, 13), (17, 33), (256, 360)]


def pil_bytes(u8, quality):
    buf = io.BytesIO()
    Image.fromarray(u8).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def crop(shape, top=37, left=51):
    h, w = shape
    return np.ascontiguousarray(GALLERY[top:top + h, left:left + w])


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", QUALITIES)
def test_gallery_crop_bytes_equal_pil(shape, quality):
    u8 = crop(shape)
    assert encode_jpeg(u8, quality) == pil_bytes(u8, quality)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_random_image_bytes_equal_pil(shape):
    """Noise: large coefficients, long Huffman codes, 0xFF bytes to stuff."""
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    u8 = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    for quality in QUALITIES:
        assert encode_jpeg(u8, quality) == pil_bytes(u8, quality), quality


@settings(max_examples=60, deadline=None)
@given(h=st.integers(1, 48), w=st.integers(1, 48), quality=st.integers(0, 100),
       seed=st.integers(0, 2**31 - 1), kind=st.sampled_from(["noise", "gallery", "flat"]))
def test_any_shape_and_quality_bytes_equal_pil(h, w, quality, seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        u8 = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    elif kind == "gallery":
        u8 = crop((h, w), int(rng.integers(0, GALLERY.shape[0] - h)),
                  int(rng.integers(0, GALLERY.shape[1] - w)))
    else:
        u8 = np.broadcast_to(rng.integers(0, 256, 3, dtype=np.uint8), (h, w, 3)).copy()
    assert encode_jpeg(u8, quality) == pil_bytes(u8, quality)


@pytest.mark.parametrize("quality", [30, 50, 75, 90])
def test_libjpeg_degrade_equals_pil_round_trip(quality):
    for shape in SHAPES:
        u8 = crop(shape, 3, 5)
        want = np.asarray(Image.open(io.BytesIO(pil_bytes(u8, quality))).convert("RGB"))
        got = libjpeg_degrade(u8, quality)
        assert got.dtype == np.uint8 and got.shape == u8.shape
        np.testing.assert_array_equal(got, want)


REFUSED = {
    "grey": (np.zeros((8, 8), np.uint8), 50, "grey"),
    "rgba": (np.zeros((8, 8, 4), np.uint8), 50, "4 channels"),
    "float": (np.zeros((8, 8, 3), np.float32), 50, "dtype float32"),
    "uint16": (np.zeros((8, 8, 3), np.uint16), 50, "dtype uint16"),
    "empty": (np.zeros((0, 8, 3), np.uint8), 50, "8 x 0 pixels"),
    "too_wide": (np.zeros((1, 65501, 3), np.uint8), 50, "65501 x 1 pixels"),
    "quality_101": (np.zeros((8, 8, 3), np.uint8), 101, "quality 101"),
    "quality_negative": (np.zeros((8, 8, 3), np.uint8), -1, "quality -1"),
    "quality_float": (np.zeros((8, 8, 3), np.uint8), 50.0, "quality 50.0"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_refusals_name_what_they_refuse(case):
    u8, quality, names = REFUSED[case]
    with pytest.raises(ValueError, match=names):
        encode_jpeg(u8, quality)


def test_quality_zero_encodes_as_one():
    """libjpeg's scaling takes 0 as 1; Pillow passes 0 through."""
    u8 = crop((17, 33))
    assert encode_jpeg(u8, 0) == encode_jpeg(u8, 1) == pil_bytes(u8, 0)


def test_non_contiguous_input():
    u8 = GALLERY[10:60:2, 20:90:3]
    assert not u8.flags.c_contiguous
    assert encode_jpeg(u8, 75) == pil_bytes(np.ascontiguousarray(u8), 75)


@pytest.mark.parametrize("entry", MANIFEST["files"], ids=lambda e: Path(e["file"]).name)
def test_committed_fixture_digests(entry):
    top, left, h, w = entry["crop"]
    src = np.asarray(Image.open(ROOT / entry["source"]).convert("RGB"))
    u8 = np.ascontiguousarray(src[top:top + h, left:left + w])
    got = encode_jpeg(u8, entry["quality"])
    committed = (ROOT / entry["file"]).read_bytes()
    assert hashlib.sha256(committed).hexdigest() == entry["sha256"]
    assert len(got) == entry["bytes"] and hashlib.sha256(got).hexdigest() == entry["sha256"]
    assert got == pil_bytes(u8, entry["quality"])
