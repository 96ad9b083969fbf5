"""Every PNG colour type x bit depth x interlace through the port's two PNG
decoders, the C++ one (``csrc/host/loader.cpp``, through the dispatcher's
bytes entry) and the plain Python one (``data/png.py``), held bit for bit:
in PIL mode to PIL's ``convert("RGB")``, in loader mode to the JAX
package's native loader (libpng). Both modes cover 16-bit grey, where the
two JAX decoders differ (PIL clips to 255, the loader keeps the high byte).
The committed fixtures (data/corpus/image_modes) are held to their
manifest's digests, and the digests to PIL."""

import hashlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from _jax_loader import jax_native_loader
from _png_writer import MODES, mode_samples, write_png
from simplesr_tpu_torch.data.image import decode_image
from simplesr_tpu_torch.data.native_loader import NativeLoader
from simplesr_tpu_torch.data.png import as_rgb, decode_png

ROOT = Path(__file__).resolve().parents[1]
MANIFEST = json.loads((ROOT / "data/corpus/image_modes/MANIFEST.json").read_text())
PNG_FIXTURES = [e for e in MANIFEST["files"] if e["format"] == "png"]


@pytest.fixture(scope="module")
def jax_loader():
    return jax_native_loader()


def _pil(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _digest(a):
    return hashlib.sha256(np.ascontiguousarray(a, np.uint8).tobytes()).hexdigest()


def _check(data, path, jax_loader):
    want_pil = _pil(data)
    path.write_bytes(data)
    want_loader = jax_loader.load_image_u8(str(path))
    for grey16, want in (("pil", want_pil), ("loader", want_loader)):
        np.testing.assert_array_equal(decode_image(data, grey16=grey16), want)
        np.testing.assert_array_equal(as_rgb(decode_png(data, grey16=grey16)), want)
    np.testing.assert_array_equal(NativeLoader(1).load_image_u8(path), want_loader)
    return want_pil, want_loader


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("colour,depth", MODES)
def test_every_mode_matches_pil_and_the_jax_loader(tmp_path, jax_loader, colour, depth,
                                                  interlace):
    samples, palette = mode_samples(colour, depth, (19, 29), seed=7 * colour + depth)
    pil, loader = _check(write_png(samples, colour, depth, interlace, palette),
                         tmp_path / "m.png", jax_loader)
    if (colour, depth) == (0, 16):  # the one mode where the two differ
        assert pil[0, 0, 0] == 255 and loader[0, 0, 0] == 5000 >> 8
        assert (pil != loader).any()
    else:
        np.testing.assert_array_equal(pil, loader)


@pytest.mark.parametrize("shape", [(1, 1), (1, 9), (9, 1), (3, 5), (8, 8), (9, 17)])
def test_adam7_passes_at_small_sizes(tmp_path, jax_loader, shape):
    """Sizes where some Adam7 passes are empty; 2-bit palette and 16-bit RGBA."""
    for colour, depth in ((3, 2), (6, 16), (0, 1)):
        samples, palette = mode_samples(colour, depth, shape, seed=sum(shape))
        _check(write_png(samples, colour, depth, 1, palette, kinds=(4, 3, 1)),
               tmp_path / f"a{colour}.png", jax_loader)


def test_palette_index_past_the_palette_reads_black(tmp_path, jax_loader):
    samples = np.array([[[0], [1], [2], [200]]])
    pil, _ = _check(write_png(samples, 3, 8, palette=[[10, 20, 30], [40, 50, 60]]),
                    tmp_path / "p.png", jax_loader)
    assert pil[0, 2:].tolist() == [[0, 0, 0], [0, 0, 0]]


def test_ancillary_chunks_are_ignored(tmp_path, jax_loader):
    samples, palette = mode_samples(3, 8, (6, 7), seed=1)
    extra = [(b"tEXt", b"Comment\0hello"), (b"gAMA", (45455).to_bytes(4, "big"))]
    _check(write_png(samples, 3, 8, palette=palette, extra=extra), tmp_path / "t.png",
           jax_loader)


@pytest.mark.parametrize("colour,depth,trns", [(3, 8, bytes([0, 128, 255])),
                                               (0, 16, bytes(2)), (2, 8, bytes(6))])
def test_trns_is_dropped_as_pil_drops_it(colour, depth, trns):
    """A transparent colour (tRNS) in a PNG without an alpha channel: both
    modes read the colours as PIL's convert("RGB") does. The JAX loader is
    not asked: libpng expands tRNS to alpha, which it strips only for colour
    types with alpha, so it writes RGBA into its RGB buffer (ROADMAP.md,
    Queue 3)."""
    samples, palette = mode_samples(colour, depth, (6, 7), seed=2)
    data = write_png(samples, colour, depth, palette=palette, extra=[(b"tRNS", trns)])
    want = _pil(data)
    for grey16 in ("pil", "loader"):
        if depth == 16 and grey16 == "loader":
            want = (samples >> 8).astype(np.uint8).repeat(3, axis=2)
        np.testing.assert_array_equal(decode_image(data, grey16=grey16), want)
        np.testing.assert_array_equal(as_rgb(decode_png(data, grey16=grey16)), want)


@pytest.mark.parametrize("entry", PNG_FIXTURES, ids=lambda e: Path(e["file"]).name)
def test_committed_png_fixtures_match_their_digests(entry):
    data = (ROOT / entry["file"]).read_bytes()
    assert _digest(_pil(data)) == entry["sha256_pil_rgb"]
    for decode in (decode_image, lambda d, grey16: as_rgb(decode_png(d, grey16=grey16))):
        assert _digest(decode(data, grey16="pil")) == entry["sha256_pil_rgb"]
        assert _digest(decode(data, grey16="loader")) == entry.get("sha256_loader_rgb",
                                                                   entry["sha256_pil_rgb"])


def test_fixtures_cover_every_mode_and_interlace():
    seen = {(e["encode"]["colour_type"], e["encode"]["bit_depth"], e["encode"].get("interlace"))
            for e in PNG_FIXTURES}
    assert {(c, d, i) for c, d in MODES for i in (0, 1)} <= seen
