"""The port's JPEG decoder (``csrc/host/loader.cpp``) against PIL 12
(libjpeg-turbo 3) and the JAX package's native loader (libjpeg-turbo 2):
the committed fixtures (the gallery's JPEG copy and the mode matrix) and
generated files, bit for bit, and the refusals. Every mode is exact, so no
test states a bound.

The damaged-input sweep runs the port's decoders in a subprocess, so that a
crash fails the test and not the worker. It holds the port to the JAX
package's paths (the native loader, which refuses on any libjpeg warning;
then PIL, where the JAX pipeline falls back): where the native loader
decodes, the port decodes the same; where the port decodes and the native
loader does not, the port equals PIL (libjpeg's decode of a file with
extraneous bytes before a marker); where the port refuses, the native loader
refuses too (corrupt data: PIL may still decode it, filled with grey)."""

import hashlib
import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from _jax_loader import jax_native_loader
from _jpeg_writer import write_jpeg, write_jpeg_arith, write_jpeg_lossless
from _png_writer import write_png
from simplesr_tpu_torch.data.image import decode_image, read_rgb_u8
from simplesr_tpu_torch.data.native_loader import NativeLoader

ROOT = Path(__file__).resolve().parents[1]
MANIFEST = json.loads((ROOT / "data/corpus/image_modes/MANIFEST.json").read_text())
JPEG_FIXTURES = [e for e in MANIFEST["files"] if e["format"] == "jpeg"]
GALLERY = np.asarray(Image.open(ROOT / "data/corpus/gallery/gt_16.png").convert("RGB"))


@pytest.fixture(scope="module")
def jax_loader():
    return jax_native_loader()


def _pil(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _digest(a):
    return hashlib.sha256(np.ascontiguousarray(a, np.uint8).tobytes()).hexdigest()


def _jpeg(img, mode="RGB", **save):
    buf = io.BytesIO()
    Image.fromarray(img).convert(mode).save(buf, "JPEG", **save)
    return buf.getvalue()


@pytest.mark.parametrize("entry", JPEG_FIXTURES, ids=lambda e: Path(e["file"]).name)
def test_committed_jpeg_fixtures(entry, jax_loader):
    path = ROOT / entry["file"]
    data = path.read_bytes()
    assert _digest(_pil(data)) == entry["sha256_pil_rgb"]
    got = decode_image(data)
    assert _digest(got) == entry["sha256_pil_rgb"]
    assert NativeLoader(1).image_size(path) == got.shape[:2] == tuple(entry["shape"][:2])
    if entry["encode"]["mode"] == "CMYK":  # libjpeg-turbo converts no CMYK to RGB
        with pytest.raises(IOError):
            jax_loader.load_image_u8(str(path))
    else:
        np.testing.assert_array_equal(jax_loader.load_image_u8(str(path)), got)


def test_gallery_copy_covers_its_settings():
    gallery = [e for e in JPEG_FIXTURES if "gallery_jpeg" in e["file"]]
    saves = [e["encode"]["save"] for e in gallery]
    assert len(gallery) == 16
    assert sum(bool(s.get("progressive")) for s in saves) == 4
    assert {s.get("subsampling") for s in saves} == {0, 1, None}
    assert any(s.get("restart_marker_blocks") for s in saves)


@pytest.mark.parametrize("shape", [(1, 1), (1, 17), (17, 1), (8, 8), (9, 16), (31, 33)])
@pytest.mark.parametrize("save", [dict(quality=90), dict(quality=1), dict(quality=100),
                                  dict(quality=80, subsampling=0), dict(quality=80, subsampling=1),
                                  dict(quality=85, progressive=True),
                                  dict(quality=85, progressive=True, subsampling=0),
                                  dict(quality=90, optimize=True),
                                  dict(quality=90, restart_marker_blocks=1),
                                  dict(quality=90, restart_marker_rows=1, progressive=True)])
def test_generated_rgb_matches_pil_and_the_jax_loader(tmp_path, jax_loader, shape, save):
    rng = np.random.default_rng(sum(shape))
    img = np.clip(GALLERY[:shape[0], :shape[1]].astype(int)
                  + rng.integers(-20, 21, shape + (3,)), 0, 255).astype(np.uint8)
    data = _jpeg(img, **save)
    got = decode_image(data)
    np.testing.assert_array_equal(got, _pil(data))
    path = tmp_path / "g.jpg"
    path.write_bytes(data)
    np.testing.assert_array_equal(jax_loader.load_image_u8(str(path)), got)


@pytest.mark.parametrize("mode", ["L", "CMYK"])
@pytest.mark.parametrize("progressive", [False, True])
def test_grey_and_cmyk_match_pil(mode, progressive):
    data = _jpeg(GALLERY[3:44, 5:38], mode, quality=88, progressive=progressive)
    np.testing.assert_array_equal(decode_image(data), _pil(data))


@pytest.mark.parametrize("sampling", [[(1, 2), (1, 1), (1, 1)], [(4, 1), (1, 1), (1, 1)],
                                      [(1, 4), (1, 1), (1, 1)], [(2, 2), (1, 2), (2, 1)],
                                      [(3, 1), (1, 1), (1, 1)], [(3, 2), (1, 1), (1, 2)],
                                      [(1, 1), (2, 2), (1, 1)], [(2, 1), (1, 1), (2, 1)]])
@pytest.mark.parametrize("restart", [0, 2])
def test_any_integral_sampling_factors(sampling, restart):
    """Layouts Pillow cannot write (4:4:0, 4:1:1, 3x, mixed), from the
    test's own writer: h1v2 fancy and box upsampling against PIL's."""
    ycc = np.asarray(Image.fromarray(GALLERY[:41, :53]).convert("YCbCr"))
    for h, w in ((41, 53), (9, 2), (1, 1)):
        data = write_jpeg([ycc[:h, :w, i] for i in range(3)], sampling, restart_interval=restart)
        np.testing.assert_array_equal(decode_image(data), _pil(data))


@pytest.mark.parametrize("transform", [None, 0, 1, 2])
@pytest.mark.parametrize("components", [3, 4])
def test_adobe_transforms_and_four_components(components, transform):
    """JFIF or Adobe's APP14: 3 components as YCbCr (JFIF, transform 1) or
    RGB (transform 0); 4 as CMYK (no marker, transform 0) or YCCK
    (transform 1 or 2), each converted as PIL converts it."""
    ycc = np.asarray(Image.fromarray(GALLERY[:19, :27]).convert("YCbCr"))
    planes = [ycc[..., i] for i in range(3)] + [GALLERY[:19, :27, 1]][:components - 3]
    sampling = [(2, 2), (1, 1), (1, 1), (2, 2)][:components]
    data = write_jpeg(planes, sampling, adobe_transform=transform)
    np.testing.assert_array_equal(decode_image(data), _pil(data))


def test_too_many_blocks_per_mcu_are_refused():
    ycc = np.asarray(Image.fromarray(GALLERY[:16, :16]).convert("YCbCr"))
    data = write_jpeg([ycc[..., i] for i in range(3)], [(4, 2), (2, 1), (1, 1)])
    with pytest.raises(OSError):
        _pil(data)
    with pytest.raises(ValueError, match="JPEG"):
        decode_image(data)


@pytest.mark.parametrize("sof,what", [(0xC5, "hierarchical"), (0xC6, "hierarchical"),
                                      (0xC7, "hierarchical"), (0xCB, "lossless arithmetic"),
                                      (0xCD, "hierarchical arithmetic")])
def test_unsupported_processes_name_the_roadmap(sof, what):
    """The processes libjpeg refuses, and so PIL with it."""
    data = bytearray(_jpeg(GALLERY[:16, :16], quality=90))
    data[data.index(b"\xff\xc0") + 1] = sof
    with pytest.raises(OSError):
        _pil(bytes(data))
    with pytest.raises(ValueError, match=f"{what}.*ROADMAP.md"):
        decode_image(bytes(data))


@pytest.mark.parametrize("process", ["lossless", "arithmetic", "arithmetic progressive"])
def test_lossless_and_arithmetic_processes_decode_as_pil(process):
    """SOF3, SOF9 and SOF10, which the port refused before it had their
    decoders (tests/test_torch_jpeg_variants.py holds them further)."""
    ycc = np.asarray(Image.fromarray(GALLERY[:21, :30]).convert("YCbCr"))
    planes = [ycc[:, :, i] for i in range(3)]
    if process == "lossless":
        rgb = GALLERY[:21, :30]
        data = write_jpeg_lossless([rgb[:, :, i] for i in range(3)], 7, marker=None)
    else:
        scans = [((0, 1, 2), 0, 0, 0, 0), ((0,), 1, 63, 0, 0), ((1,), 1, 63, 0, 0),
                 ((2,), 1, 63, 0, 0)] if process.endswith("progressive") else None
        data = write_jpeg_arith(planes, [(2, 1), (1, 1), (1, 1)], scans=scans)
    np.testing.assert_array_equal(decode_image(data), _pil(data))


def test_twelve_bit_samples_name_the_roadmap():
    data = bytearray(_jpeg(GALLERY[:16, :16], quality=90))
    data[data.index(b"\xff\xc0") + 4] = 12
    with pytest.raises(OSError):  # PIL reads only 8-bit frames
        _pil(bytes(data))
    with pytest.raises(ValueError, match="12-bit.*ROADMAP.md"):
        decode_image(bytes(data))


def test_exif_orientation_is_ignored_as_pil_open_ignores_it():
    exif = Image.Exif()
    exif[0x0112] = 6
    data = _jpeg(GALLERY[:20, :30], quality=90, exif=exif.tobytes())
    got = decode_image(data)
    assert got.shape == (20, 30, 3)
    np.testing.assert_array_equal(got, _pil(data))


def test_extraneous_bytes_before_a_marker_decode_as_pil(tmp_path, jax_loader):
    """libjpeg warns and reads on: the JAX loader refuses, PIL decodes."""
    data = _jpeg(GALLERY[:24, :40], quality=90)
    at = data.index(b"\xff\xc4")
    junk = data[:at] + b"\x00\x13\x37" + data[at:]
    end = junk.rindex(b"\xff\xd9")
    junk = junk[:end] + b"\x42\x42" + junk[end:]
    path = tmp_path / "x.jpg"
    path.write_bytes(junk)
    with pytest.raises(IOError):
        jax_loader.load_image_u8(str(path))
    np.testing.assert_array_equal(decode_image(junk), _pil(junk))
    np.testing.assert_array_equal(decode_image(junk), decode_image(data))


def test_bombs_and_junk_are_refused(tmp_path):
    data = bytearray(_jpeg(GALLERY[:16, :16], quality=90))
    sof = data.index(b"\xff\xc0")
    data[sof + 5:sof + 9] = (60000).to_bytes(2, "big") * 2  # 3.6e9 pixels
    with pytest.raises(ValueError, match="exceeds the limit"):
        decode_image(bytes(data))
    for junk in (b"", b"\xff\xd8", b"\xff\xd8\xff\xd9", b"GIF89a", b"\xff\xd8" + bytes(100)):
        with pytest.raises(ValueError):
            decode_image(junk)
    path = tmp_path / "j.jpg"
    path.write_bytes(b"\xff\xd8\xff\xe0\x00\x10JFIF\x00" + bytes(32))
    with pytest.raises(ValueError, match="JPEG"):
        read_rgb_u8(path)
    with pytest.raises(ValueError):
        NativeLoader(1).load_image_u8(path)


# ---------------------------------------------------------------- damage

SWEEP = """
import hashlib, json, sys
import numpy as np
from simplesr_tpu_torch.data.image import decode_image
from simplesr_tpu_torch.data.png import as_rgb, decode_png
from simplesr_tpu_torch.data.native_loader import NativeLoader

def outcome(fn):
    try:
        return hashlib.sha256(np.ascontiguousarray(fn()).tobytes()).hexdigest()
    except ValueError:
        return None

loader = NativeLoader(2)
out = []
for path in sys.argv[1:]:
    data = open(path, "rb").read()
    row = {"bytes": outcome(lambda: decode_image(data, grey16="loader")),
           "loader": outcome(lambda: loader.load_image_u8(path))}
    if data[:4] == b"\\x89PNG":
        row["python"] = outcome(lambda: as_rgb(decode_png(data, grey16="loader")))
    out.append(row)
print(json.dumps(out))
"""


def _variants(data, rng, truncations=50, flips=100):
    out = [data[:int(rng.integers(2, len(data)))] for _ in range(truncations)]
    for _ in range(flips):
        d = bytearray(data)
        d[int(rng.integers(0, len(d)))] ^= 1 << int(rng.integers(0, 8))
        out.append(bytes(d))
    return out


def test_damaged_inputs_refuse_or_decode_as_the_jax_path(tmp_path, jax_loader):
    rng = np.random.default_rng(2024)
    img = GALLERY[:64, :80]
    sources = {"baseline": _jpeg(img, quality=85, restart_marker_blocks=6),
               "progressive": _jpeg(img, quality=85, progressive=True),
               # an ancillary chunk, whose damage libpng ignores
               "png": write_png(img[:40, :48], 2, 8,
                                extra=[(b"tEXt", b"Comment\0" + bytes(range(32, 127)) * 8)])}
    cases = []
    for name, data in sources.items():
        for k, variant in enumerate(_variants(data, rng)):
            path = tmp_path / f"{name}_{k}"
            path.write_bytes(variant)
            cases.append((name, path))
    proc = subprocess.run([sys.executable, "-c", SWEEP, *map(str, (p for _, p in cases))],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    port = json.loads(proc.stdout)
    tally = {}
    for (name, path), got in zip(cases, port):
        assert got["loader"] == got["bytes"] == got.get("python", got["bytes"]), path.name

        def jax_native():
            return jax_loader.load_image_u8(str(path))

        def pil():
            return _pil(path.read_bytes())

        native = pil_out = None
        try:
            native = _digest(jax_native())
        except IOError:
            pass
        if got["bytes"] is None:
            assert native is None, f"{path.name}: the JAX loader decodes, the port refuses"
            kind = "refused"
        elif native is not None:
            assert got["bytes"] == native, f"{path.name}: differs from the JAX loader"
            kind = "as the JAX loader"
        else:
            pil_out = _digest(pil())
            assert got["bytes"] == pil_out, f"{path.name}: differs from PIL"
            kind = "as PIL"
        tally[name, kind] = tally.get((name, kind), 0) + 1
    # the sweep reached every outcome it holds the port to
    for name in sources:
        assert tally.get((name, "refused"), 0) > 0 and tally.get((name, "as the JAX loader"), 0)
    assert tally.get(("baseline", "as PIL"), 0) + tally.get(("progressive", "as PIL"), 0) > 0
