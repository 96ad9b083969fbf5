"""The JPEG processes beside baseline that PIL decodes (arithmetic coding,
sequential and progressive; lossless Huffman-coded files; progressive files
whose scans leave low coefficients unrefined, which libjpeg smooths) and the
TIFFs built on them, through the port's decoder (``csrc/host/loader.cpp``,
``tiff.cpp``) against PIL 12.1 (libjpeg-turbo 3.1), the JAX package's
readers (``read_img``, ``_read_img_u8``, the daemon's decode: PIL's
``convert("RGB")``) and, where it decodes a file, the JAX package's own
libjpeg loader (libjpeg-turbo 2.1). Every case is exact, so no test states a
bound.

The JAX loader's libjpeg-turbo 2.1 reads no lossless file, and it smooths a
Huffman-coded progressive file otherwise than 3.1 does: the JAX package's
training pipeline (that loader first) and its read_img (PIL) disagree on
such a file. The port follows PIL, on every path."""

import hashlib
import io
import json
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from _jax_loader import jax_native_loader
from _jpeg_writer import drop_scans, write_jpeg, write_jpeg_arith, write_jpeg_lossless
from _tiff_writer import jpeg_chunks, write_tiff
from simplesr_tpu.data.pipeline import _read_img_u8 as jax_read_img_u8
from simplesr_tpu.data.pipeline import read_img as jax_read_img
from simplesr_tpu_torch.data import DataPipeline
from simplesr_tpu_torch.data.image import decode_image, read_img, read_rgb_u8
from simplesr_tpu_torch.data.native_loader import NativeLoader
from simplesr_tpu_torch.data.png import decode_png, encode_png
from simplesr_tpu_torch.tools import http_gateway, serve
from simplesr_tpu_torch.train import save_model
from simplesr_tpu_torch.train.generator import Generator

ROOT = Path(__file__).resolve().parents[1]
MANIFEST = json.loads((ROOT / "data/corpus/image_formats/MANIFEST.json").read_text())
JPEGS = [e for e in MANIFEST["files"] if e["format"] == "jpeg" and "refused" not in e]
REFUSED_JPEGS = [e for e in MANIFEST["files"] if e["format"] == "jpeg" and "refused" in e]
GALLERY = np.asarray(Image.open(ROOT / "data/corpus/gallery/gt_1.png").convert("RGB"))
# libjpeg's jpeg_simple_progression for three components
SIMPLE = [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
          ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1), ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
          ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)]
SAMPLINGS = [[(1, 1)] * 3, [(2, 2), (1, 1), (1, 1)], [(2, 1), (1, 1), (1, 1)],
             [(1, 2), (1, 1), (1, 1)], [(3, 1), (1, 2), (1, 1)], [(4, 1), (1, 1), (1, 1)]]


def _pil(data):
    """PIL's decode: the JAX daemon's and gateway's decode of a body."""
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), np.uint8)


def _digest(a):
    return hashlib.sha256(np.ascontiguousarray(a, np.uint8).tobytes()).hexdigest()


def _crop(rng, h, w):
    top = int(rng.integers(0, GALLERY.shape[0] - h))
    left = int(rng.integers(0, GALLERY.shape[1] - w))
    noise = rng.integers(-25, 26, (h, w, 3))
    crop = GALLERY[top:top + h, left:left + w].astype(int) + noise
    return np.clip(crop, 0, 255).astype(np.uint8)


def _planes(rgb, mode="YCbCr"):
    img = np.asarray(Image.fromarray(rgb).convert(mode))
    return [img[:, :, i] for i in range(img.shape[2])] if img.ndim == 3 else [img]


@pytest.fixture(scope="module")
def jax_loader():
    return jax_native_loader()


@pytest.mark.parametrize("entry", JPEGS, ids=lambda e: Path(e["file"]).name)
def test_committed_jpeg_variants_read_as_the_jax_paths(entry, jax_loader):
    path = ROOT / entry["file"]
    data = path.read_bytes()
    want = jax_read_img_u8(str(path))
    assert _digest(want) == entry["sha256_pil_rgb"]
    np.testing.assert_array_equal(read_rgb_u8(path), want)
    np.testing.assert_array_equal(read_img(path), jax_read_img(str(path)))
    np.testing.assert_array_equal(serve.decode_image(data), _pil(data))
    assert _digest(NativeLoader(1).load_image_u8(path)) == entry["sha256_pil_rgb"]
    try:
        native = jax_loader.load_image_u8(str(path))
    except IOError:  # libjpeg-turbo 2.1 has no lossless decoder
        assert entry["params"].get("process") == "lossless", entry["file"]
        return
    smoothed_huffman = "drop_scans" in entry["writer"]
    assert (_digest(native) == entry["sha256_pil_rgb"]) != smoothed_huffman, entry["file"]


def test_the_jpeg_fixtures_cover_the_processes():
    params = [e["params"] for e in JPEGS]
    assert {p["predictor"] for p in params if p.get("process") == "lossless"} == set(range(1, 8))
    lossless = [p for p in params if p.get("process") == "lossless"]
    assert any(p.get("point_transform") for p in lossless)
    assert any(p.get("restart_interval") for p in lossless)
    assert any(p.get("scans") for p in lossless) and any(p.get("sampling") for p in lossless)
    arith = [p for p in params if p.get("coder") == "arithmetic"]
    assert any(p.get("dac") for p in arith) and any(p.get("restart_interval") for p in arith)
    assert any("scans" in p for p in arith) and any("scans" not in p for p in arith)
    assert any(p.get("scans_kept") == [0] for p in params)  # DC only: libjpeg's DC interpolation
    assert {e["refused"] for e in REFUSED_JPEGS} >= {"12-bit", "hierarchical",
                                                     "lossless arithmetic-coded"}


@pytest.mark.parametrize("entry", REFUSED_JPEGS, ids=lambda e: Path(e["file"]).name)
def test_refused_jpeg_processes_are_refused_by_pil_too(entry):
    data = (ROOT / entry["file"]).read_bytes()
    with pytest.raises(OSError):  # PIL's UnidentifiedImageError is an OSError too
        _pil(data)
    with pytest.raises(ValueError, match=f"{entry['refused']}.*ROADMAP.md, Queue 1, item 3"
                       if entry["refused"] != "lossless file in YCbCr" else entry["refused"]):
        decode_image(data)


@pytest.mark.parametrize("sof", [0xC5, 0xC6, 0xC7, 0xCB, 0xCD, 0xCE, 0xCF])
def test_hierarchical_and_lossless_arithmetic_frames_are_refused_as_pil_refuses_them(sof):
    data = bytearray(write_jpeg(_planes(GALLERY[:16, :16]), [(1, 1)] * 3))
    data[data.index(b"\xff\xc0") + 1] = sof
    with pytest.raises(OSError):
        _pil(bytes(data))
    with pytest.raises(ValueError, match=r"SOF\d+\) is not decoded: libjpeg refuses it"):
        decode_image(bytes(data))


# ------------------------------------------------------- seeded files

@pytest.mark.parametrize("seed", range(4))
def test_seeded_arithmetic_files_match_pil(seed):
    rng = np.random.default_rng(100 + seed)
    for _ in range(6):
        img = _crop(rng, int(rng.integers(1, 50)), int(rng.integers(1, 50)))
        sampling = SAMPLINGS[int(rng.integers(0, len(SAMPLINGS)))]
        scans = [None, SIMPLE, [((0, 1, 2), 0, 0, 0, 0), ((0,), 1, 63, 0, 0), ((1,), 1, 63, 0, 0),
                                ((2,), 1, 63, 0, 0)]][int(rng.integers(0, 3))]
        dac = [(0, int(rng.integers(0, 4)) | (int(rng.integers(4, 8)) << 4)),
               (16, int(rng.integers(1, 64))), (17, int(rng.integers(1, 64)))]
        data = write_jpeg_arith(_planes(img), sampling, int(rng.integers(1, 16)),
                                restart_interval=int(rng.integers(0, 4)), scans=scans,
                                dac=dac if rng.random() < 0.5 else ())
        np.testing.assert_array_equal(decode_image(data), _pil(data))


@pytest.mark.parametrize("seed", range(4))
def test_seeded_lossless_files_match_pil(seed):
    rng = np.random.default_rng(200 + seed)
    for _ in range(6):
        h, w = int(rng.integers(1, 40)), int(rng.integers(1, 40))
        img = _crop(rng, h, w)
        sampling = SAMPLINGS[int(rng.integers(0, len(SAMPLINGS)))]
        separate = bool(rng.integers(0, 2))
        maxh = max(s[0] for s in sampling)
        per_row = [-(-w * s[0] // maxh) for s in sampling] if separate else [-(-w // maxh)]
        restart = int(np.lcm.reduce(per_row)) * int(rng.integers(0, 3))
        if rng.random() < 0.25:
            planes, sampling = [img[:, :, 1]], [(1, 1)]
            restart = w * int(rng.integers(0, 3))
        else:
            planes = _planes(img, "RGB")
        data = write_jpeg_lossless(planes, int(rng.integers(1, 8)), pt=int(rng.integers(0, 4)),
                                   restart_interval=restart, sampling=sampling, marker=None,
                                   separate_scans=separate and len(planes) > 1)
        np.testing.assert_array_equal(decode_image(data), _pil(data))


@pytest.mark.parametrize("seed", range(3))
def test_seeded_smoothed_progressive_files_match_pil(seed):
    """Huffman-coded progressive files cut after a scan, and arithmetic ones
    whose script leaves some of coefficients 1-9 unsent or unrefined."""
    rng = np.random.default_rng(300 + seed)
    for _ in range(5):
        img = _crop(rng, int(rng.integers(1, 60)), int(rng.integers(1, 60)))
        full = io.BytesIO()
        Image.fromarray(img).save(full, "JPEG", quality=int(rng.integers(20, 95)),
                                  progressive=True, subsampling=int(rng.integers(0, 3)))
        scans = full.getvalue().count(b"\xff\xda")
        data = drop_scans(full.getvalue(), set(range(int(rng.integers(1, scans)))))
        np.testing.assert_array_equal(decode_image(data), _pil(data))
        keep = [sc for k, sc in enumerate(SIMPLE) if k < 6 or rng.random() < 0.5]
        data = write_jpeg_arith(_planes(img), SAMPLINGS[int(rng.integers(0, 4))],
                                int(rng.integers(1, 12)), scans=keep)
        np.testing.assert_array_equal(decode_image(data), _pil(data))


def test_lossless_files_libjpeg_will_not_convert_are_refused():
    """libjpeg-turbo converts no colours in lossless mode: a JFIF or Adobe
    YCbCr file is refused, as are a restart interval that is not a whole
    number of MCU rows and scans that leave a component out."""
    img = GALLERY[:9, :11]
    for marker in ("jfif", "adobe1"):
        data = write_jpeg_lossless(_planes(img), 1, marker=marker)
        with pytest.raises(OSError):
            _pil(data)
        with pytest.raises(ValueError, match="lossless file in YCbCr"):
            decode_image(data)
    data = write_jpeg_lossless(_planes(img, "RGB"), 1, restart_interval=5, marker=None)
    with pytest.raises(OSError):
        _pil(data)
    with pytest.raises(ValueError, match="whole number of MCU rows"):
        decode_image(data)
    data = drop_scans(write_jpeg_lossless(_planes(img, "RGB"), 2, marker=None,
                                          separate_scans=True), {0, 2})
    with pytest.raises(OSError):
        _pil(data)
    with pytest.raises(ValueError, match="leave a component out"):
        decode_image(data)


def test_sequential_scans_with_progressive_parameters_are_refused():
    """libjpeg only warns of a sequential scan whose Ss, Se, Ah or Al are not
    0, 63, 0, 0 (JWRN_NOT_SEQUENTIAL); the port refuses it by name."""
    for writer in (write_jpeg, write_jpeg_arith):
        data = bytearray(writer(_planes(GALLERY[:16, :16]), [(1, 1)] * 3))
        sos = data.index(b"\xff\xda")
        data[sos + 2 + 2 + 1 + 2 * 3 + 1] = 62  # Se
        with pytest.raises(ValueError, match="sequential scan"):
            decode_image(bytes(data))


def test_jpeg_tiff_segments_of_the_other_processes_match_pil():
    """libtiff hands each strip to libjpeg whatever its process: arithmetic
    and lossless segments decode as PIL decodes them, and a lossless YCbCr
    segment is refused as libjpeg refuses to convert it."""
    img = GALLERY[40:77, 90:135]
    ycc = np.asarray(Image.fromarray(img).convert("YCbCr"))

    def lossless(planes, sampling, **kw):
        return write_jpeg_lossless(planes, 6, marker=None, **kw)

    for samples, photometric, writer, sampling in (
            (img, 2, lossless, [(1, 1)] * 3), (ycc, 6, write_jpeg_arith, [(2, 1), (1, 1), (1, 1)]),
            (img[:, :, 1], 1, lossless, [(1, 1)])):
        chunks, tables = jpeg_chunks(samples, sampling, rows_per_strip=16, write=writer)
        extra = {"ycbcr_subsampling": sampling[0]} if photometric == 6 else {}
        data = write_tiff(samples, photometric, 8, 7, rows_per_strip=16, chunks=chunks,
                          extra_tags=[(347, 7, tables)], **extra)
        np.testing.assert_array_equal(decode_image(data), _pil(data))
    chunks, tables = jpeg_chunks(ycc, [(1, 1)] * 3, rows_per_strip=16, write=lossless)
    data = write_tiff(ycc, 6, 8, 7, rows_per_strip=16, chunks=chunks, ycbcr_subsampling=(1, 1),
                      extra_tags=[(347, 7, tables)])
    with pytest.raises(OSError):
        _pil(data)
    with pytest.raises(ValueError, match="lossless file in YCbCr"):
        decode_image(data)


# ----------------------------------------------------------- entry points

def _variant_bodies():
    img = GALLERY[60:100, 80:132]
    ycc = np.asarray(Image.fromarray(img).convert("YCbCr"))
    chunks, tables = jpeg_chunks(ycc, [(2, 2), (1, 1), (1, 1)], rows_per_strip=16)
    return {
        "arithmetic.jpg": write_jpeg_arith(_planes(img), [(2, 2), (1, 1), (1, 1)], scans=SIMPLE),
        "lossless.jpg": write_jpeg_lossless(_planes(img, "RGB"), 4, marker=None),
        "jpeg.tif": write_tiff(ycc, 6, 8, 7, rows_per_strip=16, chunks=chunks,
                               ycbcr_subsampling=(2, 2), extra_tags=[(347, 7, tables)]),
        "ycbcr.tif": write_tiff(ycc, 6, 8, "lzw", ycbcr_subsampling=(2, 1), rows_per_strip=8),
    }


def test_a_training_folder_of_jpeg_variants_reads_as_the_jax_pipeline(tmp_path):
    for name, data in _variant_bodies().items():
        (tmp_path / name).write_bytes(data)
    pipe = DataPipeline(hr_img_path=str(tmp_path), scale=2, train_val_split=0.25, batch_size=2,
                        crop_size=(16, 16, 3), num_crops=1, random_seed=1, device="cpu")
    listed = sorted(pipe.train_imgs + pipe.val_imgs)
    assert len(listed) == 4
    for path in listed:
        np.testing.assert_array_equal(pipe._decoded(path), jax_read_img_u8(path), err_msg=path)
        assert pipe._image_hw(path) == (40, 52)


def test_the_gateway_answers_jpeg_variants_as_the_png_of_their_pixels(tmp_path):
    gen = Generator.srresnet(2, num_blocks=1, num_filters=8, batch_norm=False,
                             dtype="float32", seed=3, device="cpu")
    model = str(tmp_path / "tiny.msgpack")
    save_model(gen.module_config(), gen.variables, model)
    bodies = _variant_bodies()
    ready, stop, box = threading.Event(), threading.Event(), {}
    thread = threading.Thread(target=http_gateway.serve_http, args=(model, 2, 0), daemon=True,
                              kwargs=dict(ready_event=ready, stop_event=stop, device="cpu",
                                          on_server=lambda s: box.update(s=s)))
    thread.start()
    assert ready.wait(60)
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    url = f"http://127.0.0.1:{box['s'].server_address[1]}/upscale"

    def ask(body):
        with opener.open(urllib.request.Request(url, data=body), timeout=60) as r:
            assert r.status == 200
            return decode_png(r.read())

    try:
        for name, body in bodies.items():
            pixels = _pil(body)
            np.testing.assert_array_equal(ask(body), ask(encode_png(pixels)), err_msg=name)
    finally:
        stop.set()
        thread.join(timeout=30)
