"""The port's NativeLoader (``data/native_loader.py`` over
``csrc/host/loader.cpp``) against the JAX package's, on PNG and JPEG: sizes,
both dtypes, crops, the failures (a missing file, a crop outside the image)
and the cache's eviction; the build; and the port's DataPipeline against the
JAX one on the gallery's JPEG copy, with naive and diversity crops, through
the native loader and around it, with test_torch_pipeline.py's bounds (HR
bit-equal, LR within 1e-5)."""

import os
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from _jax_loader import jax_native_loader
from simplesr_tpu.data import DataPipeline as JaxDataPipeline
from simplesr_tpu_torch.data import DataPipeline
from simplesr_tpu_torch.data import native_loader
from simplesr_tpu_torch.data.native_loader import ImageDecodeError, NativeLoader

ROOT = Path(__file__).resolve().parents[1]
JPEGS = sorted(str(p) for p in (ROOT / "data/corpus/gallery_jpeg").glob("*.jpg"))
PNGS = sorted(str(p) for p in (ROOT / "data/corpus/gallery").glob("*.png"))
FILES = JPEGS[:3] + PNGS[:2] + [str(ROOT / "data/corpus/image_modes/png_c3_d4_adam7.png")]
LR_TOL = 1e-5


@pytest.fixture(scope="module")
def loaders():
    return NativeLoader(num_threads=3), jax_native_loader(num_threads=3)


@pytest.mark.parametrize("path", FILES, ids=os.path.basename)
def test_whole_images_match_the_jax_loader(loaders, path):
    own, ref = loaders
    assert own.image_size(path) == ref.image_size(path)
    for name in ("load_image", "load_image_u8"):
        got, want = getattr(own, name)(path), getattr(ref, name)(path)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_crops_match_the_jax_loader(loaders, dtype):
    own, ref = loaders
    rng = np.random.default_rng(0)
    paths = [FILES[i % len(FILES)] for i in range(23)]
    sizes = [own.image_size(p) for p in paths]
    tops = [int(rng.integers(0, h - 17 + 1)) for h, _ in sizes]
    lefts = [int(rng.integers(0, w - 21 + 1)) for _, w in sizes]
    got = own.load_crops(paths, tops, lefts, 17, 21, dtype=dtype)
    want = ref.load_crops(paths, tops, lefts, 17, 21, dtype=dtype)
    assert got.dtype == want.dtype == dtype and got.shape == (23, 17, 21, 3)
    np.testing.assert_array_equal(got, want)
    for i in (0, 4, 22):  # crops are slices of the whole image
        whole = own.load_image_u8(paths[i])
        np.testing.assert_array_equal(
            got[i], whole[tops[i]:tops[i] + 17, lefts[i]:lefts[i] + 21].astype(dtype))


def test_failures_raise_as_the_jax_loader_does(loaders, tmp_path):
    own, ref = loaders
    missing = str(tmp_path / "missing.png")
    for loader in loaders:
        with pytest.raises(IOError):
            loader.image_size(missing)
        with pytest.raises(IOError):
            loader.load_crops([FILES[0]], [10_000], [0], 8, 8)
    with pytest.raises(FileNotFoundError):
        own.load_image_u8(missing)
    with pytest.raises(IOError, match="lies outside"):
        own.load_crops([FILES[0], FILES[1]], [0, 0], [0, 10_000], 8, 8, dtype=np.uint8)
    text = tmp_path / "notes.png"
    text.write_text("not an image")
    with pytest.raises(ImageDecodeError, match="not a PNG, JPEG, WebP, GIF or TIFF") as info:
        own.load_image(str(text))
    assert isinstance(info.value, ValueError) and isinstance(info.value, OSError)


def test_cache_evicts_past_its_bytes():
    sizes = {p: np.prod(NativeLoader(1).image_size(p)) * 3 for p in JPEGS[:4]}
    budget = int(sizes[JPEGS[0]] + sizes[JPEGS[1]])
    loader = NativeLoader(num_threads=2, cache_bytes=budget)
    for p in JPEGS[:4]:
        loader.load_image_u8(p)
        assert loader.cached_images() <= 2
    assert loader.cached_images() >= 1
    # evicted images decode again, the same
    np.testing.assert_array_equal(loader.load_image_u8(JPEGS[0]),
                                  jax_native_loader(1).load_image_u8(JPEGS[0]))


def test_threads_share_a_small_cache(loaders):
    """More Python threads than cores, each through the GIL-free calls, on a
    cache smaller than the images they read: every result equals its own
    decode."""
    own, ref = loaders
    want = {p: ref.load_image_u8(p) for p in JPEGS[:6]}
    budget = int(2.5 * max(a.nbytes for a in want.values()))
    shared = NativeLoader(num_threads=2, cache_bytes=budget)
    errors = []

    def work(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(12):
                p = JPEGS[int(rng.integers(0, 6))]
                if rng.integers(0, 2):
                    np.testing.assert_array_equal(shared.load_image_u8(p), want[p])
                else:
                    crop = shared.load_crops([p, p], [1, 3], [2, 5], 9, 11, dtype=np.uint8)
                    np.testing.assert_array_equal(crop[1], want[p][3:12, 5:16])
        except Exception as e:  # reported below
            errors.append(repr(e))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(3 * os.cpu_count())]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads) and not errors, errors[:3]
    assert sum(a.nbytes for a in want.values()) > budget
    assert shared.cached_images() < len(want)  # some were evicted
    with pytest.raises(ValueError, match="one top and one left"):
        shared.load_crops(JPEGS[:2], [0], [0, 0], 8, 8)


def test_load_crops_returns_only_when_every_task_is_done():
    """Many small batches of cached crops from several callers at once: each
    call waits for its own tasks, which finish in microseconds, and frees
    nothing that a pool thread still holds."""
    loader = NativeLoader(num_threads=4)
    paths = JPEGS[:2]
    wholes = [loader.load_image_u8(p) for p in paths]  # cached from here on
    errors = []

    def caller(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(1500):
                n = int(rng.integers(1, 3))
                which = rng.integers(0, 2, size=n)
                tops = [int(rng.integers(0, wholes[i].shape[0] - 8)) for i in which]
                lefts = [int(rng.integers(0, wholes[i].shape[1] - 8)) for i in which]
                got = loader.load_crops([paths[i] for i in which], tops, lefts, 8, 8,
                                        dtype=np.uint8)
                for k, i in enumerate(which):
                    want = wholes[i][tops[k]:tops[k] + 8, lefts[k]:lefts[k] + 8]
                    if not np.array_equal(got[k], want):
                        raise AssertionError(f"crop {k} of a batch of {n} differs")
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=caller, args=(seed,)) for seed in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors[:3]


def test_build_is_keyed_by_source_and_flags(tmp_path, monkeypatch):
    path = native_loader.library_path()
    assert path.parent == native_loader.BUILD_DIR and path.exists()
    monkeypatch.setattr(native_loader, "CXX_FLAGS", native_loader.CXX_FLAGS + ("-g0",))
    assert native_loader.library_path() != path
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native_loader.build()


def test_build_is_keyed_by_compiler(tmp_path, monkeypatch):
    path = native_loader.library_path()
    monkeypatch.setattr(native_loader, "compiler_version", lambda: "g++ (other) 99.0")
    assert native_loader.library_path() != path
    monkeypatch.undo()
    other = tmp_path / "bin"
    other.mkdir()
    (other / "g++").symlink_to(native_loader.find_cxx())
    monkeypatch.setenv("CXX", str(other / "g++"))
    assert native_loader.library_path() != path


def _compare(ref_batches, got_batches):
    assert len(ref_batches) == len(got_batches) > 0
    for (rl, rh), (gl, gh) in zip(ref_batches, got_batches):
        np.testing.assert_array_equal(gh.numpy(), np.asarray(rh))
        diff = np.abs(gl.numpy() - np.asarray(rl))
        assert gl.shape == rl.shape and diff.max() <= LR_TOL, diff.max()


@pytest.mark.parametrize("naive", [True, False])
@pytest.mark.parametrize("use_native", [True, False])
def test_jpeg_gallery_batches_match_jax(naive, use_native):
    base = dict(hr_img_path=str(ROOT / "data/corpus/gallery_jpeg"), scale=4,
                train_val_split=0.25, batch_size=6, augmentations=["flip_along_x"],
                crop_size=(24, 24, 3), num_crops=2, random_seed=11, crop_naive=naive,
                minimum_variation_patch=30.0, device_resident=False, num_workers=2)
    jax_native_loader(1)  # the JAX pipeline's loader, built before it asks
    ref = JaxDataPipeline(use_native=use_native, **base)
    got = DataPipeline(use_native=use_native, device="cpu", **base)
    assert (got._native is not None) == use_native
    assert got.train_imgs == ref.train_imgs and got.val_imgs == ref.val_imgs
    _compare(list(ref.train_batch_generator()), list(got.train_batch_generator()))
    _compare(list(ref.validation_batch_generator()), list(got.validation_batch_generator()))


@pytest.mark.parametrize("use_native", [True, False])
def test_jpeg_test_images_match_jax(use_native):
    """The evaluation and inference path: test images from JPEG files."""
    base = dict(hr_img_path=None, scale=4, test_img_paths=[JPEGS[5], JPEGS[9], JPEGS[12]])
    jax_native_loader(1)
    ref = JaxDataPipeline(use_native=use_native, **base)
    got = DataPipeline(use_native=use_native, device="cpu", **base)
    pairs = list(zip(ref.test_batch_generator(2), got.test_batch_generator(2)))
    assert len(pairs) == 3
    for (rx, rp), (gx, gp) in pairs:
        assert rp == gp
        np.testing.assert_array_equal(gx.numpy(), np.asarray(rx))
