"""ctypes bindings for the port's host image loader (``csrc/host/loader.cpp``),
as simplesr_tpu.data.native_loader binds the JAX package's.

The library is built at first use with ``g++`` (``$CXX``, else ``g++`` on
``PATH``) from ``loader.cpp``, the JPEG encoder ``jpeg_encode.cpp`` and the
decoders of the other formats (``webp.cpp``, ``gif.cpp``, ``tiff.cpp``,
``dds.cpp``, ``psd.cpp``, ``tga.cpp``, ``qoi.cpp``, ``pcx.cpp``, ``sgi.cpp``,
with their header ``formats.h``), and linked against zlib; nothing of CUDA or
PyTorch is compiled. Each source compiles in a process of its own, all at
once, before one link. It lives under the git-ignored
``simplesr_tpu_torch/_build/``, named by a hash of every source and header,
the flags and the compiler (its path and version), and is written to a
temporary file that is renamed into place, so that several processes can
build it at once. A failed build raises with the compiler's output: there
is no fallback.

ctypes releases the GIL for the length of each call, so the pipeline's
worker threads decode in parallel, as the loader's own thread pool does for
``load_crops``.

``NativeLoader`` keeps the JAX class's interface (``image_size``,
``load_image``, ``load_image_u8``, ``load_crops``) and its cache: decoded
images by path, least recently used first out past ``cache_bytes``. It
decodes 16-bit grey as the JAX loader does (the high byte). A file the
decoders refuse raises ``ImageDecodeError``, both the ``OSError`` of the JAX
class and a ``ValueError``, with the decoder's reason (which names the
format); a missing file raises ``FileNotFoundError``. The library reads
PNG, JPEG, WebP, GIF, TIFF, DDS, TGA, QOI, PCX, DCX and SGI; BMP, netpbm,
ICO and CUR decode in numpy (``data/image.py``). ``decode_bytes`` decodes bytes in memory, as the
serving daemon and gateway take them.

``encode_jpeg`` writes the bytes that Pillow 12.1 over libjpeg-turbo 3.1.3
writes for ``Image.fromarray(u8).save(buf, "JPEG", quality=q)`` (baseline,
4:2:0, ISLOW, the standard tables), and ``libjpeg_degrade`` is its round
trip through ``decode_bytes``: the JPEG noise of the JAX package's campaign
(scripts/jpg_noise_campaign.py: libjpeg_degrade_01), which reaches it
through PIL.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

_PACKAGE = Path(__file__).resolve().parents[1]
_HOST = _PACKAGE / "csrc" / "host"
SOURCE = _HOST / "loader.cpp"
ENCODER_SOURCE = _HOST / "jpeg_encode.cpp"
SOURCES = (SOURCE, ENCODER_SOURCE) + tuple(
    _HOST / f"{name}.cpp" for name in ("webp", "gif", "tiff", "dds", "psd", "tga", "qoi", "pcx",
                                       "sgi"))
HEADERS = (_HOST / "formats.h",)
BUILD_DIR = _PACKAGE / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")
LIBS = ("-lz",)
BUILD_TIMEOUT_S = 300
GREY16 = {"loader": 0, "pil": 1}

_lock = threading.Lock()
_singleton_lock = threading.Lock()
_library = None
_singleton = None

_u8p = ctypes.POINTER(ctypes.c_uint8)
_intp = ctypes.POINTER(ctypes.c_int)


def find_cxx():
    """The C++ compiler: ``$CXX``, then ``g++`` on ``PATH``."""
    for candidate in (os.environ.get("CXX"), shutil.which("g++")):
        if candidate:
            path = shutil.which(candidate) or candidate
            if os.path.isfile(path) and os.access(path, os.X_OK):
                return path
    raise RuntimeError("no C++ compiler found ($CXX, then g++ on PATH); the host image "
                       "loader is built from source at first use")


def library_path():
    """Where the library for the current sources, flags and compiler lives."""
    key = (find_cxx(), compiler_version()) + CXX_FLAGS + LIBS
    digest = hashlib.sha256(" ".join(key).encode())
    for source in SOURCES + HEADERS:
        digest.update(source.read_bytes())
    return BUILD_DIR / f"ssr_host_loader_{digest.hexdigest()[:16]}.so"


def compiler_version():
    """The first line of the compiler's ``--version``."""
    out = subprocess.run([find_cxx(), "--version"], capture_output=True, text=True, timeout=60)
    return (out.stdout.splitlines() or ["unknown"])[0]


def build():
    """Compile the sources if their library is missing; return its path.
    Each source compiles in a compiler process of its own, all at once;
    then one link."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = path.with_name(f"{path.stem}.{os.getpid()}.{threading.get_ident()}")
    objects = [stem.with_name(f"{stem.name}.{source.stem}.o") for source in SOURCES]
    tmp = stem.with_name(f"{stem.name}.tmp.so")
    cxx = find_cxx()
    compile_flags = [f for f in CXX_FLAGS if f != "-shared"]
    steps = [[[cxx, *compile_flags, "-c", str(s), "-o", str(o)] for s, o in zip(SOURCES, objects)],
             [[cxx, *CXX_FLAGS, *map(str, objects), "-o", str(tmp), *LIBS]]]
    deadline = time.monotonic() + BUILD_TIMEOUT_S
    try:
        for commands in steps:
            procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True) for c in commands]
            try:
                outputs = [p.communicate(timeout=max(deadline - time.monotonic(), 0))[0]
                           for p in procs]
            except subprocess.TimeoutExpired as e:
                raise RuntimeError(f"the host loader's build did not finish in "
                                   f"{BUILD_TIMEOUT_S} s") from e
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            for cmd, p, out in zip(commands, procs, outputs):
                if p.returncode != 0:
                    raise RuntimeError(f"the host loader's build failed ({p.returncode}):\n"
                                       f"{' '.join(cmd)}\n{out}")
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
        for o in objects:
            o.unlink(missing_ok=True)
    return path


def _bind(lib):
    crops = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), _intp, _intp, ctypes.c_int,
             ctypes.c_int, ctypes.c_int]
    signatures = {
        "ssr_create_loader": (ctypes.c_void_p, [ctypes.c_int, ctypes.c_size_t]),
        "ssr_destroy_loader": (None, [ctypes.c_void_p]),
        "ssr_image_size": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_char_p, _intp, _intp]),
        "ssr_load_image": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_char_p,
                                          ctypes.POINTER(ctypes.c_float)]),
        "ssr_load_image_u8": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_char_p, _u8p]),
        "ssr_load_crops": (ctypes.c_int, crops + [ctypes.POINTER(ctypes.c_float)]),
        "ssr_load_crops_u8": (ctypes.c_int, crops + [_u8p]),
        "ssr_cached_images": (ctypes.c_size_t, [ctypes.c_void_p]),
        "ssr_last_error": (ctypes.c_char_p, []),
        "ssr_decode_image": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                                            _intp, _intp, ctypes.POINTER(_u8p)]),
        "ssr_image_kind": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_size_t]),
        "ssr_free": (None, [_u8p]),
        "ssr_encode_jpeg": (ctypes.c_int, [_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                           ctypes.POINTER(_u8p),
                                           ctypes.POINTER(ctypes.c_size_t)]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def library():
    """The loaded library, built first if needed."""
    global _library
    with _lock:
        if _library is None:
            _library = _bind(ctypes.CDLL(str(build())))
        return _library


class ImageDecodeError(OSError, ValueError):
    """An image file the decoders refuse."""


def _last_error(lib):
    return lib.ssr_last_error().decode("utf-8", "replace")


# ssr_image_kind's numbers (loader.cpp's Kind)
NATIVE_KINDS = (None, "png", "jpeg", "webp", "gif", "tiff", "pcx", "dcx", "dds", "qoi", "sgi",
                "tga", "psd")


def native_kind(data):
    """The kind the library reads ``data`` as, in PIL's order of plugins
    (TGA, which has no magic, last), or None."""
    data = bytes(data)
    return NATIVE_KINDS[library().ssr_image_kind(data, len(data))]


def decode_bytes(data, name="image", grey16="pil"):
    """PNG, JPEG, WebP, GIF, TIFF, PCX, DCX, DDS, PSD, QOI, SGI or TGA bytes ->
    uint8 RGB (H, W, 3). A body the decoders refuse raises ``ValueError``
    naming ``name`` and the reason."""
    lib = library()
    h, w, out = ctypes.c_int(), ctypes.c_int(), _u8p()
    data = bytes(data)
    if lib.ssr_decode_image(data, len(data), GREY16[grey16], ctypes.byref(h), ctypes.byref(w),
                            ctypes.byref(out)):
        raise ValueError(f"{name}: {_last_error(lib)}")
    try:
        return np.ctypeslib.as_array(out, (h.value, w.value, 3)).copy()
    finally:
        lib.ssr_free(out)


JPEG_MAX_DIMENSION = 65500  # libjpeg's


def encode_jpeg(rgb_u8, quality):
    """uint8 RGB (H, W, 3) -> the JPEG bytes Pillow writes at ``quality``
    (an integer 0-100; 0 encodes as 1, as in libjpeg). Any other input is
    refused with ``ValueError`` naming it: grey, RGBA or other channel
    counts, a dtype other than uint8, an empty or oversized image, a
    quality out of range."""
    a = np.asarray(rgb_u8)
    if a.dtype != np.uint8:
        raise ValueError(f"encode_jpeg takes RGB uint8; got dtype {a.dtype}")
    if a.ndim != 3 or a.shape[2] != 3:
        mode = {2: "grey (H, W)"}.get(a.ndim) or \
            (f"{a.shape[2]} channels" if a.ndim == 3 else f"{a.ndim} dimensions")
        raise ValueError(f"encode_jpeg takes RGB (H, W, 3); got {mode}, shape {a.shape}")
    h, w = a.shape[:2]
    if not (1 <= h <= JPEG_MAX_DIMENSION and 1 <= w <= JPEG_MAX_DIMENSION):
        raise ValueError(f"encode_jpeg: image of {w} x {h} pixels; baseline JPEG takes 1 to "
                         f"{JPEG_MAX_DIMENSION} on each side")
    if isinstance(quality, (bool, np.bool_)) or not isinstance(quality, (int, np.integer)) \
            or not 0 <= quality <= 100:
        raise ValueError(f"encode_jpeg: quality {quality!r} is out of range: it takes an "
                         f"integer 0-100")
    lib = library()
    a = np.ascontiguousarray(a)
    out, n = _u8p(), ctypes.c_size_t()
    if lib.ssr_encode_jpeg(a.ctypes.data_as(_u8p), h, w, int(quality), ctypes.byref(out),
                           ctypes.byref(n)):
        raise ValueError(_last_error(lib))
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.ssr_free(out)


def libjpeg_degrade(rgb_u8, quality):
    """uint8 RGB through ``encode_jpeg`` and back through ``decode_bytes``:
    PIL's JPEG round trip at ``quality``, pixel for pixel."""
    return decode_bytes(encode_jpeg(rgb_u8, quality), name=f"JPEG at quality {quality}")


class NativeLoader:
    """Thread-pooled decode and crop server over the C++ library."""

    def __init__(self, num_threads=0, cache_bytes=2 << 30):
        self._lib = library()
        self._handle = self._lib.ssr_create_loader(num_threads, cache_bytes)
        if not self._handle:
            raise RuntimeError("failed to create the native loader")

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.ssr_destroy_loader(handle)
            self._handle = None

    def _raise(self, path):
        if not os.path.exists(path):
            raise FileNotFoundError(f"{path}: no such file")
        raise ImageDecodeError(f"could not decode {path}: {_last_error(self._lib)}")

    def cached_images(self):
        """How many decoded images the cache holds."""
        return self._lib.ssr_cached_images(self._handle)

    def image_size(self, path):
        h, w = ctypes.c_int(), ctypes.c_int()
        if self._lib.ssr_image_size(self._handle, os.fsencode(path), ctypes.byref(h),
                                    ctypes.byref(w)):
            self._raise(path)
        return h.value, w.value

    def _load(self, path, dtype, fn, ctype):
        h, w = self.image_size(path)
        out = np.empty((h, w, 3), dtype)
        if fn(self._handle, os.fsencode(path), out.ctypes.data_as(ctypes.POINTER(ctype))):
            self._raise(path)
        return out

    def load_image(self, path):
        """The whole image as float32 [0, 255] RGB (H, W, 3)."""
        return self._load(path, np.float32, self._lib.ssr_load_image, ctypes.c_float)

    def load_image_u8(self, path):
        """The whole image as uint8 RGB (H, W, 3), copied out of the cache."""
        return self._load(path, np.uint8, self._lib.ssr_load_image_u8, ctypes.c_uint8)

    def load_crops(self, paths, tops, lefts, patch_h, patch_w, dtype=np.float32):
        """An (n, patch_h, patch_w, 3) batch of crop windows, decoded and
        sliced in parallel in C++: float32 (converted) or uint8 (row copies)."""
        n = len(paths)
        c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
        c_tops = np.ascontiguousarray(tops, np.int32)
        c_lefts = np.ascontiguousarray(lefts, np.int32)
        if c_tops.shape != (n,) or c_lefts.shape != (n,) or patch_h < 1 or patch_w < 1:
            raise ValueError(f"load_crops takes one top and one left per path and a positive "
                             f"patch, got {n} paths, tops {c_tops.shape}, lefts "
                             f"{c_lefts.shape}, patch {patch_h} x {patch_w}")
        if np.dtype(dtype) == np.uint8:
            out = np.empty((n, patch_h, patch_w, 3), np.uint8)
            fn, ctype = self._lib.ssr_load_crops_u8, ctypes.c_uint8
        else:
            out = np.empty((n, patch_h, patch_w, 3), np.float32)
            fn, ctype = self._lib.ssr_load_crops, ctypes.c_float
        failures = fn(self._handle, c_paths, c_tops.ctypes.data_as(_intp),
                      c_lefts.ctypes.data_as(_intp), n, patch_h, patch_w,
                      out.ctypes.data_as(ctypes.POINTER(ctype)))
        if failures:
            raise OSError(f"{failures}/{n} crop loads failed: {_last_error(self._lib)}")
        return out


def get_native_loader(num_threads=0, cache_bytes=2 << 30):
    """The process-wide loader. Where the JAX function returns None (no
    toolchain, no image libraries), this one raises."""
    global _singleton
    with _singleton_lock:
        if _singleton is None:
            _singleton = NativeLoader(num_threads, cache_bytes)
        return _singleton
