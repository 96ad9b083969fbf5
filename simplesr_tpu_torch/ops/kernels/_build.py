"""Builds and loads the package's CUDA kernels.

At first use, every ``simplesr_tpu_torch/csrc/*.cu`` is compiled by one
``nvcc`` call into one shared library with a plain C interface, which is
loaded with ``ctypes``. No PyTorch header is compiled, so the build takes
seconds and needs no ``ninja``. The library's name is a hash of the sources
and the flags, under ``simplesr_tpu_torch/_build/`` (listed in
``.gitignore``); a later process reuses it. A failed build raises: there is
no fallback.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parents[2]
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "_build"
NVCC_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-shared",
              "-Xcompiler", "-fPIC", "-lineinfo")
BUILD_TIMEOUT_S = 600

_lock = threading.Lock()
_library = None
_functions = {}


def find_nvcc():
    """``nvcc`` from ``CUDA_HOME``, then ``PATH``, then ``/usr/local/cuda``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for path in candidates:
        if path.is_file() and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the CUDA kernels are built from source at first use")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path():
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"simplesr_kernels_{digest.hexdigest()[:16]}.so"


def build():
    """Compile the sources if their library is missing; return its path."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    cmd = [str(find_nvcc()), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc did not finish in {BUILD_TIMEOUT_S} s") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def library():
    """The loaded kernel library, built first if needed."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            lib.ssr_error_string.argtypes = [ctypes.c_int]
            lib.ssr_error_string.restype = ctypes.c_char_p
            _library = lib
        return _library


def function(name, argtypes):
    """A C launcher of the library, typed: every launcher returns a CUDA
    error code (0 on success). Typed once per process: a launch then pays
    a dictionary lookup, not the lock and the symbol lookup."""
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn


ATTRIBUTE_KEYS = ("registers", "local_bytes", "static_shared_bytes", "dynamic_shared_bytes",
                  "threads")


def kernel_attributes(name, *args):
    """A kernel's resources as its library function ``name`` reads them
    with ``cudaFuncGetAttributes``: registers per thread, local (spill)
    bytes per thread, static and dynamic shared bytes, threads per block."""
    out = (ctypes.c_int * len(ATTRIBUTE_KEYS))()
    fn = function(name, [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)])
    check(fn(*args, out), name)
    return dict(zip(ATTRIBUTE_KEYS, out))


def check(code, what):
    """Raise on a non-zero error code returned by a launcher (a CUDA error,
    or one of the library's own negative codes)."""
    if code != 0:
        message = library().ssr_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({message})")
