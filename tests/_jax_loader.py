"""The JAX package's native loader for the port's image-input tests, its
library built once across xdist workers. The JAX class compiles in place
from each process that finds the library missing, and a second process can
load a half-written file; here the first test to ask builds it under a file
lock into a temporary file renamed into place, with the JAX class's own
command (simplesr_tpu/data/native_loader.py: _build_library)."""

import fcntl
import os
import subprocess
import tempfile

from simplesr_tpu.data import native_loader as jax_native


def jax_native_loader(num_threads=0):
    so, src = jax_native._SO, jax_native._SRC
    with open(os.path.join(tempfile.gettempdir(), "ssr_jax_loader.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
            tmp = f"{so}.{os.getpid()}.tmp"
            subprocess.run(["g++", "-O3", "-fPIC", "-shared", "-std=c++17", src, "-o", tmp,
                            "-lpng", "-ljpeg", "-lpthread"], check=True, capture_output=True)
            os.replace(tmp, so)
        return jax_native.NativeLoader(num_threads)
