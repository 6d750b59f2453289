"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``isochrones_torch/csrc/*.cu`` for Hopper (``sm_90a``)
into one shared library with a plain C interface, at first use, into
``isochrones_torch/_build/`` (git-ignored), cached by a hash of the sources
and flags. The library is loaded with ``ctypes``; callers pass every pointer
and the CUDA stream as ``c_void_p``.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

__all__ = ["find_nvcc", "build", "load_library"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, then ``nvcc`` on PATH, then
    ``/usr/local/cuda/bin/nvcc``; raises if none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(f"nvcc not found (tried {candidates}); the CUDA kernels cannot be built")


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def build():
    """Compile the sources unless a library for their hash exists. Returns
    ``(path, seconds, compiler_log)``; seconds is 0.0 on a cache hit."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    path = os.path.join(BUILD_DIR, f"libisochrones_torch_{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, *srcs], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path, time.perf_counter() - t0, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    path, _, _ = build()
    return ctypes.CDLL(path)
