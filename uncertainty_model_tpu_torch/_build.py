"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into ``_build/lib<name>_<hash>.so`` (a directory git ignores) the
first time it is used, and again whenever the source or the flags change;
the library is then loaded with ``ctypes``.  Nothing here runs at import
time, so the package imports on machines without ``nvcc`` or a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def library_path(name: str) -> str:
    """Build ``csrc/<name>.cu`` if its library is missing or stale; return
    the library's path.  The compiler's output (``-Xptxas=-v`` register and
    shared-memory counts) is kept beside it as ``.log``."""
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}")
    lib = stem + ".so"
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{stem}.{os.getpid()}.tmp.so"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    with open(stem + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def build_log(name: str) -> str:
    """The compiler output of the current build of ``csrc/<name>.cu``."""
    with open(library_path(name)[:-3] + ".log") as f:
        return f.read()


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    return ctypes.CDLL(library_path(name))
