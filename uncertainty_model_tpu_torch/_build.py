"""Build and load the port's native libraries.

Each ``csrc/<name>.cu`` (a CUDA kernel) or ``csrc/<name>.cc`` (host code:
the data pipeline's PNG decode and resize) exposes a plain C interface and
is compiled, by ``nvcc`` or by ``g++`` respectively, into
``_build/lib<name>_<hash>.so`` (a directory git ignores) the first time it
is used, and again whenever the source, a shared header (``csrc/*.cuh``
for CUDA sources), the flags or, for host code, the CPU that
``-march=native`` names change; the library is then loaded with
``ctypes``.  Nothing here runs at import time, so the package imports on
machines without ``nvcc``, ``g++`` or a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# -march=native: g++ then contracts the resize's multiply-adds into FMAs, as
# it does in the JAX package's native/Makefile build, whose floats the
# port's resize matches bit for bit
HOST_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared",
              "-pthread")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _gxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found: it builds the port's host libraries")


@functools.lru_cache(maxsize=None)
def _host_target() -> bytes:
    """What ``-march=native`` resolves to on this host (g++'s target
    options: the CPU and its instruction sets), part of a host library's
    cache key so that a library built for another CPU is rebuilt rather
    than loaded."""
    proc = subprocess.run([_gxx(), "-march=native", "-Q", "--help=target"],
                          capture_output=True, text=True, check=True)
    return proc.stdout.encode()


def _toolchain(name: str):
    """(source, compiler, flags, header suffix) of ``csrc/<name>``."""
    cuda = os.path.join(CSRC, f"{name}.cu")
    if os.path.exists(cuda):
        return cuda, _nvcc, NVCC_FLAGS, ".cuh"
    return os.path.join(CSRC, f"{name}.cc"), _gxx, HOST_FLAGS, ".h"


def library_path(name: str) -> str:
    """Build ``csrc/<name>.cu`` (or ``.cc``) if its library is missing or
    stale; return the library's path.  The compiler's output (for CUDA, the
    ``-Xptxas=-v`` register and shared-memory counts) is kept beside it as
    ``.log``."""
    src, compiler, flags, suffix = _toolchain(name)
    digest = hashlib.sha256(" ".join(flags).encode())
    if compiler is _gxx:
        digest.update(_host_target())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(suffix))
    for path in [src] + [os.path.join(CSRC, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    stem = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}")
    lib = stem + ".so"
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{stem}.{os.getpid()}.{threading.get_ident()}.tmp.so"
    proc = subprocess.run([compiler(), *flags, "-o", tmp, src],
                          capture_output=True, text=True)
    with open(stem + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(compiler())} failed on "
                           f"{src}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def build_log(name: str) -> str:
    """The compiler output of the current build of ``csrc/<name>``."""
    with open(library_path(name)[:-3] + ".log") as f:
        return f.read()


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>``, built first if needed."""
    return ctypes.CDLL(library_path(name))
