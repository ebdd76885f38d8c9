"""PNG decode and the PIL-compatible resize of the data pipeline, without
PIL or libpng (the port of the JAX package's ``data/native.py``, whose
native backend decodes with libpng: ``native/stereo_loader.cc``).

Python reads the file, checks its chunks and inflates the concatenated
``IDAT`` data with the standard library's ``zlib``; ``csrc/stereo_decode.cc``, built by ``g++`` at first use, undoes
the row filters, expands every colour type to 8-bit RGB and resizes with
the triangle filter of the JAX package's native backend, with the same
floats.  ``zlib`` and the ``ctypes`` calls release the interpreter lock,
so the decode threads run in parallel.

Interlaced (Adam7) files are not read.  Every failure raises ``IOError``
naming the file; there is no other decode path to fall back to.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import subprocess
import zlib
from concurrent.futures import Executor, ThreadPoolExecutor

import numpy as np

from .. import _build

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# chunks whose CRC is checked: the IDAT data is checked by the zlib
# stream's own Adler-32 instead, which costs one pass over the inflated
# bytes; a CRC call a chunk would release and retake the interpreter lock
# hundreds of times a file where a writer cuts IDAT into 8 KiB chunks
_CRC_CHECKED = (b"IHDR", b"PLTE", b"IEND")
# libpng's default limit on either dimension
_MAX_SIDE = 1_000_000
# each colour type's samples a pixel and its bit depths
_FORMATS = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
            4: (2, (8, 16)), 6: (4, (8, 16))}
# csrc/stereo_decode.cc's status codes
_STATUS = {1: "a colour type or bit depth that PNG does not define",
           2: "fewer image bytes than its rows need",
           3: "a row filter type outside 0-4"}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("stereo_decode")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.umt_png_to_rgb8.restype = i32
    lib.umt_png_to_rgb8.argtypes = [ptr, ctypes.c_int64, i32, i32, i32, i32,
                                    ptr, ptr]
    lib.umt_resize_rgb8.restype = i32
    lib.umt_resize_rgb8.argtypes = [ptr, i32, i32, i32, i32, ptr]
    return lib


def native_available() -> bool:
    """Whether ``csrc/stereo_decode.cc`` builds and loads here (g++ at
    first use).  A query only: no path of the port switches to another
    decoder on it, and ``decode_resize_batch`` raises where the library is
    missing."""
    try:
        _library()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return False
    return True


def _failed(path: str, reason: str) -> IOError:
    return IOError(f"failed to decode {path}: {reason}")


def _read_png(path: str):
    """(width, height, bit depth, colour type, 768-byte palette, inflated
    rows) of a non-interlaced PNG file."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as e:
        raise _failed(path, e.strerror or str(e)) from e
    if blob[:8] != PNG_SIGNATURE:
        raise _failed(path, "not a PNG file")
    view = memoryview(blob)
    header, palette, idat = None, None, []
    pos = 8
    while True:
        if pos + 12 > len(blob):
            raise _failed(path, "truncated before IEND")
        length, kind = struct.unpack_from(">I4s", blob, pos)
        end = pos + 12 + length
        if end > len(blob):
            raise _failed(path, f"truncated {kind!r} chunk")
        data = view[pos + 8:end - 4]
        if kind in _CRC_CHECKED:
            (crc,) = struct.unpack_from(">I", blob, end - 4)
            if zlib.crc32(data, zlib.crc32(kind)) != crc:
                raise _failed(path, f"CRC error in {kind!r}")
        if header is None and kind != b"IHDR":
            raise _failed(path, "the first chunk is not IHDR")
        if kind == b"IHDR":
            if length != 13:
                raise _failed(path, "malformed IHDR")
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"PLTE":
            if length > 768 or length % 3:
                raise _failed(path, "malformed PLTE")
            palette = bytes(data) + bytes(768 - length)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
        pos = end

    width, height, depth, colour, compression, filtering, interlace = header
    if interlace:
        raise _failed(path, "interlaced (Adam7) PNG files are not supported")
    if compression or filtering:
        raise _failed(path, "unknown compression or filter method")
    if not (0 < width <= _MAX_SIDE and 0 < height <= _MAX_SIDE):
        raise _failed(path, f"image size {width}x{height}")
    channels, depths = _FORMATS.get(colour, (0, ()))
    if depth not in depths:
        raise _failed(path, _STATUS[1])
    if colour == 3 and palette is None:
        raise _failed(path, "palette image without PLTE")
    if not idat:
        raise _failed(path, "no IDAT chunk")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise _failed(path, f"corrupt image data ({e})") from e
    # before the caller allocates the header's height x width: each row is
    # a filter byte and its packed samples
    if len(raw) < height * ((width * channels * depth + 7) // 8 + 1):
        raise _failed(path, _STATUS[2])
    return width, height, depth, colour, palette or bytes(768), raw


def decode_png(path: str) -> np.ndarray:
    """The (H, W, 3) uint8 RGB pixels of the PNG file ``path``: gray and
    palette images expanded, 16-bit samples cut to their high byte, alpha
    dropped (what the JAX package's libpng and PIL readers give)."""
    width, height, depth, colour, palette, raw = _read_png(path)
    out = np.empty((height, width, 3), np.uint8)
    status = _library().umt_png_to_rgb8(raw, len(raw), width, height, depth,
                                        colour, palette, out.ctypes.data)
    if status:
        raise _failed(path, _STATUS[status])
    return out


def _resize_into(image: np.ndarray, out: np.ndarray) -> None:
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise TypeError(f"expected an (H, W, 3) uint8 image, got "
                        f"{image.dtype} {image.shape}")
    image = np.ascontiguousarray(image)
    out_h, out_w = out.shape[:2]
    status = _library().umt_resize_rgb8(image.ctypes.data, image.shape[0],
                                        image.shape[1], out_h, out_w,
                                        out.ctypes.data)
    if status:
        raise ValueError(f"cannot resize {image.shape} to ({out_h}, {out_w})")


def resize_rgb8(image: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Resize an (H, W, 3) uint8 image to (out_h, out_w, 3) float32 in
    [0, 1] with PIL's ``Image.BILINEAR`` triangle filter, keeping the float
    where PIL rounds to uint8 between its two passes."""
    out = np.empty((out_h, out_w, 3), np.float32)
    _resize_into(image, out)
    return out


def decode_resize_batch(paths: list[str], out_h: int, out_w: int,
                        num_threads: int = 8,
                        pool: Executor | None = None) -> np.ndarray:
    """Decode and resize ``paths`` into an (N, out_h, out_w, 3) float32
    [0, 1] batch on ``num_threads`` threads (the JAX package's signature),
    or on ``pool`` where one is given (the loader's); raises ``IOError``
    naming the first file (in the order given) that fails."""
    if out_h <= 0 or out_w <= 0:
        raise ValueError(f"output size ({out_h}, {out_w})")
    if pool is None:
        with ThreadPoolExecutor(max(1, min(num_threads, len(paths)))) as pool:
            return decode_resize_batch(paths, out_h, out_w, pool=pool)
    _library()  # built once, before the threads start
    out = np.empty((len(paths), out_h, out_w, 3), np.float32)

    def one(i):
        _resize_into(decode_png(paths[i]), out[i])

    for future in [pool.submit(one, i) for i in range(len(paths))]:
        future.result()
    return out
