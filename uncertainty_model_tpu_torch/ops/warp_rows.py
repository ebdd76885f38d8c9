"""The horizontal stereo warp of NHWC rows, ``warp_rows``, and its gradient
(the port of the JAX package's ``ops/pallas/warp.py::warp_rows``).

``warp_rows(x, src)`` samples each row of ``src`` (R, W, C) at the pixel
coordinates ``x`` (R, W) with a 2-tap lerp, zero outside [0, W) (grid_sample
zeros padding).  It is a ``torch.autograd.Function``: on CUDA tensors the
forward launches ``csrc/warp_rows.cu``'s forward kernel and the backward its
backward kernel, each counted in ``warp_rows_fwd.launches`` and
``warp_rows_bwd.launches``; on CPU tensors both run the plain versions
:func:`warp_rows_plain` (the gather form) and :func:`warp_rows_bwd_plain`
(its derivative written out), which the tests hold against the JAX package
and ``chip_smoke.py`` holds the kernels against on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

# the backward kernel holds a row's dsrc (W * C f32) in one block's shared
# memory
_MAX_SHARED_BYTES = 232_448


def _gather_taps(x: torch.Tensor, width: int):
    """(x0 clamped, x1 clamped, valid0, valid1, t) of the 2-tap lerp."""
    x0f = torch.floor(x)
    t = x - x0f
    x0 = x0f.long()
    x1 = x0 + 1
    valid0 = (x0 >= 0) & (x0 <= width - 1)
    valid1 = (x1 >= 0) & (x1 <= width - 1)
    return (x0.clamp(0, width - 1), x1.clamp(0, width - 1), valid0, valid1,
            t)


def _gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(src, 1, idx[..., None].expand(*idx.shape,
                                                      src.shape[2]))


def warp_rows_plain(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """The gather form: ``tap(x0) * (1 - t) + tap(x0 + 1) * t`` with a tap
    outside [0, W) read as zero."""
    x0, x1, valid0, valid1, t = _gather_taps(x, src.shape[1])
    tap0 = _gather(src, x0) * valid0[..., None].to(src.dtype)
    tap1 = _gather(src, x1) * valid1[..., None].to(src.dtype)
    return tap0 * (1 - t)[..., None] + tap1 * t[..., None]


def warp_rows_bwd_plain(x: torch.Tensor, src: torch.Tensor,
                        dout: torch.Tensor):
    """``(dx, dsrc)`` of :func:`warp_rows_plain` for the cotangent
    ``dout``: ``dx = sum_c dout * (tap(x0 + 1) - tap(x0))`` (the slope of
    the half-open window (x - 1, x + 1], integer x included) and ``dsrc =
    M^T dout`` as two scatter-adds."""
    x0, x1, valid0, valid1, t = _gather_taps(x, src.shape[1])
    tap0 = _gather(src, x0) * valid0[..., None].to(src.dtype)
    tap1 = _gather(src, x1) * valid1[..., None].to(src.dtype)
    dx = (dout * (tap1 - tap0)).sum(-1)
    w0 = ((1 - t) * valid0.to(t.dtype))[..., None]
    w1 = (t * valid1.to(t.dtype))[..., None]
    c = src.shape[2]
    dsrc = torch.zeros_like(src)
    dsrc.scatter_add_(1, x0[..., None].expand(*x0.shape, c), w0 * dout)
    dsrc.scatter_add_(1, x1[..., None].expand(*x1.shape, c), w1 * dout)
    return dx, dsrc


def _check(x: torch.Tensor, src: torch.Tensor, dout=None) -> None:
    if src.ndim != 3 or x.ndim != 2 or tuple(x.shape) != tuple(src.shape[:2]):
        raise ValueError(f"warp_rows takes x (R, W) and src (R, W, C), not "
                         f"{tuple(x.shape)} and {tuple(src.shape)}")
    if dout is not None and dout.shape != src.shape:
        raise ValueError(f"dout {tuple(dout.shape)} is not src's shape "
                         f"{tuple(src.shape)}")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("warp_rows")
    lib.umt_warp_rows_fwd.argtypes = ([ctypes.c_void_p] * 3
                                      + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.umt_warp_rows_bwd.argtypes = ([ctypes.c_void_p] * 5
                                      + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.umt_warp_rows_fwd.restype = ctypes.c_int
    lib.umt_warp_rows_bwd.restype = ctypes.c_int
    return lib


def _cuda_operands(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"warp_rows has no kernel for {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError("warp_rows operands must share one device")
        if t.dtype != torch.float32:
            raise TypeError(f"warp_rows kernels take float32, not {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("warp_rows kernels take contiguous tensors")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def warp_rows_fwd(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """The forward of :func:`warp_rows` without autograd: the plain version
    on CPU tensors, the forward kernel on CUDA tensors (or raise)."""
    _check(x, src)
    if x.device.type == "cpu" and src.device.type == "cpu":
        return warp_rows_plain(x, src)
    _cuda_operands(x, src)
    out = torch.empty_like(src)
    r, w, c = src.shape
    if out.numel() == 0:
        return out
    with torch.cuda.device(src.device):
        err = _library().umt_warp_rows_fwd(
            x.data_ptr(), src.data_ptr(), out.data_ptr(), r, w, c,
            _stream(src.device))
    if err != 0:
        raise RuntimeError(f"warp_rows forward launch failed: CUDA error {err}")
    warp_rows_fwd.launches += 1
    return out


def warp_rows_bwd(x: torch.Tensor, src: torch.Tensor, dout: torch.Tensor):
    """``(dx, dsrc)`` of :func:`warp_rows`: the plain version on CPU
    tensors, the backward kernel on CUDA tensors (or raise)."""
    _check(x, src, dout)
    if all(t.device.type == "cpu" for t in (x, src, dout)):
        return warp_rows_bwd_plain(x, src, dout)
    _cuda_operands(x, src, dout)
    r, w, c = src.shape
    if 4 * w * c > _MAX_SHARED_BYTES:
        raise ValueError(f"warp_rows backward holds a row of W*C = {w * c} "
                         f"f32 in shared memory; at most "
                         f"{_MAX_SHARED_BYTES // 4}")
    dsrc = torch.empty_like(src)
    dx = torch.empty_like(x)
    if dsrc.numel() == 0:
        return dx, dsrc
    with torch.cuda.device(src.device):
        err = _library().umt_warp_rows_bwd(
            x.data_ptr(), src.data_ptr(), dout.data_ptr(), dsrc.data_ptr(),
            dx.data_ptr(), r, w, c, _stream(src.device))
    if err != 0:
        raise RuntimeError(f"warp_rows backward launch failed: CUDA error "
                           f"{err}")
    warp_rows_bwd.launches += 1
    return dx, dsrc


warp_rows_fwd.launches = 0
warp_rows_bwd.launches = 0


class _WarpRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src):
        ctx.save_for_backward(x, src)
        return warp_rows_fwd(x, src)

    @staticmethod
    def backward(ctx, dout):
        x, src = ctx.saved_tensors
        dx, dsrc = warp_rows_bwd(x, src, dout.contiguous())
        return dx, dsrc


def warp_rows(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Sample each row of ``src`` (R, W, C) at the pixel coordinates ``x``
    (R, W): ``out[r, j] = sum_k max(0, 1 - |x[r, j] - k|) * src[r, k]``,
    differentiable in both.  ``dx`` is in pixel units."""
    return _WarpRows.apply(x, src)
