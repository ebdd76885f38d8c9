"""Exact 2x align-corners bilinear upsample of NHWC tensors,
``upsample2x2`` (the port of the JAX package's
``ops/pallas/upsample.py::upsample2x2``).

On a CUDA tensor the wrapper launches the hand-written Hopper kernel
``csrc/upsample2x2.cu`` (counted in ``upsample2x2.launches``); on a CPU
tensor it runs :func:`upsample2x2_plain`, the same arithmetic in plain
PyTorch, which the tests hold against the Pallas kernel in interpret mode
and ``chip_smoke.py`` holds the kernel against on the card.  No path of the
port calls it, as no path of the JAX package calls its kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import hand
from .resize import _lerp_coeffs


@functools.lru_cache(maxsize=None)
def _taps(h: int, w: int):
    """The column pass's (even, odd) fractions per source column (W, 2) and
    the row pass's source rows lo, hi (2H,) with weights (1 - f, f) (2H, 2),
    from ``_lerp_coeffs`` as the Pallas kernel takes them."""
    _, _, fw = _lerp_coeffs(2 * w, w)
    lo, hi, fh = _lerp_coeffs(2 * h, h)
    col = np.stack([fw[0::2], fw[1::2]], axis=-1).astype(np.float32)
    rows = np.stack([np.float32(1) - fh, fh], axis=-1).astype(np.float32)
    return col, lo.astype(np.int32), hi.astype(np.int32), rows


@functools.lru_cache(maxsize=None)
def _device_taps(h: int, w: int, device: torch.device):
    """:func:`_taps` as tensors on ``device`` (made once, so that a CUDA
    graph can capture the calls that read them)."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in _taps(h, w))


def upsample2x2_plain(x: torch.Tensor) -> torch.Tensor:
    """The Pallas kernel's arithmetic in plain PyTorch: the column pass
    ``even = x[j-1] + fe (x[j] - x[j-1])``, ``odd = x[j] + fo (x[j+1] -
    x[j])`` in f32 (edges replicated), rounded to ``x``'s type as the TPU
    kernel stores it; then the row pass ``(1 - f) y1[lo] + f y1[hi]`` in f32
    (``((1 - f) + f) y1[lo]`` where ``lo == hi``), rounded once."""
    b, h, w, c = x.shape
    col, lo, hi, rows = _device_taps(h, w, x.device)
    xf = x.float()
    x_prev = torch.cat([xf[:, :, :1], xf[:, :, :-1]], dim=2)
    x_next = torch.cat([xf[:, :, 1:], xf[:, :, -1:]], dim=2)
    even = x_prev + col[:, 0].reshape(1, 1, w, 1) * (xf - x_prev)
    odd = xf + col[:, 1].reshape(1, 1, w, 1) * (x_next - xf)
    y1 = torch.stack([even, odd], dim=3).reshape(b, h, 2 * w, c)
    y1 = y1.to(x.dtype).float()
    w_lo = rows[:, 0].reshape(1, 2 * h, 1, 1)
    w_hi = rows[:, 1].reshape(1, 2 * h, 1, 1)
    y_lo, y_hi = y1.index_select(1, lo), y1.index_select(1, hi)
    out = torch.where((lo == hi).reshape(1, 2 * h, 1, 1),
                      (w_lo + w_hi) * y_lo, w_lo * y_lo + w_hi * y_hi)
    return out.to(x.dtype)


def upsample2x2(x: torch.Tensor) -> torch.Tensor:
    """Exact 2x align-corners bilinear upsample of NHWC ``x`` (B, H, W, C)
    -> (B, 2H, 2W, C), any H, W >= 1.  CPU tensors run the plain version;
    CUDA tensors (float32 or bfloat16, contiguous) launch the kernel or
    raise."""
    if x.ndim != 4 or min(x.shape) < 1:
        raise ValueError(f"upsample2x2 takes a non-empty NHWC tensor, not "
                         f"{tuple(x.shape)}")
    return hand.run(upsample2x2, (x,), lambda: upsample2x2_plain(x),
                    lambda: _upsample2x2_kernel(x))


def _upsample2x2_kernel(x):
    code = hand.check("upsample2x2", {"x": x}, aligned=True)
    b, h, w, c = x.shape
    col, lo, hi, rows = _device_taps(h, w, x.device)
    out = torch.empty((b, 2 * h, 2 * w, c), dtype=x.dtype, device=x.device)
    hand.launch(upsample2x2, "umt_upsample2x2", x.device, code, x.data_ptr(),
                out.data_ptr(), col.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                rows.data_ptr(), b, h, w, c)
    return out


upsample2x2.launches = 0
