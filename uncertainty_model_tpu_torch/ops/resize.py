"""Bilinear resize with torch ``align_corners=True`` semantics, on NHWC
tensors (the port's copy of the JAX package's ``ops/resize.py``).

``_lerp_coeffs`` is the contract: the same float32 arithmetic as torch's
source-coordinate computation, bit for bit.  ``F.interpolate`` is not used,
so the weights do not depend on how a torch build rounds them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _lerp_coeffs(out_size: int, in_size: int
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Static (lo_idx, hi_idx, frac) arrays for align_corners=True sampling."""
    if out_size == 1:
        # align_corners with a single output sample reads source index 0
        return (np.zeros(1, np.int32), np.zeros(1, np.int32),
                np.zeros(1, np.float32))
    if in_size == 1:
        z = np.zeros(out_size, np.int32)
        return (z, z, np.zeros(out_size, np.float32))
    # torch computes source coordinates in float32:
    # scale = (in-1)/(out-1), src = scale * i
    scale = np.float32(in_size - 1) / np.float32(out_size - 1)
    src = scale * np.arange(out_size, dtype=np.float32)
    lo = np.floor(src).astype(np.int32)
    lo = np.minimum(lo, in_size - 2)
    frac = (src - lo).astype(np.float32)
    return lo, lo + 1, frac


@functools.lru_cache(maxsize=None)
def lerp_taps(out_size: int, in_size: int
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(lo, hi, frac) per output index exactly as :func:`resize_bilinear`
    reads them: ``out[o] = x[lo] + frac * (x[hi] - x[lo])``.

    For an exact 2x upsample of ``in_size >= 2`` that is the shift form of
    ``_upsample2_axis``: even outputs lerp ``x[i-1] -> x[i]`` and odd ones
    ``x[i] -> x[i+1]``, with the edge neighbour replicated (its weight is
    then 0, or the two taps are equal).  Otherwise it is ``_lerp_coeffs``
    as it stands.  The CUDA ``assemble_z`` kernel reads these tables, so its
    upsample is the same arithmetic as this module's."""
    lo, hi, frac = _lerp_coeffs(out_size, in_size)
    if out_size == 2 * in_size and in_size >= 2:
        i = np.arange(in_size, dtype=np.int32)
        lo = np.empty(out_size, np.int32)
        hi = np.empty(out_size, np.int32)
        lo[0::2], hi[0::2] = np.maximum(i - 1, 0), i
        lo[1::2], hi[1::2] = i, np.minimum(i + 1, in_size - 1)
    return lo, hi, frac


@functools.lru_cache(maxsize=None)
def _device_coeffs(out_size: int, in_size: int, device: torch.device,
                   dtype: torch.dtype) -> tuple[torch.Tensor, ...]:
    """(lo, hi, frac) of ``_lerp_coeffs`` as tensors on ``device``."""
    lo, hi, frac = _lerp_coeffs(out_size, in_size)
    return (torch.from_numpy(lo).to(device, torch.long),
            torch.from_numpy(hi).to(device, torch.long),
            torch.from_numpy(frac).to(device, dtype))


def _shift(x: torch.Tensor, dim: int, delta: int) -> torch.Tensor:
    """``x`` shifted by one along ``dim`` with the edge replicated."""
    n = x.shape[dim]
    if delta == -1:  # row i holds x[i-1]
        return torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
    return torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)


def _bshape(x: torch.Tensor, dim: int, n: int) -> list[int]:
    shape = [1] * x.ndim
    shape[dim] = n
    return shape


def _upsample2_axis(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Exact 2x align_corners upsample along ``dim`` as one shift and one
    lerp per output parity (no gather); bit-identical to the gather form
    with the ``_lerp_coeffs`` fractions."""
    n = x.shape[dim]
    frac = _device_coeffs(2 * n, n, x.device, x.dtype)[2]
    w_even = frac[0::2].reshape(_bshape(x, dim, n))
    w_odd = frac[1::2].reshape(_bshape(x, dim, n))
    x_prev = _shift(x, dim, -1)
    x_next = _shift(x, dim, +1)
    even = x_prev + w_even * (x - x_prev)
    odd = x + w_odd * (x_next - x)
    shape = list(x.shape)
    shape[dim] = 2 * n
    return torch.stack([even, odd], dim=dim + 1).reshape(shape)


def _interp_axis(x: torch.Tensor, out_size: int, dim: int) -> torch.Tensor:
    in_size = x.shape[dim]
    if in_size == out_size:
        return x
    if out_size == 2 * in_size and in_size >= 2:
        return _upsample2_axis(x, dim)
    lo, hi, frac = _device_coeffs(out_size, in_size, x.device, x.dtype)
    x_lo = x.index_select(dim, lo)
    x_hi = x.index_select(dim, hi)
    w = frac.reshape(_bshape(x, dim, out_size))
    # torch's lerp formulation (v0 + w*(v1-v0))
    return x_lo + w * (x_hi - x_lo)


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Resize an NHWC tensor to ``size=(H, W)`` (align_corners=True); H is
    interpolated first, then W, as in the JAX package."""
    x = _interp_axis(x, size[0], x.ndim - 3)
    return _interp_axis(x, size[1], x.ndim - 2)


def scale_pyramid(x: torch.Tensor, scales: int) -> list[torch.Tensor]:
    """``scales`` levels of an NHWC image, H and W halved (floor) at each
    level by the align-corners resize (reference train/utils.py:27-50)."""
    h, w = x.shape[-3], x.shape[-2]
    return [resize_bilinear(x, (h // 2 ** i, w // 2 ** i))
            for i in range(scales)]
