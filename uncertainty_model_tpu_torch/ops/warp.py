"""Stereo bilinear warp: view reconstruction by disparity (the port of the
JAX package's ``ops/warp.py``).

The reference reconstructs a view with ``F.grid_sample`` (bilinear, zeros
padding, align_corners=False) over a flow field that only shifts x by the
disparity (reference train/utils.py:65-109).  The sampling point of output
pixel ``(i, j)`` is::

    x_src = (j / (W-1) + d[b,i,j]) * W - 0.5      (pixel units)
    y_src =  i / (H-1)             * H - 0.5

``y_src`` depends only on the row, so the 2-D sample separates exactly: a
vertical lerp with static per-row weights (plain PyTorch here) and a
horizontal 2-tap lerp at disparity-dependent columns, :func:`warp_rows`
(a hand-written kernel on CUDA tensors); :func:`warp_by_disparities` warps
several sources in one launch of it.  Each tap outside the image
contributes zero, which dims the border rows and columns by half, as
grid_sample does.  Everything is differentiable in the disparity.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .warp_rows import warp_rows_many


@functools.lru_cache(maxsize=None)
def _vertical_coeffs(height: int):
    """Static (lo, hi, w_lo, w_hi) of the vertical lerp, zero-masked."""
    i = np.arange(height, dtype=np.float64)
    y_src = i / (height - 1) * height - 0.5
    lo = np.floor(y_src).astype(np.int64)
    hi = lo + 1
    w_hi = (y_src - lo).astype(np.float32)
    w_lo = 1.0 - w_hi
    w_lo = np.where((lo >= 0) & (lo <= height - 1), w_lo, 0.0).astype(np.float32)
    w_hi = np.where((hi >= 0) & (hi <= height - 1), w_hi, 0.0).astype(np.float32)
    return (np.clip(lo, 0, height - 1), np.clip(hi, 0, height - 1), w_lo,
            w_hi)


@functools.lru_cache(maxsize=None)
def _device_vertical(height: int, device: torch.device, dtype: torch.dtype):
    lo, hi, w_lo, w_hi = _vertical_coeffs(height)
    shape = (1, height, 1, 1)
    return (torch.from_numpy(lo).to(device), torch.from_numpy(hi).to(device),
            torch.from_numpy(w_lo).to(device, dtype).reshape(shape),
            torch.from_numpy(w_hi).to(device, dtype).reshape(shape))


@functools.lru_cache(maxsize=None)
def _x_base(width: int, device: torch.device) -> torch.Tensor:
    """``j / (W - 1)`` in f32, divided on the host: a device's division by
    a scalar may multiply by its reciprocal instead, one ulp off, and the
    warp's taps move with x."""
    j = np.arange(width, dtype=np.float32)
    return torch.from_numpy(j / np.float32(width - 1)).to(device)


def _warp_operands(disparity: torch.Tensor, source: torch.Tensor):
    """``warp_rows``'s operands for :func:`warp_by_disparity`: the sampling
    columns ``x`` (B*H, W) in pixels and the vertically lerped source
    (B*H, W, C)."""
    if disparity.ndim == 4:
        disparity = disparity[..., 0]
    b, h, w, c = source.shape
    lo, hi, w_lo, w_hi = _device_vertical(h, source.device, source.dtype)
    src_v = source.index_select(1, lo) * w_lo + source.index_select(1, hi) * w_hi

    x_src = (_x_base(w, source.device) + disparity.float()) * w - 0.5
    return (x_src.reshape(b * h, w).contiguous(),
            src_v.reshape(b * h, w, c).contiguous())


def warp_by_disparities(disparities, sources) -> list:
    """:func:`warp_by_disparity` of each pair ``(disparities[i],
    sources[i])``, with one ``warp_rows`` launch each way for all of them
    on CUDA (the sources share C)."""
    operands = [_warp_operands(d, s) for d, s in zip(disparities, sources)]
    warped = warp_rows_many([x for x, _ in operands],
                            [s for _, s in operands])
    return [out.reshape(s.shape) for out, s in zip(warped, sources)]


def warp_by_disparity(disparity: torch.Tensor,
                      source: torch.Tensor) -> torch.Tensor:
    """Sample ``source`` (B, H, W, C) at x shifted by ``disparity``
    ((B, H, W) or (B, H, W, 1), in image widths; positive samples to the
    right): grid_sample(zeros, align_corners=False) of the reference."""
    return warp_by_disparities([disparity], [source])[0]


def reconstruct_left_image(left_disparity: torch.Tensor,
                           right_image: torch.Tensor) -> torch.Tensor:
    """The left view from the left disparity and the right image
    (reference train/utils.py:100-104)."""
    return warp_by_disparity(-left_disparity, right_image)


def reconstruct_right_image(right_disparity: torch.Tensor,
                            left_image: torch.Tensor) -> torch.Tensor:
    """The right view from the right disparity and the left image
    (reference train/utils.py:107-109)."""
    return warp_by_disparity(right_disparity, left_image)


def reconstruct_stereo(disparity: torch.Tensor,
                       images: torch.Tensor) -> torch.Tensor:
    """Both views of a stereo pair (``images[..., :3]`` left, ``[..., 3:6]``
    right) reconstructed by ``disparity[..., 0]`` (left) and ``[..., 1]``
    (right), as (..., 6) (reference train/utils.py:112-135)."""
    return reconstruct_pyramid([disparity], [images])[0]


def reconstruct_pyramid(disparities, pyramid) -> list:
    """:func:`reconstruct_stereo` at every scale: the reconstructions of
    :func:`reconstruct_pyramid_with_lr` (one ``warp_rows`` launch for all
    the scales on CUDA; its LR-consistency channel goes unused)."""
    return reconstruct_pyramid_with_lr(disparities, pyramid)[0]


def reconstruct_stereo_with_lr(disparity: torch.Tensor, images: torch.Tensor):
    """Both views of a stereo pair (``images[..., :3]`` left, ``[..., 3:6]``
    right) reconstructed by ``disparity[..., 0]`` (left) and ``[..., 1]``
    (right), with the LR-consistency warps of the opposite-view disparity
    stacked as a 4th source channel: one warp per view instead of two, the
    same values per channel.

    Returns ``(recon (..., 6), lr (..., 2))``; ``lr[..., 0]`` is the left
    disparity reconstructed from the right, and vice versa."""
    recon, lr = reconstruct_pyramid_with_lr([disparity], [images])
    return recon[0], lr[0]


def reconstruct_pyramid_with_lr(disparities, pyramid):
    """:func:`reconstruct_stereo_with_lr` at every scale, all the scales'
    warps in one ``warp_rows`` launch each way on CUDA; returns
    ``(recon_pyramid, lr_pyramid)``."""
    shifts, sources = [], []
    for d, im in zip(disparities, pyramid):
        # the left view from the right image (reconstruct_left_image), the
        # right view from the left
        shifts += [-d[..., 0], d[..., 1]]
        sources += [torch.cat([im[..., 3:6], d[..., 1:2]], dim=-1),
                    torch.cat([im[..., 0:3], d[..., 0:1]], dim=-1)]
    warped = warp_by_disparities(shifts, sources)
    lefts, rights = warped[0::2], warped[1::2]
    recon = [torch.cat([a[..., :3], b[..., :3]], dim=-1)
             for a, b in zip(lefts, rights)]
    lr = [torch.cat([a[..., 3:4], b[..., 3:4]], dim=-1)
          for a, b in zip(lefts, rights)]
    return recon, lr
