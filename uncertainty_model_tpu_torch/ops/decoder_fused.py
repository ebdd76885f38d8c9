"""Fused decoder-stage glue: ``assemble_z`` (the port of the JAX package's
``ops/pallas/decoder_fused.py::assemble_z``).

On a CUDA tensor the wrapper launches the hand-written Hopper kernel
``csrc/assemble_z.cu``; on a CPU tensor it runs :func:`assemble_z_plain`,
the same function in plain PyTorch, which the tests hold against the JAX
package and ``chip_smoke.py`` holds the kernel against on the card.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from .resize import lerp_taps, resize_bilinear
from .shuffle import shuffle_phase_major

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_CSO = 1024  # the kernel's block holds a multiple of Cso threads


def _shapes(se_fm, skip_h, xc, disp_h, bias, k_fm):
    """Validate the operands; return (B, H, W, Cso, Cu, Cd, cf) where cf is
    the folded feature map's channel count, or 0 without ``k_fm``."""
    if se_fm.ndim != 4 or skip_h.ndim != 4 or xc.ndim != 4:
        raise ValueError("assemble_z takes NHWC tensors")
    b, h, w, cin = se_fm.shape
    _, h2, w2, cso = skip_h.shape
    if (h, w) != (2 * h2, 2 * w2):
        raise ValueError(f"se_fm {tuple(se_fm.shape)} is not 2x skip_h "
                         f"{tuple(skip_h.shape)}")
    if skip_h.shape[0] != b or xc.shape[:3] != (b, h2, w2) or xc.shape[3] % 4:
        raise ValueError(f"xc {tuple(xc.shape)} does not match skip_h "
                         f"{tuple(skip_h.shape)} (needs 4*Cu channels)")
    cd = 0
    if disp_h is not None:
        if disp_h.ndim != 4 or disp_h.shape[:3] != (b, h2, w2):
            raise ValueError(f"disp_h {tuple(disp_h.shape)} does not match "
                             f"skip_h {tuple(skip_h.shape)}")
        cd = disp_h.shape[3]
    if tuple(bias.shape) != (cso,):
        raise ValueError(f"bias {tuple(bias.shape)} is not ({cso},)")
    cf = 0
    if k_fm is not None:
        cf = cin
        if tuple(k_fm.shape) != (cin, cso):
            raise ValueError(f"k_fm {tuple(k_fm.shape)} is not ({cin}, {cso})")
    elif cin != cso:
        raise ValueError(f"se_fm has {cin} channels, skip_h {cso}")
    return b, h, w, cso, xc.shape[3] // 4, cd, cf


def assemble_z_plain(se_fm, skip_h, xc, disp_h, bias, k_fm=None):
    """Plain PyTorch ``assemble_z``: computes in f32 and casts to the
    operands' type at the end (the fold too, as ``_fold_fallback`` in the
    JAX package does).  The mean is over the z block as stored."""
    dt = skip_h.dtype
    h, w = se_fm.shape[1], se_fm.shape[2]
    se = se_fm.float()
    if k_fm is not None:
        se = se @ k_fm.float()
    se = se + resize_bilinear(skip_h.float(), (h, w)) + bias.float()
    z = F.elu(se).to(dt)
    parts = [z, shuffle_phase_major(F.elu(xc.float())).to(dt)]
    if disp_h is not None:
        parts.append(resize_bilinear(disp_h.float(), (h, w)).to(dt))
    return torch.cat(parts, dim=-1), z.float().mean(dim=(1, 2))


@functools.lru_cache(maxsize=None)
def _tap_tables(h: int, w: int, device: torch.device):
    """Device copies of the upsample taps for an (H, W) output: int32
    [y_lo | y_hi | x_lo | x_hi] and f32 [y_frac | x_frac]."""
    ylo, yhi, yf = lerp_taps(h, h // 2)
    xlo, xhi, xf = lerp_taps(w, w // 2)
    taps = np.concatenate([ylo, yhi, xlo, xhi]).astype(np.int32)
    fracs = np.concatenate([yf, xf]).astype(np.float32)
    return (torch.from_numpy(taps).to(device),
            torch.from_numpy(fracs).to(device))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("assemble_z")
    fn = lib.umt_assemble_z
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 11
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _assemble_z_cuda(se_fm, skip_h, xc, disp_h, bias, k_fm, dims):
    b, h, w, cso, cu, cd, cf = dims
    dev = se_fm.device
    tensors = [se_fm, skip_h, xc] + ([disp_h] if disp_h is not None else [])
    dt = skip_h.dtype
    if dt not in _DTYPE_CODES:
        raise TypeError(f"assemble_z kernel takes float32 or bfloat16, not {dt}")
    for t in tensors + [bias] + ([k_fm] if k_fm is not None else []):
        if t.device != dev:
            raise ValueError("assemble_z operands must share one device")
    for t in tensors:
        if t.dtype != dt:
            raise TypeError("assemble_z operands must share one dtype")
        if not t.is_contiguous():
            raise ValueError("assemble_z takes contiguous NHWC tensors")
    if cso > _MAX_CSO:
        raise ValueError(f"assemble_z kernel takes at most {_MAX_CSO} "
                         f"z channels, not {cso}")
    fn = _library().umt_assemble_z
    bias32 = bias.float().contiguous()
    kfm32 = k_fm.float().contiguous() if k_fm is not None else None
    taps, fracs = _tap_tables(h, w, dev)
    cat = torch.empty((b, h, w, cso + cu + cd), dtype=dt, device=dev)
    partial = torch.empty((b, h, cso), dtype=torch.float32, device=dev)
    mean = torch.empty((b, cso), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_DTYPE_CODES[dt], se_fm.data_ptr(),
                 kfm32.data_ptr() if kfm32 is not None else None,
                 skip_h.data_ptr(), xc.data_ptr(),
                 disp_h.data_ptr() if disp_h is not None else None,
                 bias32.data_ptr(), taps.data_ptr(), fracs.data_ptr(),
                 cat.data_ptr(), partial.data_ptr(), mean.data_ptr(),
                 b, h, w, cso, cu, cd, cf, stream)
    if err != 0:
        raise RuntimeError(f"assemble_z kernel launch failed: CUDA error {err}")
    assemble_z.launches += 1
    return cat, mean


def assemble_z(se_fm, skip_h, xc, disp_h, bias, k_fm=None):
    """One fused pass producing a decoder stage's concat tensor with the
    skip half UNGATED, plus the SE squeeze (NHWC in and out):

        cat  = concat([elu(se_fm + up2(skip_h) + bias),    # z, ungated
                       pixel_shuffle(elu(xc)),             # phase-major xc
                       up2(disp_h)], channels)
        mean = mean over pixels of z  (B, Cso) f32

    ``disp_h`` may be None.  With ``k_fm`` (cf, Cso) the first operand is
    the raw stage feature map (B, H, W, cf) and ``se_fm = fm @ k_fm`` is
    folded in f32.  CPU tensors run the plain version; CUDA tensors launch
    the kernel (and count the launch in ``assemble_z.launches``) or raise.
    """
    dims = _shapes(se_fm, skip_h, xc, disp_h, bias, k_fm)
    if se_fm.device.type == "cpu":
        return assemble_z_plain(se_fm, skip_h, xc, disp_h, bias, k_fm)
    if se_fm.device.type != "cuda":
        raise RuntimeError(f"assemble_z has no kernel for {se_fm.device}")
    return _assemble_z_cuda(se_fm, skip_h, xc, disp_h, bias, k_fm, dims)


assemble_z.launches = 0
