"""Fused decoder-stage glue (the port of the JAX package's
``ops/pallas/decoder_fused.py``): ``assemble_z`` and ``gate_z`` (the
``gate_fold`` and ``gate_z`` pipelines), ``se_squeeze`` and ``assemble``
(the ``squeeze_first`` pipeline).

On a CUDA tensor each wrapper launches its hand-written Hopper kernel
(``csrc/assemble_z.cu``, ``csrc/decoder_fused.cu``); on a CPU tensor it runs
the ``*_plain`` function beside it, the same function in plain PyTorch,
which the tests hold against the JAX package and ``chip_smoke.py`` holds
the kernel against on the card.  All four compute z = elu(se + up2(skip_h)
+ bias) in f32 and round it once to the working type; ``assemble``'s z
block is that z times the gate, rounded again, so ``assemble(g) ==
gate_z(assemble_z(), g)`` bit for bit.
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


def _shapes(se_fm, skip_h, xc, disp_h, bias, k_fm, gates=None):
    """Validate the operands (``xc`` None for ``se_squeeze``); return
    (B, H, W, Cso, Cu, Cd, cf) where cf is the folded feature map's channel
    count, or 0 without ``k_fm``."""
    if se_fm.ndim != 4 or skip_h.ndim != 4:
        raise ValueError("the decoder glue takes NHWC tensors")
    b, h, w, cin = se_fm.shape
    _, h2, w2, cso = skip_h.shape
    if (h, w) != (2 * h2, 2 * w2):
        raise ValueError(f"se_fm {tuple(se_fm.shape)} is not 2x skip_h "
                         f"{tuple(skip_h.shape)}")
    if skip_h.shape[0] != b or (xc is not None and (
            xc.ndim != 4 or xc.shape[:3] != (b, h2, w2) or xc.shape[3] % 4)):
        raise ValueError(f"xc {None if xc is None else tuple(xc.shape)} does "
                         f"not match skip_h {tuple(skip_h.shape)} (needs 4*Cu "
                         "channels)")
    cd = 0
    if disp_h is not None:
        if disp_h.ndim != 4 or disp_h.shape[:3] != (b, h2, w2):
            raise ValueError(f"disp_h {tuple(disp_h.shape)} does not match "
                             f"skip_h {tuple(skip_h.shape)}")
        cd = disp_h.shape[3]
    if tuple(bias.shape) != (cso,):
        raise ValueError(f"bias {tuple(bias.shape)} is not ({cso},)")
    if gates is not None and tuple(gates.shape) != (b, cso):
        raise ValueError(f"gates {tuple(gates.shape)} are not ({b}, {cso})")
    cf = 0
    if k_fm is not None:
        cf = cin
        if tuple(k_fm.shape) != (cin, cso):
            raise ValueError(f"k_fm {tuple(k_fm.shape)} is not ({cin}, {cso})")
    elif cin != cso:
        raise ValueError(f"se_fm has {cin} channels, skip_h {cso}")
    return b, h, w, cso, 0 if xc is None else xc.shape[3] // 4, cd, cf


def _z_plain(se_fm, skip_h, bias, k_fm):
    """z = elu(se + up2(skip_h) + bias), computed in f32 (the fold too, as
    ``_fold_fallback`` in the JAX package does) and cast once to the
    operands' type."""
    h, w = se_fm.shape[1], se_fm.shape[2]
    se = se_fm.float()
    if k_fm is not None:
        se = se @ k_fm.float()
    se = se + resize_bilinear(skip_h.float(), (h, w)) + bias.float()
    return F.elu(se).to(skip_h.dtype)


def _cat_plain(z, xc, disp_h):
    dt = z.dtype
    h, w = z.shape[1], z.shape[2]
    parts = [z, shuffle_phase_major(F.elu(xc.float())).to(dt)]
    if disp_h is not None:
        parts.append(resize_bilinear(disp_h.float(), (h, w)).to(dt))
    return torch.cat(parts, dim=-1)


def assemble_z_plain(se_fm, skip_h, xc, disp_h, bias, k_fm=None):
    """Plain PyTorch ``assemble_z``; the mean is over the z block as
    stored."""
    z = _z_plain(se_fm, skip_h, bias, k_fm)
    return _cat_plain(z, xc, disp_h), z.float().mean(dim=(1, 2))


def se_squeeze_plain(se_fm, skip_h, bias, k_fm=None):
    """Plain PyTorch ``se_squeeze``: ``assemble_z_plain``'s mean."""
    return _z_plain(se_fm, skip_h, bias, k_fm).float().mean(dim=(1, 2))


def assemble_plain(se_fm, skip_h, gates, xc, disp_h, bias, k_fm=None):
    """Plain PyTorch ``assemble``: z times the gates, rounded to the working
    type, then ``assemble_z_plain``'s other blocks."""
    z = _z_plain(se_fm, skip_h, bias, k_fm)
    return _cat_plain(z * gates[:, None, None, :].to(z.dtype), xc, disp_h)


def gate_z_plain(cat, gates, cso):
    """Plain PyTorch ``gate_z``: ``cat[..., :cso] *= gates``, IN PLACE."""
    cat[..., :cso] *= gates[:, None, None, :].to(cat.dtype)
    return cat


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
def _library(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu``'s library with its functions' C signatures."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    signatures = {
        "assemble_z": {"umt_assemble_z": [i32] + [ptr] * 11 + [i32] * 7},
        "decoder_fused": {
            "umt_gate_z": [i32, ptr, ptr] + [i32] * 5,
            "umt_se_squeeze": [i32] + [ptr] * 8 + [i32] * 5,
            "umt_assemble": [i32] + [ptr] * 10 + [i32] * 7,
        },
    }
    lib = _build.load(name)
    for fn_name, args in signatures[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = args + [ptr]  # the stream
        fn.restype = ctypes.c_int
    return lib


def _check_cuda(name, tensors, floats, cso):
    """The kernels' operand rules: one CUDA device; ``tensors`` contiguous
    and of one storage type, float32 or bfloat16; ``floats`` f32 (made so
    here); Cso within a block.  Returns (dtype code, the f32 tensors)."""
    dt = tensors[0].dtype
    dev = tensors[0].device
    if dt not in _DTYPE_CODES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, not {dt}")
    for t in tensors + [t for t in floats if t is not None]:
        if t.device != dev:
            raise ValueError(f"{name} operands must share one device")
    for t in tensors:
        if t.dtype != dt:
            raise TypeError(f"{name} operands must share one dtype")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous NHWC tensors")
    if cso > _MAX_CSO:
        raise ValueError(f"{name} kernel takes at most {_MAX_CSO} z channels, "
                         f"not {cso}")
    floats = [None if t is None else t.float().contiguous() for t in floats]
    return _DTYPE_CODES[dt], floats


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(name, fn_name, dev, *args):
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(_library(name), fn_name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name[4:]} kernel launch failed: CUDA error "
                           f"{err}")


def _on_cuda(name, t):
    """True for a CUDA tensor, False for a CPU one (the plain version runs);
    anything else raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"{name} has no kernel for {t.device}")
    return True


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
    b, h, w, cso, cu, cd, cf = _shapes(se_fm, skip_h, xc, disp_h, bias, k_fm)
    if not _on_cuda("assemble_z", se_fm):
        return assemble_z_plain(se_fm, skip_h, xc, disp_h, bias, k_fm)
    code, (bias32, kfm32) = _check_cuda(
        "assemble_z", [t for t in (se_fm, skip_h, xc, disp_h) if t is not None],
        [bias, k_fm], cso)
    dev = se_fm.device
    taps, fracs = _tap_tables(h, w, dev)
    cat = torch.empty((b, h, w, cso + cu + cd), dtype=skip_h.dtype, device=dev)
    partial = torch.empty((b, h, cso), dtype=torch.float32, device=dev)
    mean = torch.empty((b, cso), dtype=torch.float32, device=dev)
    _launch("assemble_z", "umt_assemble_z", dev, code, se_fm.data_ptr(),
            _ptr(kfm32), skip_h.data_ptr(), xc.data_ptr(), _ptr(disp_h),
            bias32.data_ptr(), taps.data_ptr(), fracs.data_ptr(),
            cat.data_ptr(), partial.data_ptr(), mean.data_ptr(),
            b, h, w, cso, cu, cd, cf)
    assemble_z.launches += 1
    return cat, mean


def gate_z(cat, gates, cso):
    """Scale ``cat[..., :cso]`` by per-(batch, channel) gates (B, Cso), IN
    PLACE: ``cat`` itself is updated and returned (the JAX package donates
    the buffer to the same effect).  Channels >= cso are not touched.  CPU
    tensors run the plain version; CUDA tensors launch the kernel (and count
    the launch in ``gate_z.launches``) or raise."""
    if cat.ndim != 4 or not 1 <= cso <= cat.shape[3]:
        raise ValueError(f"cso {cso} does not fit cat {tuple(cat.shape)}")
    if tuple(gates.shape) != (cat.shape[0], cso):
        raise ValueError(f"gates {tuple(gates.shape)} are not "
                         f"({cat.shape[0]}, {cso})")
    if not _on_cuda("gate_z", cat):
        return gate_z_plain(cat, gates, cso)
    gates = gates.to(dtype=cat.dtype).contiguous()
    code, _ = _check_cuda("gate_z", [cat, gates], [], cso)
    b, h, w, ccat = cat.shape
    _launch("decoder_fused", "umt_gate_z", cat.device, code, cat.data_ptr(),
            gates.data_ptr(), b, h, w, ccat, cso)
    gate_z.launches += 1
    return cat


def se_squeeze(se_fm, skip_h, bias, k_fm=None):
    """(B, Cso) f32 mean over pixels of ``elu(se_fm + up2(skip_h) + bias)``
    as ``assemble_z`` stores it, without writing it anywhere (``k_fm``: see
    ``assemble_z``).  CPU tensors run the plain version; CUDA tensors launch
    the kernel (and count the launch in ``se_squeeze.launches``) or
    raise."""
    b, h, w, cso, _, _, cf = _shapes(se_fm, skip_h, None, None, bias, k_fm)
    if not _on_cuda("se_squeeze", se_fm):
        return se_squeeze_plain(se_fm, skip_h, bias, k_fm)
    code, (bias32, kfm32) = _check_cuda("se_squeeze", [se_fm, skip_h],
                                        [bias, k_fm], cso)
    dev = se_fm.device
    taps, fracs = _tap_tables(h, w, dev)
    partial = torch.empty((b, h, cso), dtype=torch.float32, device=dev)
    mean = torch.empty((b, cso), dtype=torch.float32, device=dev)
    _launch("decoder_fused", "umt_se_squeeze", dev, code, se_fm.data_ptr(),
            _ptr(kfm32), skip_h.data_ptr(), bias32.data_ptr(), taps.data_ptr(),
            fracs.data_ptr(), partial.data_ptr(), mean.data_ptr(),
            b, h, w, cso, cf)
    se_squeeze.launches += 1
    return mean


def assemble(se_fm, skip_h, gates, xc, disp_h, bias, k_fm=None):
    """The decoder stage's concat tensor written once, already GATED (the
    squeeze_first pipeline: ``se_squeeze`` -> SE MLP -> this):

        concat([elu(se_fm + up2(skip_h) + bias) * gates,   # z, gated
                pixel_shuffle(elu(xc)),                    # phase-major xc
                up2(disp_h)], channels)

    ``gates`` (B, Cso) in the working type; the rest as ``assemble_z``.
    CPU tensors run the plain version; CUDA tensors launch the kernel (and
    count the launch in ``assemble.launches``) or raise."""
    b, h, w, cso, cu, cd, cf = _shapes(se_fm, skip_h, xc, disp_h, bias, k_fm,
                                       gates)
    if not _on_cuda("assemble", se_fm):
        return assemble_plain(se_fm, skip_h, gates, xc, disp_h, bias, k_fm)
    gates = gates.to(dtype=skip_h.dtype).contiguous()
    code, (bias32, kfm32) = _check_cuda(
        "assemble", [t for t in (se_fm, skip_h, gates, xc, disp_h)
                     if t is not None], [bias, k_fm], cso)
    dev = se_fm.device
    taps, fracs = _tap_tables(h, w, dev)
    cat = torch.empty((b, h, w, cso + cu + cd), dtype=skip_h.dtype, device=dev)
    _launch("decoder_fused", "umt_assemble", dev, code, se_fm.data_ptr(),
            _ptr(kfm32), skip_h.data_ptr(), gates.data_ptr(), xc.data_ptr(),
            _ptr(disp_h), bias32.data_ptr(), taps.data_ptr(),
            fracs.data_ptr(), cat.data_ptr(), b, h, w, cso, cu, cd, cf)
    assemble.launches += 1
    return cat


assemble_z.launches = 0
gate_z.launches = 0
se_squeeze.launches = 0
assemble.launches = 0
