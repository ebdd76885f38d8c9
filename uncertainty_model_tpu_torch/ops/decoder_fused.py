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
gate_z(assemble_z(), g)`` bit for bit.  up2 takes the exact fractions in
f32 and, in bf16, the JAX package's bf16-rounded weights
(``resize.bf16_weights``); the fold sums its terms in order.  The kernels'
tilings are planned here (``plan_rows``, ``plan_gate_z``), from shapes
alone, so that the CPU tests reach them.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import hand
from .resize import (bf16_weights, lerp_taps, resize_bf16_weights,
                     resize_bilinear)
from .shuffle import shuffle_phase_major

_MAX_CSO = 1024  # a row block of one channel a thread holds Cso threads


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


def _up2(x, h, w):
    """The glue's 2x upsample of ``x`` to (h, w), in f32 and not rounded:
    f32 with the exact fractions (``resize_bilinear``); bf16 with the JAX
    package's bf16 weights (``resize_bf16_weights``)."""
    if x.dtype == torch.bfloat16:
        return resize_bf16_weights(x, (h, w))
    return resize_bilinear(x.float(), (h, w))


def _fold(fm, k_fm):
    """``sum_ci fm[..., ci] * k_fm[ci]`` in f32, in order, each product and
    sum rounded on its own (the kernel's order; a matmul would sum in its
    own)."""
    fm, k = fm.float(), k_fm.float()
    se = fm[..., 0:1] * k[0]
    for ci in range(1, k.shape[0]):
        se = se + fm[..., ci:ci + 1] * k[ci]
    return se


def _z_plain(se_fm, skip_h, bias, k_fm):
    """z = elu(se + up2(skip_h) + bias), computed in f32 (the fold too, as
    ``_fold_fallback`` in the JAX package does) and cast once to the
    operands' type."""
    h, w = se_fm.shape[1], se_fm.shape[2]
    se = se_fm.float() if k_fm is None else _fold(se_fm, k_fm)
    se = se + _up2(skip_h, h, w) + bias.float()
    return F.elu(se).to(skip_h.dtype)


def _cat_plain(z, xc, disp_h):
    dt = z.dtype
    h, w = z.shape[1], z.shape[2]
    parts = [z, shuffle_phase_major(F.elu(xc.float())).to(dt)]
    if disp_h is not None:
        parts.append(_up2(disp_h, h, w).to(dt))
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


# ---------------------------------------------------------------------------
# the kernels' plans (shapes only; the C side checks them again)

ROW_THREADS = 256        # a row block's threads where Cso allows
ROW_BLOCKS_PER_SM = 2    # csrc/decoder_rows.cuh::kRowBlocksPerSM (16-byte vectors)
SM_SMEM = 233_472        # bytes of shared memory an SM (1 KB a block reserved)
MAX_SMEM = 232_448       # bytes a block can take on an H100
SKIP_SHARE = 0.45        # of a block's shared memory, for the staged skip rows
ROW_MODES = {"assemble_z": 0, "se_squeeze": 1, "assemble": 2}


class RowPlan(NamedTuple):
    """A row-kernel launch: blocks of ``rows`` output rows (a pair) by
    ``cols`` output columns, ``halo_cols`` half-resolution columns staged a
    skip row, ``threads`` threads taking ``vec`` z channels each,
    ``smem`` bytes of shared memory and ``tiles`` column tiles a row
    pair."""
    rows: int
    cols: int
    halo_cols: int
    threads: int
    vec: int
    smem: int
    tiles: int


def _align16(n):
    return (n + 15) // 16 * 16


def _row_smem(mode, itemsize, cols, halo, cso, cu, cd, cf, threads, vec):
    """``csrc/decoder_rows.cuh::RowSmem``'s count: skip rows, disparity
    rows and the output row (not in se_squeeze), k_fm, the SE sums (not in
    assemble), the mbarrier."""
    writes = mode != ROW_MODES["se_squeeze"]
    total = _align16(3 * halo * cso * itemsize)
    if writes:
        total += (_align16(3 * halo * cd * itemsize)
                  + _align16(cols * (cso + cu + cd) * itemsize))
    total += _align16(cf * cso * 4)
    if mode != ROW_MODES["assemble"]:
        total += _align16(threads * vec * 4)
    return total + 16


@functools.lru_cache(maxsize=None)
def plan_rows(h, w, cso, cu, cd, cf, itemsize, mode, se_aligned=True
              ) -> RowPlan:
    """Tile the row kernel for one stage: a row pair a block; threads of
    16-byte vectors of z channels where Cso and se_fm's alignment allow
    (else one channel a thread); a block's shared memory sized for the
    blocks an SM its registers allow (``ROW_BLOCKS_PER_SM``, or one); all W columns where the staged
    skip rows take at most ``SKIP_SHARE`` of that, else even column tiles
    halved until they do, whatever the mode, so that ``se_squeeze`` sums
    its means in ``assemble_z``'s order; halved further only where the
    whole block would not fit.  ``se_aligned``: se_fm starts on 16 bytes.
    (The kernel takes skip_h's rows by bulk copies, and xc 16 bytes at a
    time, where their alignment allows.)"""
    mode = ROW_MODES[mode]
    full = 16 // itemsize
    vec = full if cso % full == 0 and (cf or se_aligned) else 1
    g = cso // vec
    threads = g * max(1, ROW_THREADS // g)
    budget = SM_SMEM // (ROW_BLOCKS_PER_SM if vec > 1 else 1) - 1024

    def halo(cols):
        return min(cols // 2 + 2, w // 2)

    def halve(cols):
        return max(2, (cols // 2 + 1) // 2 * 2)

    cols = w
    while cols > 2 and 3 * itemsize * halo(cols) * cso > SKIP_SHARE * budget:
        cols = halve(cols)
    while True:
        smem = _row_smem(mode, itemsize, cols, halo(cols), cso, cu, cd, cf,
                         threads, vec)
        if smem <= budget or cols <= 2:
            break
        cols = halve(cols)
    if smem > MAX_SMEM:
        raise ValueError(f"a row block of {cols} columns needs {smem} bytes "
                         f"of shared memory, more than {MAX_SMEM}")
    return RowPlan(2, cols, halo(cols), threads, vec, smem, -(-w // cols))


def row_staging(plan, h, w):
    """The kernel's staging windows: for each output row its staged skip
    rows' first index (rows r0, r0+1, r0+2, clamped), and for each output
    column its tile's first staged column and the count staged."""
    h2, w2 = h // 2, w // 2
    r0 = np.maximum(np.arange(h) // 2 - 1, 0)
    c0 = np.arange(w) // plan.cols * plan.cols
    wcur = np.minimum(plan.cols, w - c0)
    s0 = np.maximum(c0 // 2 - 1, 0)
    ncur = np.minimum((c0 + wcur) // 2, w2 - 1) - s0 + 1
    return np.minimum(r0, h2 - 1), s0, ncur


GATE_THREADS = 256
GATE_IN_FLIGHT = 4        # vectors a thread loads before it stores


class GatePlan(NamedTuple):
    """A ``gate_z`` launch: ``threads`` a block, ``vec`` elements a 16-byte
    vector, ``in_flight`` vectors a thread loads at a time.  The grid is a
    row of blocks a batch's slab, each over an equal chunk of it, as many
    blocks in all as the card holds at once (the C side asks the card: 132
    SMs on an H100)."""
    threads: int
    vec: int
    in_flight: int


@functools.lru_cache(maxsize=None)
def plan_gate_z(b, h, w, ccat, itemsize) -> GatePlan:
    """``gate_z``'s launch for a (B, H, W, Ccat) concat tensor; each block
    tabulates, for every channel a vector may start at, its lanes' gates
    (f32) and z-lane mask."""
    n = h * w * ccat
    if n >= 2 ** 31 - 16:
        raise ValueError(f"gate_z takes slabs of fewer than 2^31 elements, "
                         f"not {n}")
    vec = 16 // itemsize
    if ccat * (4 * vec + 1) > MAX_SMEM:   # its gate and lane tables
        raise ValueError(f"gate_z's tables for {ccat} channels do not fit "
                         f"a block's shared memory")
    return GatePlan(GATE_THREADS, vec, GATE_IN_FLIGHT)


def gate_z_chunk(plan, n, per_batch):
    """The C side's chunk of a slab of ``n`` elements cut for ``per_batch``
    blocks (a whole number of vectors), and the blocks that takes."""
    vectors = -(-n // plan.vec)
    chunk = -(-vectors // per_batch) * plan.vec
    return chunk, -(-n // chunk)


def gate_z_walk(plan, n, ccat, cso, misalign=0, per_batch=3):
    """A model of ``gate_z``'s walk over one batch's slab of ``n`` elements
    whose start lies ``misalign`` elements past a 16-byte boundary, cut for
    ``per_batch`` blocks: how many times each element is stored (each
    chunk's ragged head and tail element by element, its 16-byte vectors
    in between, a vector's z lanes only, the lane's channel carried from
    the thread's first vector by a fixed step)."""
    ve = plan.vec
    stores = np.zeros(n, np.int64)
    chunk, blocks = gate_z_chunk(plan, n, per_batch)
    for k in range(blocks):
        lo = k * chunk
        hi = min(lo + chunk, n)
        a0 = min(lo + (ve - (misalign + lo) % ve) % ve, hi)
        a1 = max(hi - (misalign + hi) % ve, a0)
        for f in (np.arange(lo, a0), np.arange(a1, hi)):
            np.add.at(stores, f[f % ccat < cso], 1)
        nv = (a1 - a0) // ve
        t = np.arange(nv)
        # vector t is thread t % threads's (t // threads)-th: its first
        # lane's channel by the kernel's running step
        thread, step = t % plan.threads, t // plan.threads
        c0 = ((a0 + thread * ve) % ccat + step * (plan.threads * ve % ccat)) % ccat
        channel = (c0[:, None] + np.arange(ve)[None, :]) % ccat
        lanes = a0 + ve * t[:, None] + np.arange(ve)[None, :]
        np.add.at(stores, lanes[channel < cso], 1)
        # the carried channel is the lane's true one
        assert (channel == lanes % ccat).all()
    return stores


@functools.lru_cache(maxsize=None)
def tap_table(h: int, w: int, bf16: bool) -> np.ndarray:
    """The row kernel's tap table for an (H, W) output: int32 (H + W, 4),
    per output row, then per output column, (lo, hi, a, b) with the f32
    weights a and b as their bits.  f32: ``lerp_taps`` and a = frac (the
    exact lerp; b unused); bf16: ``bf16_weights``, a = bf16(1 - frac) and
    b = bf16(frac)."""
    parts = []
    for out in (h, w):
        if bf16:
            lo, hi, wa, wb = bf16_weights(out, out // 2)
        else:
            lo, hi, wa = lerp_taps(out, out // 2)
            wb = np.zeros_like(wa)
        parts.append(np.stack([lo.astype(np.int32), hi.astype(np.int32),
                               wa.astype(np.float32).view(np.int32),
                               wb.astype(np.float32).view(np.int32)], axis=1))
    return np.concatenate(parts)


@functools.lru_cache(maxsize=None)
def _tap_tables(h: int, w: int, dtype: torch.dtype, device: torch.device):
    """:func:`tap_table` on ``device`` (made once a shape, so that a CUDA
    graph can capture the calls that read it)."""
    return torch.from_numpy(tap_table(h, w, dtype == torch.bfloat16)).to(device)


def _kernel_operands(name, tensors, floats, cso):
    """The glue kernels' CUDA operands: ``tensors`` ({name: tensor or
    None}) by ``hand.check``, unaligned ones too (the kernels copy them in
    narrower pieces); Cso within a block; ``floats`` made f32.  Returns
    (dtype code, the f32 tensors)."""
    code = hand.check(name, tensors)
    if cso > _MAX_CSO:
        raise ValueError(f"{name} kernel takes at most {_MAX_CSO} z channels, "
                         f"not {cso}")
    return code, [None if t is None else t.float().contiguous()
                  for t in floats]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _row_plan(mode, h, w, cso, cu, cd, cf, se_fm, skip_h):
    plan = plan_rows(h, w, cso, cu, cd, cf, skip_h.element_size(), mode,
                     se_fm.data_ptr() % 16 == 0)
    return plan, (plan.cols, plan.halo_cols, plan.threads, plan.vec,
                  plan.smem)


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
    return hand.run(
        assemble_z, (se_fm, k_fm, skip_h, xc, disp_h, bias),
        lambda: assemble_z_plain(se_fm, skip_h, xc, disp_h, bias, k_fm),
        lambda: _assemble_z_kernel(se_fm, skip_h, xc, disp_h, bias, k_fm,
                                   dims),
        outputs=tuple)


def _assemble_z_kernel(se_fm, skip_h, xc, disp_h, bias, k_fm, dims):
    b, h, w, cso, cu, cd, cf = dims
    code, (bias32, kfm32) = _kernel_operands(
        "assemble_z", {"se_fm": se_fm, "skip_h": skip_h, "xc": xc,
                       "disp_h": disp_h}, [bias, k_fm], cso)
    dev = se_fm.device
    plan, plan_args = _row_plan("assemble_z", h, w, cso, cu, cd, cf, se_fm,
                                skip_h)
    taps = _tap_tables(h, w, skip_h.dtype, dev)
    cat = torch.empty((b, h, w, cso + cu + cd), dtype=skip_h.dtype, device=dev)
    partial = torch.empty((b, h // 2 * plan.tiles, cso), dtype=torch.float32,
                          device=dev)
    mean = torch.empty((b, cso), dtype=torch.float32, device=dev)
    count = torch.zeros(b, dtype=torch.int32, device=dev)
    hand.launch(assemble_z, "umt_assemble_z", dev, code, se_fm.data_ptr(),
                _ptr(kfm32), skip_h.data_ptr(), xc.data_ptr(), _ptr(disp_h),
                bias32.data_ptr(), taps.data_ptr(), cat.data_ptr(),
                partial.data_ptr(), mean.data_ptr(), count.data_ptr(),
                b, h, w, cso, cu, cd, cf, *plan_args)
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
    z = cat[..., :cso]   # read and written: counted on both sides
    return hand.run(gate_z, (z, gates), lambda: gate_z_plain(cat, gates, cso),
                    lambda: _gate_z_kernel(cat, gates, cso),
                    outputs=lambda _: (z,))


def _gate_z_kernel(cat, gates, cso):
    gates = gates.to(dtype=cat.dtype).contiguous()
    code, _ = _kernel_operands("gate_z", {"cat": cat, "gates": gates}, [],
                               cso)
    b, h, w, ccat = cat.shape
    plan_gate_z(b, h, w, ccat, cat.element_size())   # the shape checks
    hand.launch(gate_z, "umt_gate_z", cat.device, code, cat.data_ptr(),
                gates.data_ptr(), b, h * w * ccat, ccat, cso)
    return cat


def se_squeeze(se_fm, skip_h, bias, k_fm=None):
    """(B, Cso) f32 mean over pixels of ``elu(se_fm + up2(skip_h) + bias)``
    as ``assemble_z`` stores it, without writing it anywhere (``k_fm``: see
    ``assemble_z``).  CPU tensors run the plain version; CUDA tensors launch
    the kernel (and count the launch in ``se_squeeze.launches``) or
    raise."""
    dims = _shapes(se_fm, skip_h, None, None, bias, k_fm)
    return hand.run(
        se_squeeze, (se_fm, k_fm, skip_h, bias),
        lambda: se_squeeze_plain(se_fm, skip_h, bias, k_fm),
        lambda: _se_squeeze_kernel(se_fm, skip_h, bias, k_fm, dims))


def _se_squeeze_kernel(se_fm, skip_h, bias, k_fm, dims):
    b, h, w, cso, _, _, cf = dims
    code, (bias32, kfm32) = _kernel_operands(
        "se_squeeze", {"se_fm": se_fm, "skip_h": skip_h}, [bias, k_fm], cso)
    dev = se_fm.device
    plan, plan_args = _row_plan("se_squeeze", h, w, cso, 0, 0, cf, se_fm,
                                skip_h)
    taps = _tap_tables(h, w, skip_h.dtype, dev)
    partial = torch.empty((b, h // 2 * plan.tiles, cso), dtype=torch.float32,
                          device=dev)
    mean = torch.empty((b, cso), dtype=torch.float32, device=dev)
    count = torch.zeros(b, dtype=torch.int32, device=dev)
    hand.launch(se_squeeze, "umt_se_squeeze", dev, code, se_fm.data_ptr(),
                _ptr(kfm32), skip_h.data_ptr(), bias32.data_ptr(),
                taps.data_ptr(), partial.data_ptr(), mean.data_ptr(),
                count.data_ptr(), b, h, w, cso, cf, *plan_args)
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
    dims = _shapes(se_fm, skip_h, xc, disp_h, bias, k_fm, gates)
    return hand.run(
        assemble, (se_fm, k_fm, skip_h, gates, xc, disp_h, bias),
        lambda: assemble_plain(se_fm, skip_h, gates, xc, disp_h, bias, k_fm),
        lambda: _assemble_kernel(se_fm, skip_h, gates, xc, disp_h, bias,
                                 k_fm, dims))


def _assemble_kernel(se_fm, skip_h, gates, xc, disp_h, bias, k_fm, dims):
    b, h, w, cso, cu, cd, cf = dims
    gates = gates.to(dtype=skip_h.dtype).contiguous()
    code, (bias32, kfm32) = _kernel_operands(
        "assemble", {"se_fm": se_fm, "skip_h": skip_h, "gates": gates,
                     "xc": xc, "disp_h": disp_h}, [bias, k_fm], cso)
    dev = se_fm.device
    _, plan_args = _row_plan("assemble", h, w, cso, cu, cd, cf, se_fm, skip_h)
    taps = _tap_tables(h, w, skip_h.dtype, dev)
    cat = torch.empty((b, h, w, cso + cu + cd), dtype=skip_h.dtype, device=dev)
    hand.launch(assemble, "umt_assemble", dev, code, se_fm.data_ptr(),
                _ptr(kfm32), skip_h.data_ptr(), gates.data_ptr(),
                xc.data_ptr(), _ptr(disp_h), bias32.data_ptr(),
                taps.data_ptr(), cat.data_ptr(), b, h, w, cso, cu, cd, cf,
                *plan_args)
    return cat


assemble_z.launches = 0
gate_z.launches = 0
se_squeeze.launches = 0
assemble.launches = 0
