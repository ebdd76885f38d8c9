"""Stride-1 conv + bias + ELU (the port of the JAX package's
``ops/pallas/conv.py``): ``gated_conv_elu``, the gated interior conv of the
space-to-depth encoder stages, and ``conv_elu``, the SAME zero-pad conv of
one unpadded input.

On CUDA tensors both wrappers launch the hand-written Hopper kernel
``csrc/gated_conv_elu.cu`` (``conv_elu`` is its ungated compile-time mode);
on CPU tensors they run :func:`gated_conv_elu_plain` and
:func:`conv_elu_plain`, the same functions in plain PyTorch, which the tests
hold against the JAX package and ``chip_smoke.py`` holds the kernel against
on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import weakref

import torch
import torch.nn.functional as F

from . import hand

_CHANNEL_MULTIPLE = {torch.float32: 4, torch.bfloat16: 16}  # the kernel's tiles
_SMEM_LIMIT = 232448  # shared memory a block may use on the card
_MAX_INPUTS = 4
_TILE_M = 256                     # bf16: output pixels a block, rows x tw
_TILE_WIDTHS = (32, 16, 8)        # bf16: output columns a block
_N_TILES = (32, 64, 128)          # bf16: output channels a block (wgmma N)
_MAX_STAGES = 8                   # bf16: weight slices in flight
_MAX_RING = 8                     # bf16 gated: raw input pieces in flight + 1


def _kernel_dims(w, b):
    """Validate an odd square HWIO kernel and its bias; return (k, C, Co)."""
    if w.ndim != 4 or w.shape[0] != w.shape[1] or w.shape[0] % 2 == 0:
        raise ValueError(f"w {tuple(w.shape)} is not an odd square HWIO kernel")
    k, _, c, co = w.shape
    if tuple(b.shape) != (co,):
        raise ValueError(f"bias {tuple(b.shape)} is not ({co},)")
    return k, c, co


def _shapes(xs, gates, w, b, width):
    """Validate the operands; return (n, B, H, Wp, W, C, Co, k)."""
    n = len(xs)
    if not 1 <= n <= _MAX_INPUTS:
        raise ValueError(f"gated_conv_elu takes 1 to {_MAX_INPUTS} inputs, "
                         f"not {n}")
    k, c, co = _kernel_dims(w, b)
    p = (k - 1) // 2
    if any(x.ndim != 4 or x.shape != xs[0].shape for x in xs):
        raise ValueError("gated_conv_elu inputs must share one NHWC shape, not "
                         f"{[tuple(x.shape) for x in xs]}")
    b_, hp, wp, cin = xs[0].shape
    if cin != c or hp <= 2 * p:
        raise ValueError(f"inputs {tuple(xs[0].shape)} do not fit the kernel "
                         f"{tuple(w.shape)}")
    if width is None:
        width = wp - 2 * p
    if not 1 <= width <= wp - 2 * p:
        raise ValueError(f"width {width} does not fit padded width {wp}")
    if gates.numel() != n:
        raise ValueError(f"{gates.numel()} gates for {n} inputs")
    return n, b_, hp - 2 * p, wp, width, c, co, k


def _conv_elu_shapes(x, w, b):
    """Validate ``conv_elu``'s operands; return (B, H, W, C, Co, k)."""
    k, c, co = _kernel_dims(w, b)
    if x.ndim != 4 or x.shape[3] != c:
        raise ValueError(f"input {tuple(x.shape)} is not NHWC with the "
                         f"kernel's {c} channels")
    return (*x.shape, co, k)


def gated_sum(xs, gates):
    """``sum_i gates[i] * xs[i]`` in the inputs' type, in the JAX package's
    order: the gates cast to that type, then each product and each running
    sum rounded to it."""
    g = gates.to(xs[0].dtype)
    h = g[0] * xs[0]
    for i in range(1, len(xs)):
        h = h + g[i] * xs[i]
    return h


def gated_conv_elu_plain(xs, gates, w, b, width=None):
    """Plain PyTorch ``gated_conv_elu``: the gated sum as :func:`gated_sum`,
    then the VALID conv, bias and ELU in f32 with one rounding to the
    inputs' type at the end (the Pallas kernel's epilogue)."""
    dims = _shapes(xs, gates, w, b, width)
    p = (w.shape[0] - 1) // 2
    h = gated_sum(xs, gates)[:, :, :dims[4] + 2 * p]
    y = F.conv2d(h.permute(0, 3, 1, 2).float(),
                 w.permute(3, 2, 0, 1).float(), b.float())
    return F.elu(y).permute(0, 2, 3, 1).to(xs[0].dtype).contiguous()


def conv_elu_plain(x, w, b):
    """Plain PyTorch ``conv_elu``: the SAME zero-pad conv, bias and ELU in
    f32 with one rounding to the input's type at the end (the Pallas
    kernel's epilogue)."""
    _conv_elu_shapes(x, w, b)
    p = (w.shape[0] - 1) // 2
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), w.permute(3, 2, 0, 1).float(),
                 b.float(), padding=p)
    return F.elu(y).permute(0, 2, 3, 1).to(x.dtype).contiguous()


def conv_magnitude(xs, gates, w, width=None):
    """Per output (B, H, W, Co), the sum of the magnitudes of the conv's
    terms, |gated sum| convolved with |w| in f32: the scale of the rounding
    an f32 sum of those terms in any order can carry (for tolerances)."""
    p = (w.shape[0] - 1) // 2
    width = _shapes(xs, gates, w, w.new_zeros(w.shape[3]), width)[4]
    h = gated_sum(xs, gates)[:, :, :width + 2 * p]
    y = F.conv2d(h.permute(0, 3, 1, 2).float().abs(),
                 w.permute(3, 2, 0, 1).float().abs())
    return y.permute(0, 2, 3, 1)


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """How the kernel tiles one conv: a block owns ``rows`` x ``tw`` output
    pixels by ``n`` output channels and runs its K loop over ``kc``-channel
    chunks with ``stages`` weight slices in flight; gated, its halo stager
    keeps ``ring`` - 1 pieces of raw input in flight (0 in the plain mode);
    it needs ``smem`` bytes of shared memory.  (f32: the CUDA-core kernel's
    fixed 1 x 32 pixels by 64 channels, the whole C staged at once.)"""

    rows: int
    tw: int
    n: int
    kc: int
    stages: int
    ring: int
    smem: int


def _align1024(v):
    return -(-v // 1024) * 1024


def _tc_smem(rows, tw, n, kc, stages, k, inputs, ring):
    """The bf16 kernel's shared memory (``csrc/gated_conv_elu.cu::tc_smem``):
    1024 bytes of alignment slack, the ring of ``stages`` weight slices
    (n x kc bf16 each), two halo chunks ((rows+k-1) x (tw+k-1) pixels,
    rounded up to 8, by kc bf16 each), the gated stager's ring of ``ring``
    raw pieces (``inputs`` x (128 // inputs rounded down to 8) pixels by kc
    bf16 each; none in the plain mode, ``inputs`` = 0), each rounded up to
    1024 bytes, and the barriers."""
    pixels = -(-(rows + k - 1) * (tw + k - 1) // 8) * 8
    scratch = (_align1024(ring * inputs * (128 // inputs & ~7) * kc * 2)
               if inputs else 0)
    return (1024 + stages * _align1024(n * kc * 2)
            + 2 * _align1024(pixels * kc * 2) + scratch
            + 8 * (2 * stages + 4))


def plan_conv(name, dtype, h, w, c, co, k, inputs=0):
    """The kernel's tiling for an (H, W) output of ``co`` channels from
    ``c`` with a k x k kernel, gated over ``inputs`` inputs (0: the plain
    mode), or ValueError where it cannot take it: channel counts off its
    tiles, or more shared memory than a block has.

    bf16: the output tile of 256 pixels whose (rows, tw) wastes the fewest
    pixels past the edges, then stages the fewest halo pixels; N the
    smallest wgmma width >= Co (128 above it); chunks of 64 channels, or 32
    or 16 where C is not a multiple; plain: as many weight slices in flight
    as shared memory holds, up to 8; gated: the same, leaving room for a
    ring of at least 3 raw input pieces, then as deep a ring as fits, up
    to 8."""
    mult = _CHANNEL_MULTIPLE[dtype]
    if c % mult or co % mult:
        raise ValueError(f"{name} kernel takes {dtype} channel counts that "
                         f"are multiples of {mult}, not {c} -> {co}")
    if dtype == torch.float32:
        smem = k * (32 + k - 1) * (c + 4) * 4
        plans = [ConvPlan(1, 32, 64, c, 0, 0, smem)]
    else:
        kc = next(t for t in (64, 32, 16) if c % t == 0)
        n = next((t for t in _N_TILES if t >= co), _N_TILES[-1])
        tiles = sorted(_TILE_WIDTHS, key=lambda tw: (
            -(-h // (_TILE_M // tw)) * -(-w // tw),
            (_TILE_M // tw + k - 1) * (tw + k - 1)))
        if inputs:
            depths = [(st, ring) for st in range(_MAX_STAGES, 1, -1)
                      for ring in range(_MAX_RING, 2, -1)]
        else:
            depths = [(st, 0) for st in range(_MAX_STAGES, 1, -1)]
        plans = [ConvPlan(_TILE_M // tw, tw, n, kc, st, ring,
                          _tc_smem(_TILE_M // tw, tw, n, kc, st, k, inputs,
                                   ring))
                 for tw in tiles for st, ring in depths]
    for plan in plans:
        if plan.smem <= _SMEM_LIMIT:
            return plan
    smem = min(p.smem for p in plans)
    raise ValueError(f"{name} kernel needs {smem} bytes of shared memory for "
                     f"k={k}, C={c}; a block has {_SMEM_LIMIT}")


def pack_weights(w, n, kc):
    """The bf16 kernel's weight layout: HWIO ``w`` (k, k, C, Co), Co
    zero-padded to a multiple of ``n``, as slices (Co tile, C chunk, tap)
    of n x kc (K-major: each output channel's kc inputs contiguous), each
    slice's 16-byte units swizzled as wgmma reads them (unit u of a row of
    kc * 2 bytes at u ^ ((u >> 3) & (kc / 8 - 1))).  Returns a flat
    tensor."""
    k, _, c, co = w.shape
    tiles = -(-co // n)
    wp = F.pad(w, (0, tiles * n - co))
    wp = wp.reshape(k * k, c // kc, kc, tiles, n).permute(3, 1, 0, 4, 2)
    units = wp.reshape(-1, n * kc // 8, 8)
    u = torch.arange(n * kc // 8, device=w.device)
    return units[:, u ^ ((u >> 3) & (kc // 8 - 1))].reshape(-1).contiguous()


_PACKED = {}


def _packed_weights(w, plan):
    """``pack_weights`` of ``w`` for ``plan``, made once per weight tensor
    (and again if it is modified in place): a serving forward's weights are
    packed on its first call, not in every call."""
    key = (id(w), plan.n, plan.kc)
    hit = _PACKED.get(key)
    if hit is not None and hit[0]() is w and hit[1] == w._version:
        return hit[2]
    packed = pack_weights(w, plan.n, plan.kc)
    _PACKED[key] = (weakref.ref(w, lambda _, key=key: _PACKED.pop(key, None)),
                    w._version, packed)
    return packed


def _kernel_operands(name, xs, w, b, h, width, c, co, k, gated):
    """Check the CUDA operands both modes share and plan the launch; return
    (dtype code, the kernel's weights, the f32 bias, the plan as seven C
    ints)."""
    code = hand.check(name, {**{f"xs[{i}]": x for i, x in enumerate(xs)},
                             "w": w}, aligned=True)
    b = b.float().contiguous()
    hand.check(name, {"b": b}, aligned=True, dtypes=hand.F32)
    plan = plan_conv(name, w.dtype, h, width, c, co, k,
                     len(xs) if gated else 0)
    if w.dtype == torch.bfloat16:
        w = _packed_weights(w, plan)
    fields = (ctypes.c_int * 7)(*dataclasses.astuple(plan))
    return code, w, b, fields


def _gated_conv_elu_kernel(xs, gates, w, b, dims):
    n, batch, h, wp, width, c, co, k = dims
    code, w, b, plan = _kernel_operands("gated_conv_elu", xs, w, b, h, width,
                                        c, co, k, gated=True)
    dev = xs[0].device
    gates = gates.to(dtype=xs[0].dtype).contiguous()
    out = torch.empty((batch, h, width, co), dtype=xs[0].dtype, device=dev)
    ptrs = (ctypes.c_void_p * _MAX_INPUTS)(
        *[x.data_ptr() for x in xs], *([None] * (_MAX_INPUTS - n)))
    hand.launch(gated_conv_elu, "umt_gated_conv_elu", dev, code,
                ctypes.cast(ptrs, ctypes.c_void_p), gates.data_ptr(),
                w.data_ptr(), b.data_ptr(), out.data_ptr(), n, batch, h, wp,
                width, c, co, k, ctypes.cast(plan, ctypes.c_void_p))
    return out


def _conv_flops(batch, h, width, c, co, k) -> int:
    """2 x MACs of a k x k conv from C to Co channels writing (batch, h,
    width) pixels (the gated sum and the ELU are not counted: elementwise
    work, as the JAX tool counts it)."""
    return 2 * batch * h * width * co * k * k * c


def gated_conv_elu(xs, gates, w, b, width=None):
    """``ELU(conv(sum_i gates[i] * xs[i], w) + b)`` on PRE-PADDED inputs.

    ``xs``: 1 to 4 zero-padded NHWC tensors (B, H+2p, Wp, C) sharing one
    shape (a stage's padded node outputs, shared by every consumer);
    ``Wp`` may exceed W+2p (the JAX package pads to a multiple of 8 for
    the TPU), so ``width`` names the output width W (default Wp - 2p).
    ``gates``: (n,) gate scalars, cast to the inputs' type.  ``w``: HWIO
    (k, k, C, Co); ``b``: (Co,).  Returns (B, H, W, Co).  CPU tensors run
    the plain version; CUDA tensors launch the kernel (and count the launch
    in ``gated_conv_elu.launches``) or raise.
    """
    dims = _shapes(xs, gates, w, b, width)
    _, batch, h, _, out_w, c, co, k = dims
    return hand.run(gated_conv_elu, (*xs, gates, w, b),
                    lambda: gated_conv_elu_plain(xs, gates, w, b, width),
                    lambda: _gated_conv_elu_kernel(xs, gates, w, b, dims),
                    flops=_conv_flops(batch, h, out_w, c, co, k))


def conv_elu(x, w, b):
    """``ELU(conv(x, w) + b)``, the stride-1 SAME zero-pad conv of an
    UNPADDED NHWC ``x`` (B, H, W, C) with an HWIO ``w`` (k, k, C, Co), k
    odd, and a (Co,) bias; returns (B, H, W, Co) in ``x``'s type.  CPU
    tensors run :func:`conv_elu_plain`; CUDA tensors launch the kernel's
    ungated mode, which zero-fills the pad while staging (counted in
    ``conv_elu.launches``), or raise.
    """
    dims = _conv_elu_shapes(x, w, b)
    return hand.run(conv_elu, (x, w, b), lambda: conv_elu_plain(x, w, b),
                    lambda: _conv_elu_kernel(x, w, b, dims),
                    flops=_conv_flops(*dims))


def _conv_elu_kernel(x, w, b, dims):
    batch, h, width, c, co, k = dims
    code, w, b, plan = _kernel_operands("conv_elu", [x], w, b, h, width, c,
                                        co, k, gated=False)
    out = torch.empty((batch, h, width, co), dtype=x.dtype, device=x.device)
    hand.launch(conv_elu, "umt_conv_elu", x.device, code, x.data_ptr(),
                w.data_ptr(), b.data_ptr(), out.data_ptr(), batch, h, width,
                c, co, k, ctypes.cast(plan, ctypes.c_void_p))
    return out


gated_conv_elu.launches = 0
conv_elu.launches = 0
