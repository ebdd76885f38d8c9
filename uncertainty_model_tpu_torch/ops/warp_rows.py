"""The horizontal stereo warp of NHWC rows, ``warp_rows``, and its gradient
(the port of the JAX package's ``ops/pallas/warp.py::warp_rows``).

``warp_rows(x, src)`` samples each row of ``src`` (R, W, C) at the pixel
coordinates ``x`` (R, W) with a 2-tap lerp, zero outside [0, W) (grid_sample
zeros padding).  ``warp_rows_many(xs, srcs)`` does so for a group of such
problems that share C, as one ``torch.autograd.Function``: on CUDA tensors
the forward is one launch of ``csrc/warp_rows.cu``'s forward kernel for up
to 8 problems and the backward one launch of its backward kernel, counted
in ``warp_rows_fwd.launches`` and ``warp_rows_bwd.launches``;
``warp_rows`` is a group of one.  On CPU tensors both directions run the
plain versions problem by problem, :func:`warp_rows_plain` (the gather
form) and :func:`warp_rows_bwd_plain` (its derivative written out), which
the tests hold against the JAX package and ``chip_smoke.py`` holds the
kernels against on the card.
"""

from __future__ import annotations

import array

import torch

from . import hand

# the backward kernel holds a row's dsrc (W * C f32) in one block's shared
# memory
_MAX_SHARED_BYTES = 232_448
# problems a launch takes (csrc/warp_rows.cu, kMaxProblems)
_MAX_PROBLEMS = 8


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


def _check_group(xs, srcs, douts=None) -> None:
    """Check a group's shapes: each problem as :func:`_check`, one C for
    all."""
    if not srcs or len(xs) != len(srcs) or (
            douts is not None and len(douts) != len(srcs)):
        raise ValueError(f"a warp_rows group takes as many x as src (and "
                         f"dout), at least one: {len(xs)} and {len(srcs)}")
    for i, (x, src) in enumerate(zip(xs, srcs)):
        _check(x, src, None if douts is None else douts[i])
    if len({src.shape[2] for src in srcs}) != 1:
        raise ValueError(f"a warp_rows group shares one C, not "
                         f"{sorted({src.shape[2] for src in srcs})}")


def _launch(fn, c_function, problems, c: int) -> None:
    """Launch ``fn``'s kernel, the C function ``c_function``, on
    ``problems``, tuples ``(x, src, dout, out, dx)`` (None where a
    direction does not use one), ``_MAX_PROBLEMS`` a launch; empty
    problems are left out."""
    problems = [p for p in problems if p[1].numel()]
    for i in range(0, len(problems), _MAX_PROBLEMS):
        chunk = problems[i:i + _MAX_PROBLEMS]
        entries = []
        for x, *rest in chunk:
            entries += [0 if t is None else t.data_ptr() for t in (x, *rest)]
            entries += x.shape
        table = array.array("q", entries)  # int64, alive through the call
        hand.launch(fn, c_function, chunk[0][0].device, len(chunk),
                    table.buffer_info()[0], c)


def _check_kernel_operands(fn, **groups) -> None:
    """The kernels' operand rule (float32, contiguous) for ``groups`` of
    tensors by name."""
    hand.check(fn.__name__, {f"{name}[{i}]": t for name, ts in groups.items()
                             for i, t in enumerate(ts)}, dtypes=hand.F32)


def warp_rows_fwd_many(xs, srcs) -> list:
    """The forward of :func:`warp_rows_many` without autograd: the plain
    version problem by problem on CPU tensors, one kernel launch for the
    group on CUDA tensors (or raise)."""
    _check_group(xs, srcs)
    return hand.run(
        warp_rows_fwd, (*xs, *srcs),
        lambda: [warp_rows_plain(x, src) for x, src in zip(xs, srcs)],
        lambda: _warp_rows_fwd_kernel(xs, srcs), outputs=tuple)


def _warp_rows_fwd_kernel(xs, srcs):
    _check_kernel_operands(warp_rows_fwd, xs=xs, srcs=srcs)
    outs = [torch.empty_like(src) for src in srcs]
    _launch(warp_rows_fwd, "umt_warp_rows_fwd",
            [(x, src, None, out, None) for x, src, out in zip(xs, srcs, outs)],
            srcs[0].shape[2])
    return outs


def warp_rows_bwd_many(xs, srcs, douts):
    """``(dxs, dsrcs)`` of :func:`warp_rows_many` for the cotangents
    ``douts``: the plain version problem by problem on CPU tensors, one
    kernel launch for the group on CUDA tensors (or raise)."""
    _check_group(xs, srcs, douts)
    return hand.run(warp_rows_bwd, (*xs, *srcs, *douts),
                    lambda: _warp_rows_bwd_plain(xs, srcs, douts),
                    lambda: _warp_rows_bwd_kernel(xs, srcs, douts),
                    outputs=lambda grads: (*grads[0], *grads[1]))


def _warp_rows_bwd_plain(xs, srcs, douts):
    grads = [warp_rows_bwd_plain(*p) for p in zip(xs, srcs, douts)]
    return [g[0] for g in grads], [g[1] for g in grads]


def _warp_rows_bwd_kernel(xs, srcs, douts):
    _check_kernel_operands(warp_rows_bwd, xs=xs, srcs=srcs, douts=douts)
    c = srcs[0].shape[2]
    for src in srcs:
        if 4 * src.shape[1] * c > _MAX_SHARED_BYTES:
            raise ValueError(f"warp_rows backward holds a row of W*C = "
                             f"{src.shape[1] * c} f32 in shared memory; at "
                             f"most {_MAX_SHARED_BYTES // 4}")
    dxs = [torch.empty_like(x) for x in xs]
    dsrcs = [torch.empty_like(src) for src in srcs]
    _launch(warp_rows_bwd, "umt_warp_rows_bwd",
            list(zip(xs, srcs, douts, dsrcs, dxs)), c)
    return dxs, dsrcs


def warp_rows_fwd(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """The forward of :func:`warp_rows` without autograd (a group of one);
    ``warp_rows_fwd.launches`` counts the forward kernel's launches."""
    return warp_rows_fwd_many([x], [src])[0]


def warp_rows_bwd(x: torch.Tensor, src: torch.Tensor, dout: torch.Tensor):
    """``(dx, dsrc)`` of :func:`warp_rows` (a group of one);
    ``warp_rows_bwd.launches`` counts the backward kernel's launches."""
    dxs, dsrcs = warp_rows_bwd_many([x], [src], [dout])
    return dxs[0], dsrcs[0]


warp_rows_fwd.launches = 0
warp_rows_bwd.launches = 0


class _WarpRowsMany(torch.autograd.Function):
    """The group's operands flattened: ``(n, x_1..x_n, src_1..src_n)``.
    An output that received no gradient gets zeros (materialised grads),
    so the backward is one launch for the whole group."""

    @staticmethod
    def forward(ctx, n, *operands):
        ctx.save_for_backward(*operands)
        return tuple(warp_rows_fwd_many(operands[:n], operands[n:]))

    @staticmethod
    def backward(ctx, *douts):
        operands = ctx.saved_tensors
        n = len(douts)
        dxs, dsrcs = warp_rows_bwd_many(operands[:n], operands[n:],
                                        [d.contiguous() for d in douts])
        return (None, *dxs, *dsrcs)


def warp_rows_many(xs, srcs) -> list:
    """:func:`warp_rows` of each pair ``(xs[i], srcs[i])``, differentiable
    in all of them; on CUDA one launch each way for the group (every src
    has the same C)."""
    return list(_WarpRowsMany.apply(len(xs), *xs, *srcs))


def warp_rows(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Sample each row of ``src`` (R, W, C) at the pixel coordinates ``x``
    (R, W): ``out[r, j] = sum_k max(0, 1 - |x[r, j] - k|) * src[r, k]``,
    differentiable in both.  ``dx`` is in pixel units."""
    return warp_rows_many([x], [src])[0]
