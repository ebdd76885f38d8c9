"""The arithmetic the plain reference computes its products in.

Every conv, linear layer and matrix product of the reference goes through a
``Precision``.  ``F32`` computes them in float32 as they stand (the caller
turns TF32 off).  ``Rounded("tf32")`` and ``Rounded("fp8")`` are the
controls: the same reference with each product's operands rounded to the
next precision below the configuration's, products summed in float32.

* ``tf32``: 10 explicit mantissa bits, round to nearest even, as the
  tensor cores take float32 operands in TF32 mode.  The rounding is applied
  to the forward operands and, through ``_RoundGrad``, to the gradient that
  reaches each product's output, so the backward's products see TF32
  operands as well.
* ``fp8``: float8 e4m3 with one scale per tensor (its largest magnitude
  mapped to 448), forward only (the serving control).

Emulating the rounding, rather than switching a library's TF32 mode on,
keeps the control the same on a CPU, where no TF32 mode exists.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10 mantissa bits, to nearest
    even; infinities and NaNs pass through."""
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(t), rounded, t).view_as(t)


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` through float8 e4m3 with one scale for the tensor."""
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


class _RoundGrad(torch.autograd.Function):
    """Identity forward; the incoming gradient rounded to TF32."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return round_tf32(grad)


class F32:
    """Products in float32 as they stand."""

    name = "f32"

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def output(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def conv(self, x, w, b=None, stride=1, padding=0):
        return self.output(F.conv2d(self.operand(x), self.operand(w), b,
                                    stride, padding))

    def linear(self, x, w):
        return self.output(F.linear(self.operand(x), self.operand(w)))

    def einsum(self, equation, a, b):
        return self.output(torch.einsum(equation, self.operand(a),
                                        self.operand(b)))


class Rounded(F32):
    """Products with their operands rounded to ``fmt`` ("tf32" or
    "fp8"), summed in float32."""

    def __init__(self, fmt: str):
        if fmt not in ("tf32", "fp8"):
            raise ValueError(f"no control precision {fmt!r}")
        self.name = fmt

    def operand(self, t):
        rounded = round_tf32(t) if self.name == "tf32" else round_fp8(t)
        if not t.requires_grad:
            return rounded
        # the rounded value forward; the gradient passes to ``t`` as it is
        return t + (rounded - t).detach()

    def output(self, t):
        if self.name == "tf32" and t.requires_grad:
            return _RoundGrad.apply(t)
        return t


def precision(name: str) -> F32:
    """The ``Precision`` named ``name``: "f32", "tf32" or "fp8"."""
    return F32() if name == "f32" else Rounded(name)
