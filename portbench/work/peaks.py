"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit), and the least time of a piece of
work."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12
F32_FLOP_PER_S = 67e12      # float32 outside the tensor cores (TF32 off)

DTYPE_PEAKS = {"bfloat16": BF16_FLOP_PER_S, "float32": F32_FLOP_PER_S}


def bound(nbytes: float, ops: float, flop_per_s: float = F32_FLOP_PER_S):
    """The least seconds for ``nbytes`` at the memory rate and ``ops`` at
    ``flop_per_s``, and which of the two bounds it."""
    bytes_s = nbytes / HBM_BYTES_PER_S
    ops_s = ops / flop_per_s
    return max(bytes_s, ops_s), "bytes" if bytes_s >= ops_s else "operations"
