"""Pooling on NHWC tensors (the port of the JAX package's ``ops/pool.py``).

The reference uses stride-1 valid ``AvgPool2d`` in SSIM (3x3) and in the
pooled uncertainty loss, and a global mean in the squeeze-excite layer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def avg_pool2d(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Valid stride-1 average pooling over H and W of an NHWC tensor (the
    NCHW ``permute`` is a view).  As in the JAX package, the window is
    summed separably, its k rows first and then its k columns, and the sum
    divided by ``k*k`` once, so the pooled values equal the JAX package's
    bit for bit on the CPU (the sparsification curves sort them, and an
    order that differs in the last bit reorders near ties)."""
    k = kernel_size
    summed = F.avg_pool2d(x.permute(0, 3, 1, 2), (k, 1), 1, divisor_override=1)
    summed = F.avg_pool2d(summed, (1, k), 1, divisor_override=1)
    return (summed / (k * k)).permute(0, 2, 3, 1)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Global average over H, W -> (B, C)."""
    return x.mean(dim=(1, 2))
