"""Pooling on NHWC tensors (the port of the JAX package's ``ops/pool.py``).

The reference uses stride-1 valid ``AvgPool2d`` in SSIM (3x3) and in the
pooled uncertainty loss, and a global mean in the squeeze-excite layer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def avg_pool2d(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Valid stride-1 average pooling over H and W of an NHWC tensor (the
    NCHW ``permute`` is a view; the window sum is divided by ``k*k`` once,
    as in the JAX package)."""
    out = F.avg_pool2d(x.permute(0, 3, 1, 2), kernel_size, 1)
    return out.permute(0, 2, 3, 1)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Global average over H, W -> (B, C)."""
    return x.mean(dim=(1, 2))
