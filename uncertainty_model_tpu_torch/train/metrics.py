"""Evaluation metrics (the port of the JAX package's ``train/metrics.py``).

``gaussian_ssim`` replicates the torchmetrics
``structural_similarity_index_measure`` used by the reference evaluator
(train/evaluate.py:142-146): gaussian window (size 11, sigma 1.5), statistics
via valid convolution, per-image mean over channels and valid positions.
The reference calls it with ``reduction='sum'``: sum the returned per-image
values for that behaviour.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _gaussian_kernel(kernel_size: int, sigma: float) -> np.ndarray:
    """The 2-D window, built in float64 and cast to float32, as the JAX
    package builds it."""
    coords = np.arange(kernel_size, dtype=np.float64) - (kernel_size - 1) / 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def _depthwise_valid_conv(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Per-channel valid conv of NHWC ``x`` with one shared 2-D window."""
    c = x.shape[-1]
    k = window.expand(c, 1, *window.shape)
    return F.conv2d(x.permute(0, 3, 1, 2), k, groups=c).permute(0, 2, 3, 1)


def gaussian_ssim(pred: torch.Tensor, target: torch.Tensor,
                  kernel_size: int = 11, sigma: float = 1.5,
                  data_range: float = 1.0, k1: float = 0.01,
                  k2: float = 0.03) -> torch.Tensor:
    """Per-image SSIM of NHWC batches -> (B,) values."""
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    window = torch.from_numpy(_gaussian_kernel(kernel_size, sigma)).to(
        device=pred.device, dtype=pred.dtype)

    mu_x = _depthwise_valid_conv(pred, window)
    mu_y = _depthwise_valid_conv(target, window)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y

    sigma_x = _depthwise_valid_conv(pred * pred, window) - mu_xx
    sigma_y = _depthwise_valid_conv(target * target, window) - mu_yy
    sigma_xy = _depthwise_valid_conv(pred * target, window) - mu_xy

    ssim_map = ((2 * mu_xy + c1) * (2 * sigma_xy + c2)) / (
        (mu_xx + mu_yy + c1) * (sigma_x + sigma_y + c2))
    return ssim_map.mean(dim=(1, 2, 3))
