"""Weighted SSIM / L1 reconstruction loss (reference train/loss.py:15-151).

As in the JAX package, :func:`wssim_loss` returns the per-pixel stereo
error map beside the scalar loss (the reference stashes it on the module,
loss.py:38-41,149) for the uncertainty loss to consume.
"""

from __future__ import annotations

import torch

from ..ops import avg_pool2d, resize_bilinear
from .consistency import absolute

_K1 = 0.01 ** 2
_K2 = 0.03 ** 2


def wssim_image_error(images: torch.Tensor, recon: torch.Tensor,
                      alpha: float = 0.85) -> torch.Tensor:
    """Per-pixel ``alpha * DSSIM + (1 - alpha) * L1`` of (B, H, W, 6) stereo
    pairs (left = channels 0:3, right 3:6), averaged per view to
    (B, H, W, 2) (train/loss.py:96-131).

    SSIM is per channel, so the five pooled statistics of both views come
    from one stacked 30-channel pool.  The (H-2, W-2) SSIM map is resized
    back to (H, W) by the align-corners resize."""
    h, w = images.shape[1], images.shape[2]
    l1_error = absolute(images - recon)

    x, y = images, recon
    pooled = avg_pool2d(torch.cat([x, y, x * x, y * y, x * y], dim=-1), 3)
    mu_x, mu_y, m_xx, m_yy, m_xy = pooled.split(6, dim=-1)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_x = m_xx - mu_xx
    sigma_y = m_yy - mu_yy
    sigma_xy = m_xy - mu_xy
    ssim_map = ((2 * mu_xy + _K1) * (2 * sigma_xy + _K2)) / (
        (mu_xx + mu_yy + _K1) * (sigma_x + sigma_y + _K2))
    ssim_error = torch.clamp((1 - ssim_map) / 2, 0.0, 1.0)
    ssim_error = resize_bilinear(ssim_error, (h, w))

    total = alpha * ssim_error + (1 - alpha) * l1_error
    left = total[..., 0:3].mean(dim=-1, keepdim=True)
    right = total[..., 3:6].mean(dim=-1, keepdim=True)
    return torch.cat([left, right], dim=-1)


def wssim_loss(images: torch.Tensor, recon: torch.Tensor,
               alpha: float = 0.85) -> tuple[torch.Tensor, torch.Tensor]:
    """Scalar WSSIM loss and the per-pixel error map (train/loss.py:133-151)."""
    error = wssim_image_error(images, recon, alpha)
    return (error[..., 0] + error[..., 1]).mean(), error
