"""Edge-aware disparity smoothness loss (Godard et al. 1609.03677;
reference train/loss.py:191-264)."""

from __future__ import annotations

import torch

from ..ops import pad2d


def gradient_x(x: torch.Tensor) -> torch.Tensor:
    """Forward difference along W with replicate padding (loss.py:208-212)."""
    x = pad2d(x, (0, 1, 0, 0), mode="replicate")
    return x[:, :, :-1, :] - x[:, :, 1:, :]


def gradient_y(x: torch.Tensor) -> torch.Tensor:
    """Forward difference along H with replicate padding (loss.py:214-218)."""
    x = pad2d(x, (0, 0, 0, 1), mode="replicate")
    return x[:, :-1, :, :] - x[:, 1:, :, :]


def _weights(image_gradient: torch.Tensor) -> torch.Tensor:
    return torch.exp(-image_gradient.abs().mean(dim=-1, keepdim=True))


def smoothness_error(disparity: torch.Tensor,
                     image: torch.Tensor) -> torch.Tensor:
    """Per-pixel edge-weighted |grad disparity| (loss.py:226-246)."""
    smooth_x = gradient_x(disparity) * _weights(gradient_x(image))
    smooth_y = gradient_y(disparity) * _weights(gradient_y(image))
    return smooth_x.abs() + smooth_y.abs()


def smoothness_loss(disp: torch.Tensor, images: torch.Tensor) -> torch.Tensor:
    """Stereo smoothness loss: ``disp`` (B, H, W, 2) against ``images`` split
    into two views of equal channel count (3+3 for RGB, 1+1 when the
    reference reuses it for uncertainty against pooled images,
    loss.py:248-264)."""
    half = images.shape[-1] // 2
    left = smoothness_error(disp[..., 0:1], images[..., :half])
    right = smoothness_error(disp[..., 1:2], images[..., half:])
    return (left + right).mean()
