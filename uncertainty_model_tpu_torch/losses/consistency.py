"""Left-right consistency loss (Godard et al. 1609.03677; reference
train/loss.py:154-188)."""

from __future__ import annotations

import torch

from ..ops import warp_by_disparities


def l1_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean absolute error (reference train/utils.py:22-24)."""
    return (x - y).abs().mean()


def consistency_loss(warp_field: torch.Tensor,
                     source: torch.Tensor) -> torch.Tensor:
    """LR-consistency of a 2-channel NHWC ``warp_field`` against ``source``
    warped by it into the opposite view.

    The port's one caller is the uncertainty-consistency term, which passes
    (uncertainty, disparity): the reference's warp-field quirk
    (train/loss.py:430-431).  The disparity's own LR-consistency comes from
    the fused reconstruction warps (``reconstruct_pyramid_with_lr``).  Both
    views' warps are one ``warp_rows`` launch each way on CUDA: the left
    view from the right source (``reconstruct_left_image``), the right from
    the left."""
    left, right = warp_field[..., 0:1], warp_field[..., 1:2]
    left_lr, right_lr = warp_by_disparities(
        [-left, right], [source[..., 1:2], source[..., 0:1]])
    return l1_loss(left, left_lr) + l1_loss(right, right_lr)
