"""Uncertainty (reprojection-error) loss (reference train/loss.py:340-434).

Supervises the 2-channel uncertainty prediction against the actual
(detached) reprojection error under one of three objectives:

- ``l1``:            mean |sigma - err|
- ``bayesian``:      mean(err / sigma^2 + log sigma^2)   (model outputs sigma^2)
- ``log_bayesian``:  mean(err * e^s + s) / 2             (model outputs s = log sigma^2)

plus optional smoothness (uncertainty against the image) and consistency
terms.  The consistency term keeps the reference's warp-field quirk: the
uncertainty map is the warp field that warps the disparity
(loss.py:430-431).
"""

from __future__ import annotations

import torch

from ..ops import avg_pool2d
from .consistency import consistency_loss, l1_loss
from .smoothness import smoothness_loss

VALID_LOSS_TYPES = ("l1", "bayesian", "log_bayesian")


def _bayesian(predicted, error):
    return (error / predicted + torch.log(predicted)).mean()


def _log_bayesian(predicted, error):
    return (error / torch.exp(-predicted) + predicted).mean() / 2


def reprojection_error_loss(predicted: torch.Tensor, image: torch.Tensor,
                            error: torch.Tensor, loss_type: str = "l1",
                            smoothness_weight: float = 1.0,
                            consistency_weight: float = 1.0,
                            pooling: bool = False) -> torch.Tensor:
    """Arguments are the reference's ``error_loss_config`` keys.

    predicted: (B, H, W, 4) [disp_l, disp_r, unc_l, unc_r]; image:
    (B, H, W, 6); error: (B, H, W, 2) reprojection error from the WSSIM
    loss, detached here."""
    if loss_type not in VALID_LOSS_TYPES:
        raise ValueError('Loss must be either "l1", "bayesian" or "log_bayesian".')

    error = error.detach()
    if pooling:
        predicted = avg_pool2d(predicted, 3)
        image = avg_pool2d(image, 3)
        error = avg_pool2d(error, 3)

    disparity = predicted[..., :2]
    uncertainty = predicted[..., 2:]

    if loss_type == "l1":
        loss = l1_loss(uncertainty, error)
    elif loss_type == "bayesian":
        loss = _bayesian(uncertainty, error)
    else:
        loss = _log_bayesian(uncertainty, error)

    if smoothness_weight > 0:
        loss = loss + smoothness_weight * smoothness_loss(uncertainty, image)
    if consistency_weight > 0:
        loss = loss + consistency_weight * consistency_loss(uncertainty,
                                                            disparity)
    return loss
