"""Composite training loss (reference train/loss.py:437-568,
``TukraUncertaintyLoss``).

Per pyramid scale i: WSSIM reconstruction + LR consistency + smoothness/2^i
+ the uncertainty (predictive-error) loss.  Returns ``(total_disparity_loss,
total_error_loss)`` separately, like the reference.  The adversarial terms
(generator and perceptual losses against a discriminator) belong to the
adversarial slice of the port, which is not written yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from .consistency import l1_loss
from .reprojection import reprojection_error_loss
from .smoothness import smoothness_loss
from .wssim import wssim_loss


@dataclasses.dataclass(frozen=True)
class TukraUncertaintyLoss:
    """Configured by the reference constructor's keys (config.yml ``loss``);
    the adversarial ones are kept so that the flagship config loads."""

    wssim_weight: float = 1.0
    consistency_weight: float = 1.0
    smoothness_weight: float = 1.0
    adversarial_weight: float = 0.85
    predictive_error_weight: float = 1.0
    perceptual_weight: float = 0.05
    wssim_alpha: float = 0.85
    perceptual_start: int = 5
    adversarial_loss_type: str = "mse"
    error_loss_config: Optional[dict] = None

    def __call__(self, image_pyramid: Sequence[torch.Tensor],
                 predictions: Sequence[torch.Tensor],
                 recon_pyramid: Sequence[torch.Tensor],
                 lr_pyramid: Sequence[torch.Tensor],
                 step: Optional[int] = None,
                 disc_apply: Optional[Callable] = None,
                 disc_features: Optional[Callable] = None,
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """NHWC pyramids, finest first.  ``lr_pyramid``: the LR-consistency
        warps from ``reconstruct_pyramid_with_lr``, fused into the
        reconstruction's.  ``step`` gates the perceptual term, which this
        slice does not have."""
        if disc_apply is not None or disc_features is not None:
            raise NotImplementedError(
                "the adversarial losses (discriminator, generator and "
                "perceptual terms) belong to the port's adversarial slice, "
                "which is not written yet")
        error_cfg = dict(self.error_loss_config or {})

        reprojection = consistency = smoothness = error_loss = 0.0
        for i, (images, prediction, recon, lr) in enumerate(
                zip(image_pyramid, predictions, recon_pyramid, lr_pyramid)):
            disparity = prediction[..., :2]
            scale_wssim, image_error = wssim_loss(images, recon,
                                                  self.wssim_alpha)
            reprojection = reprojection + scale_wssim
            consistency = consistency + (
                l1_loss(disparity[..., 0:1], lr[..., 0:1])
                + l1_loss(disparity[..., 1:2], lr[..., 1:2]))
            smoothness = smoothness + smoothness_loss(disparity, images) / 2 ** i
            error_loss = error_loss + reprojection_error_loss(
                prediction, images, image_error, **error_cfg)

        total_disparity_loss = (reprojection * self.wssim_weight
                                + consistency * self.consistency_weight
                                + smoothness * self.smoothness_weight)
        total_error_loss = error_loss * self.predictive_error_weight
        return total_disparity_loss, total_error_loss
