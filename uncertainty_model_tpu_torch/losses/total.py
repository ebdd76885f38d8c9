"""Composite training loss (reference train/loss.py:437-568,
``TukraUncertaintyLoss``).

Per pyramid scale i: WSSIM reconstruction + LR consistency + smoothness/2^i
+ the uncertainty (predictive-error) loss; with a discriminator, the
generator loss and, from batch ``perceptual_start`` of each epoch on, the
perceptual loss.  Returns ``(total_disparity_loss, total_error_loss)``
separately, like the reference.

The reference's gating quirk (train/train.py:124) is kept: the *batch
index within the epoch* is the ``step`` that gates the perceptual term, so
``perceptual_start=5`` skips it for the first 5 batches of every epoch.
``step`` is a Python int, so the gate is decided on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from .adversarial import generator_loss, perceptual_loss
from .consistency import l1_loss
from .reprojection import reprojection_error_loss
from .smoothness import smoothness_loss
from .wssim import wssim_loss


@dataclasses.dataclass(frozen=True)
class TukraUncertaintyLoss:
    """Configured by the reference constructor's keys (config.yml
    ``loss``)."""

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
        reconstruction's.  ``disc_apply`` and ``disc_features``: the
        discriminator's predictions and stage maps (``adversarial.py``);
        without them the adversarial terms are left out.  ``step``: the
        batch index within the epoch, which gates the perceptual term."""
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
        if disc_apply is not None:
            total_disparity_loss = total_disparity_loss + generator_loss(
                recon_pyramid, disc_apply,
                self.adversarial_loss_type) * self.adversarial_weight
            if step is not None and step >= self.perceptual_start:
                total_disparity_loss = total_disparity_loss + perceptual_loss(
                    image_pyramid, recon_pyramid,
                    disc_features) * self.perceptual_weight
        total_error_loss = error_loss * self.predictive_error_weight
        return total_disparity_loss, total_error_loss
