"""Adversarial losses (the port of the JAX package's
``losses/adversarial.py``; reference train/loss.py:267-337,
train/utils.py:248-273).

Each takes the discriminator as a callable: ``disc_apply(pyramid)`` gives
its (B, 1) predictions and ``disc_features(pyramid)`` its stage maps (a
``RandomDiscriminator`` and its ``features``; the trainer passes its
lagged clone for the generator and perceptual terms).  Pyramids are NHWC,
finest first.  Types follow the JAX package's promotion: a bf16
prediction gives a bf16 MSE, while the discriminator's f32 labels make
its BCE f32.
"""

from __future__ import annotations

import torch

from .consistency import l1_loss

_LOG_CLAMP = -100.0  # torch's BCELoss clamps its log terms at -100


def bce_loss(predictions: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    log_p = torch.clamp(torch.log(predictions), min=_LOG_CLAMP)
    log_1p = torch.clamp(torch.log(1 - predictions), min=_LOG_CLAMP)
    return -torch.mean(labels * log_p + (1 - labels) * log_1p)


def generator_loss(recon_pyramid, disc_apply, loss_type: str = "mse"
                   ) -> torch.Tensor:
    """Convince the discriminator that the reconstructions are real
    (reference train/loss.py:308-337)."""
    predictions = disc_apply(recon_pyramid)
    labels = torch.ones_like(predictions)
    if loss_type == "mse":
        return torch.mean((predictions - labels) ** 2)
    return bce_loss(predictions, labels)


def perceptual_loss(image_pyramid, recon_pyramid, disc_features
                    ) -> torch.Tensor:
    """L1 between the discriminator's stage maps of the real and the
    reconstructed pyramids (reference train/loss.py:267-305)."""
    loss = 0.0
    for image_map, recon_map in zip(disc_features(image_pyramid),
                                    disc_features(recon_pyramid)):
        loss = loss + l1_loss(image_map, recon_map)
    return loss


def discriminator_loss(image_pyramid, recon_pyramid, disc_apply,
                       batch_size: int) -> torch.Tensor:
    """Real against fake: the two pyramids concatenated on the batch (the
    fakes detached) in one call, labels 1 then 0, the BCE halved
    (reference train/utils.py:248-273)."""
    pyramid = [torch.cat([a, b.detach()], dim=0)
               for a, b in zip(image_pyramid, recon_pyramid)]
    predictions = disc_apply(pyramid)
    labels = torch.cat([
        torch.ones(batch_size, 1, device=predictions.device),
        torch.zeros(predictions.shape[0] - batch_size, 1,
                    device=predictions.device)])
    return bce_loss(predictions, labels) / 2
