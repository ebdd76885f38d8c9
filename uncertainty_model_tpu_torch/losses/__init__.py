"""The training losses (the port of the JAX package's ``losses/``), on
NHWC tensors."""

from .adversarial import (bce_loss, discriminator_loss, generator_loss,
                          perceptual_loss)
from .consistency import consistency_loss, l1_loss
from .reprojection import reprojection_error_loss
from .smoothness import smoothness_error, smoothness_loss
from .total import TukraUncertaintyLoss
from .wssim import wssim_image_error, wssim_loss

__all__ = ["bce_loss", "consistency_loss", "discriminator_loss",
           "generator_loss", "l1_loss", "perceptual_loss",
           "reprojection_error_loss", "smoothness_error", "smoothness_loss",
           "TukraUncertaintyLoss", "wssim_image_error", "wssim_loss"]
