"""The self-supervised training losses (the port of the JAX package's
``losses/``, without the adversarial terms), on NHWC tensors."""

from .consistency import consistency_loss, l1_loss
from .reprojection import reprojection_error_loss
from .smoothness import smoothness_error, smoothness_loss
from .total import TukraUncertaintyLoss
from .wssim import wssim_image_error, wssim_loss

__all__ = ["consistency_loss", "l1_loss", "reprojection_error_loss",
           "smoothness_error", "smoothness_loss", "TukraUncertaintyLoss",
           "wssim_image_error", "wssim_loss"]
