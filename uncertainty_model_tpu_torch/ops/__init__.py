"""Numerics ops of the port, on NHWC tensors like the JAX package's."""

from .pad import reflect_pad2d
from .resize import resize_bilinear
from .shuffle import pixel_shuffle, shuffle_phase_major

__all__ = ["reflect_pad2d", "resize_bilinear", "pixel_shuffle",
           "shuffle_phase_major"]
