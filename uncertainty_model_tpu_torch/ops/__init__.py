"""Numerics ops of the port, on NHWC tensors like the JAX package's."""

from .pad import pad2d, reflect_pad2d
from .pool import avg_pool2d, global_avg_pool
from .resize import resize_bilinear, scale_pyramid
from .s2d import depth_to_space, s2d_bias, s2d_conv_kernel, space_to_depth
from .shuffle import pixel_shuffle, shuffle_phase_major
from .warp import (reconstruct_left_image, reconstruct_pyramid,
                   reconstruct_pyramid_with_lr, reconstruct_right_image,
                   reconstruct_stereo_with_lr, warp_by_disparities,
                   warp_by_disparity)

__all__ = ["pad2d", "reflect_pad2d", "avg_pool2d", "global_avg_pool",
           "resize_bilinear", "scale_pyramid", "depth_to_space", "s2d_bias",
           "s2d_conv_kernel", "space_to_depth", "pixel_shuffle",
           "shuffle_phase_major", "reconstruct_left_image",
           "reconstruct_pyramid", "reconstruct_pyramid_with_lr",
           "reconstruct_right_image",
           "reconstruct_stereo_with_lr", "warp_by_disparities",
           "warp_by_disparity"]
