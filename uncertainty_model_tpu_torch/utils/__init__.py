"""Training schedules, pyramid helpers, the forward timer and the
visualisation (PNG) helpers."""

from .benchmark import measure_forward, measure_forward_samples
from .pyramid import concatenate_pyramids, detach_pyramid
from .schedules import adjust_disparity, learning_rate_for_epoch
from .viz import (combine_disparity, get_comparison, make_grid, save_image,
                  to_heatmap)

__all__ = ["combine_disparity", "concatenate_pyramids", "detach_pyramid",
           "adjust_disparity", "get_comparison", "learning_rate_for_epoch",
           "make_grid", "measure_forward", "measure_forward_samples",
           "save_image", "to_heatmap"]
