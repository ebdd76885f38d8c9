"""Training schedules, pyramid helpers and the forward timer."""

from .benchmark import measure_forward, measure_forward_samples
from .pyramid import concatenate_pyramids, detach_pyramid
from .schedules import adjust_disparity, learning_rate_for_epoch

__all__ = ["concatenate_pyramids", "detach_pyramid", "adjust_disparity",
           "learning_rate_for_epoch", "measure_forward",
           "measure_forward_samples"]
