"""Training schedules and pyramid helpers."""

from .pyramid import concatenate_pyramids, detach_pyramid
from .schedules import adjust_disparity, learning_rate_for_epoch

__all__ = ["concatenate_pyramids", "detach_pyramid", "adjust_disparity",
           "learning_rate_for_epoch"]
