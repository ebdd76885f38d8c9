"""Host-side training schedules (reference train/utils.py:143-174, 333-353),
evaluated once per epoch."""

from __future__ import annotations

import numpy as np


def adjust_disparity(epoch: int, m: float = 0.02, c: float = 0.0,
                     step: float = 0.2, offset: float = 0.1,
                     min_scale: float = 0.3, max_scale: float = 1.0) -> float:
    """Disparity-scale curriculum: a linear ramp quantised to a step grid.
    Python's ``round`` (banker's rounding) on purpose, as the reference."""
    scale = ((epoch + 1) * m) + c
    scale = (round((scale + offset) / step) * step) - offset
    return float(np.clip(scale, min_scale, max_scale))


def learning_rate_for_epoch(epoch: int, lr: float,
                            finetune: bool = False) -> float:
    """lr, lr/2 after epoch 30, lr/4 after 40 (or always when finetuning)."""
    if epoch > 40 or finetune:
        return lr / 4
    if epoch > 30:
        return lr / 2
    return lr
