"""Image-pyramid helpers (reference train/utils.py:53-62, 138-140).
``scale_pyramid`` and the reconstructions live in :mod:`..ops`."""

from __future__ import annotations

from typing import Sequence

import torch


def detach_pyramid(pyramid: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Stop gradients through every level."""
    return [level.detach() for level in pyramid]


def concatenate_pyramids(a: Sequence[torch.Tensor],
                         b: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Concatenate two pyramids along the batch axis."""
    return [torch.cat([x, y], dim=0) for x, y in zip(a, b)]
