"""Spatial padding of NHWC tensors: zeros, replicate and reflect.

Reflect padding follows numpy's rule.  ``torch.nn.functional.pad(mode=
"reflect")`` refuses a pad that is not smaller than the dimension; numpy
(and so ``jnp.pad``, which the JAX package uses) instead reflects
repeatedly and repeats a size-1 dimension.  The reference model reaches
that case at small inputs: decoder stage 0's reflect-padded 3x3 conv sees a
1-pixel-high map when the encoder ends at 1x2 (a 32x64 input).  So the
reflect padding is a gather with the index vector ``np.pad`` computes,
which is numpy's rule by construction.  Zero and replicate padding (the
smoothness loss's gradients) have no such case and use ``F.pad``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

_MODES = {"zeros": "constant", "replicate": "replicate", "reflect": "reflect"}


@functools.lru_cache(maxsize=None)
def _reflect_index(n: int, before: int, after: int,
                   device: torch.device) -> torch.Tensor:
    return torch.from_numpy(
        np.pad(np.arange(n), (before, after), mode="reflect")).to(device)


def reflect_pad2d(x: torch.Tensor,
                  padding: tuple[int, int, int, int]) -> torch.Tensor:
    """Reflect-pad H and W of an NHWC tensor in one gather.  ``padding``
    follows torch's ``F.pad`` order: ``(left, right, top, bottom)``."""
    left, right, top, bottom = padding
    hi = _reflect_index(x.shape[1], top, bottom, x.device)
    wi = _reflect_index(x.shape[2], left, right, x.device)
    return x[:, hi[:, None], wi]


def pad2d(x: torch.Tensor, padding: tuple[int, int, int, int],
          mode: str = "zeros") -> torch.Tensor:
    """Pad H and W of an NHWC tensor; ``padding`` is ``(left, right, top,
    bottom)`` and ``mode`` one of ``zeros``, ``replicate`` or ``reflect``
    (numpy's rule)."""
    mode = _MODES[mode]
    if mode == "reflect":
        return reflect_pad2d(x, padding)
    out = F.pad(x.permute(0, 3, 1, 2), padding, mode=mode)
    return out.permute(0, 2, 3, 1)
