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

``reflect_pad`` writes the input of a reflect(1)-padded 3x3 conv of the
serving forward in one pass: the reflect padding, an optional per-(image,
channel) scale, and zero channels up to a multiple of 8, the width cuDNN
reads an NHWC input at without a padded copy of its own.  On a CUDA tensor
it launches the hand-written kernel ``csrc/reflect_pad.cu`` (counted in
``reflect_pad.launches``); on a CPU tensor it runs
:func:`reflect_pad_plain`, the same arithmetic in plain PyTorch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import hand

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


CHANNEL_MULTIPLE = 8


def padded_channels(c: int) -> int:
    """``c`` rounded up to a multiple of ``CHANNEL_MULTIPLE``: the channels
    of :func:`reflect_pad`'s output, and so the input channels of the conv
    weights that read it."""
    return -(-c // CHANNEL_MULTIPLE) * CHANNEL_MULTIPLE


def reflect_pad_plain(x: torch.Tensor,
                      scale: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`reflect_pad`'s arithmetic in plain PyTorch: the gather of
    :func:`reflect_pad2d`, then the product with ``scale`` (rounded once to
    ``x``'s type), then zero channels."""
    out = reflect_pad2d(x, (1, 1, 1, 1))
    if scale is not None:
        out = out * scale[:, None, None, :]
    c = x.shape[-1]
    return F.pad(out, (0, padded_channels(c) - c))


def reflect_pad(x: torch.Tensor,
                scale: torch.Tensor | None = None) -> torch.Tensor:
    """The input of a reflect(1)-padded 3x3 conv, NHWC ``x`` (B, H, W, C)
    -> (B, H + 2, W + 2, ``padded_channels(C)``): numpy's reflect rule (a
    size-1 dimension repeats), each value times ``scale[b, c]`` where a
    ``scale`` (B, C) is given, and zeros in channels C and up.  CPU tensors
    run the plain version; CUDA tensors (float32 or bfloat16, contiguous,
    ``scale`` of ``x``'s type) launch the kernel or raise."""
    if x.ndim != 4 or min(x.shape) < 1:
        raise ValueError(f"reflect_pad takes a non-empty NHWC tensor, not "
                         f"{tuple(x.shape)}")
    b, h, w, c = x.shape
    if scale is not None and tuple(scale.shape) != (b, c):
        raise ValueError(f"reflect_pad: scale {tuple(scale.shape)} is not "
                         f"(B, C) = {(b, c)}")
    return hand.run(reflect_pad, (x, scale),
                    lambda: reflect_pad_plain(x, scale),
                    lambda: _reflect_pad_kernel(x, scale))


def _reflect_pad_kernel(x, scale):
    code = hand.check("reflect_pad", {"x": x, "scale": scale}, aligned=True)
    b, h, w, c = x.shape
    if b * (h + 2) >= 2 ** 31:
        raise ValueError(f"reflect_pad: {b * (h + 2)} padded rows exceed "
                         "the kernel's grid")
    out = torch.empty((b, h + 2, w + 2, padded_channels(c)), dtype=x.dtype,
                      device=x.device)
    hand.launch(reflect_pad, "umt_reflect_pad", x.device, code, x.data_ptr(),
                None if scale is None else scale.data_ptr(), out.data_ptr(),
                b, h, w, c, out.shape[-1])
    return out


reflect_pad.launches = 0
