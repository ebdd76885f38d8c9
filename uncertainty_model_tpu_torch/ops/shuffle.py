"""Pixel shuffle on NHWC tensors.

``pixel_shuffle`` keeps torch's channel order (input channel
``c * r**2 + i * r + j`` lands on output channel ``c`` at offset
``(i, j)``; reference model/layers/decoder.py:188-192).
``shuffle_phase_major`` is the same shuffle for the phase-major order the
serving build gives the upsample conv's output (channel
``(2i + j) * C + c``), which the fused decoder glue reads.
"""

from __future__ import annotations

import torch


def pixel_shuffle(x: torch.Tensor, upscale_factor: int) -> torch.Tensor:
    """(B, H, W, C*r^2) -> (B, H*r, W*r, C)."""
    r = upscale_factor
    b, h, w, c_r2 = x.shape
    c = c_r2 // (r * r)
    x = x.reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c)


def shuffle_phase_major(xc: torch.Tensor) -> torch.Tensor:
    """2x pixel shuffle for phase-major channels (c' = (2i+j)*Cu + c)."""
    b, h2, w2, c4 = xc.shape
    cu = c4 // 4
    x = xc.reshape(b, h2, w2, 2, 2, cu).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, 2 * h2, 2 * w2, cu)
