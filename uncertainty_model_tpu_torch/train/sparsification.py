"""Sparsification metrics AUSE / AURG (the port of the JAX package's
``train/sparsification.py``; reference train/sparsification.py).

Measures uncertainty quality: pool the error maps 11x11, sort the oracle
error by *predicted* uncertainty (descending), progressively remove the most
uncertain pixels in 100 steps and record the normalised mean of what remains.
AUSE = mean gap between the prediction-sorted and oracle-sorted curves;
AURG = mean gap between random and prediction-sorted curves.  As in the JAX
package, the sweep is one sort and one cumulative sum read at 100 offsets.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import avg_pool2d


def curve(oracle_error: torch.Tensor, predicted_error: torch.Tensor,
          kernel_size: int = 11, steps: int = 100) -> torch.Tensor:
    """Sparsification curve (reference train/sparsification.py:8-36) of
    (B, H, W, 2) per-view error maps -> (steps,) normalised remaining mean
    error.  The sort is stable, as ``jnp.argsort`` is: tied uncertainties
    keep their pixel order."""
    batch = oracle_error.shape[0]
    oracle = avg_pool2d(oracle_error, kernel_size)
    predicted = avg_pool2d(predicted_error, kernel_size)

    # (B, 2, N) pixel vectors per view
    oracle = oracle.permute(0, 3, 1, 2).reshape(batch, 2, -1)
    predicted = predicted.permute(0, 3, 1, 2).reshape(batch, 2, -1)
    n = oracle.shape[2]

    order = torch.argsort(-predicted, dim=2, stable=True)
    oracle_sorted = torch.take_along_dim(oracle, order, dim=2)
    oracle_mean = oracle.mean(dim=2)  # (B, 2)

    # remaining_sum[k] = total - (sum of the first removed[k] elements)
    total = oracle_sorted.sum(dim=2, keepdim=True)
    prefix = torch.cumsum(oracle_sorted, dim=2)
    removed = np.array([int(s / steps * n) for s in range(steps)])
    idx = torch.from_numpy(np.maximum(removed - 1, 0)).to(oracle.device)
    prefix_at = prefix.index_select(2, idx)
    first = torch.from_numpy(removed == 0).to(oracle.device)
    prefix_at = torch.where(first, torch.zeros_like(prefix_at), prefix_at)

    left = torch.from_numpy(n - removed).to(oracle.device, oracle.dtype)
    normalised = (total - prefix_at) / left / oracle_mean[..., None]
    return normalised.mean(dim=(0, 1))


def random_curve(oracle_error: torch.Tensor, generator: torch.Generator,
                 kernel_size: int = 11, steps: int = 100) -> torch.Tensor:
    """The curve under uniformly random uncertainty
    (sparsification.py:39-43), drawn by ``generator`` on the error's
    device."""
    noise = torch.rand(oracle_error.shape, generator=generator,
                       device=oracle_error.device, dtype=oracle_error.dtype)
    return curve(oracle_error, noise, kernel_size, steps)


def ause(oracle_curve: torch.Tensor,
         predicted_curve: torch.Tensor) -> torch.Tensor:
    """Area under the sparsification error (sparsification.py:52-57)."""
    if oracle_curve.shape != predicted_curve.shape:
        raise ValueError("Oracle and Predicted sparsification curves have "
                         "different step sizes.")
    return (predicted_curve - oracle_curve).mean()


def aurg(predicted_curve: torch.Tensor,
         random_curve_: torch.Tensor) -> torch.Tensor:
    """Area under the random gain (sparsification.py:60-61)."""
    return ause(predicted_curve, random_curve_)
