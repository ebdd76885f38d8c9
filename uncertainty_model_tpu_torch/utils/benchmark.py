"""Forward throughput timed on the card (the port of the JAX package's
``utils/benchmark.py``, with its method):

* Throughput is a slope.  Each repetition times a chain of ``k1`` passes
  and then a chain of ``k2``, and its sample is ``((t2 - t1) - (t1 - t0)) /
  (k2 - k1)`` seconds per pass, which cancels what a timing costs beside
  the passes (the first launch's latency, the barrier).
* Each pass's input is the previous input times ``1 + 1e-6 * out[..., :3]``
  in bf16, so each pass depends on the one before it.  In the JAX module
  this keeps XLA from merging identical passes; PyTorch merges nothing,
  and the chain is kept so that both time the same work.  The perturbation
  lies below bf16's resolution for outputs under ~4,000, so the input's
  values, and the work, stay those of the real input.
* The barrier: on CUDA, events recorded on the device's current stream
  around each chain, read after the last one has synchronized.
  ``time.perf_counter`` is used only on the CPU (``device="cpu"``), where
  each operation has finished when it returns.  There is no fallback: by
  default the timer runs on CUDA, and raises where there is none.
"""

from __future__ import annotations

import time

import torch

from ..device import resolve_device


def measure_forward_samples(forward, batch: int, *, k1: int = 2, k2: int = 8,
                            reps: int = 3, image_hw=(256, 512),
                            device=None) -> list:
    """Per-repetition seconds-per-pass samples of ``forward(x) -> (B, H, W,
    4)`` (one slope each) on a (``batch``, H, W, 3) input of 0.5s.
    ``forward`` closes over its parameters (``make_serving_forward``'s
    does).  One chain of ``k1`` and one of ``k2`` passes run first as a
    warm-up, so ``forward`` is called ``(1 + reps) * (k1 + k2)`` times."""
    dev = resolve_device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no timer for device {dev}")
    h, w = image_hw
    x0 = torch.full((batch, h, w, 3), 0.5, device=dev)

    @torch.no_grad()
    def chain(k):
        x = x0.to(torch.bfloat16)
        for _ in range(k):
            out = forward(x)
            x = x * (1.0 + 1e-6 * out[..., :3].to(x.dtype))
        return x

    chain(k1)
    chain(k2)
    samples = []
    for _ in range(reps):
        if dev.type == "cuda":
            stream = torch.cuda.current_stream(dev)
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            marks[0].record(stream)
            chain(k1)
            marks[1].record(stream)
            chain(k2)
            marks[2].record(stream)
            marks[2].synchronize()
            t10 = marks[0].elapsed_time(marks[1]) / 1e3
            t21 = marks[1].elapsed_time(marks[2]) / 1e3
        else:
            t0 = time.perf_counter()
            chain(k1)
            t1 = time.perf_counter()
            chain(k2)
            t10, t21 = t1 - t0, time.perf_counter() - t1
        samples.append((t21 - t10) / (k2 - k1))
    return samples


def measure_forward(forward, batch: int, *, k1: int = 2, k2: int = 8,
                    reps: int = 3, image_hw=(256, 512), device=None) -> float:
    """Best-of-reps seconds per forward pass (see the module docstring)."""
    return min(measure_forward_samples(forward, batch, k1=k1, k2=k2,
                                       reps=reps, image_hw=image_hw,
                                       device=device))
