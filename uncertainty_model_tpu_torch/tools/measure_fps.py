"""Inference throughput and latency by batch (the port of
``tools/measure_fps.py``)::

    python -m uncertainty_model_tpu_torch.tools.measure_fps [batch ...] \\
        [--dtype=f32] [--serving] [--device cpu]

Each pass's input is made from the previous pass's output, and each
reading is the slope between chains of 2 and 8 passes
(``utils/benchmark.py::measure_forward``, the best of 3), so neither the
first launch's latency nor the barrier is in it.  By default the eval
model in bf16 (the JAX tool's ``model.apply`` path; ``--dtype=f32`` the
f32 eval model), ``--serving`` the serving forward with
``s2d_stages=()`` and the port's other defaults (bf16, or f32 with
``--dtype=f32``).  Batches default to 64; at batches 1-8 the reading is
the latency a pass of a small batch.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..device import resolve_device
from ..serving import make_serving_forward
from ..utils.benchmark import measure_forward
from . import IMAGE_HW, card, device_argument, eval_forward, eval_model


def forward_of(dev, serving: bool, dtype, config=None):
    """The timed forward: the serving forward or the eval model, in
    ``dtype``."""
    if serving:
        return make_serving_forward(eval_model(dev, config), dtype, dev,
                                    s2d_stages=())
    bf16 = dtype == torch.bfloat16
    return eval_forward(eval_model(dev, config, dtype if bf16 else None),
                        dtype)


def run(batches=(64,), f32: bool = False, serving: bool = False,
        device=None, config=None, image_hw=IMAGE_HW,
        verbose: bool = True) -> list:
    """One reading a batch: ``batch``, ``ms`` a pass and ``fps``."""
    dev = resolve_device(device)
    dtype = torch.float32 if f32 else torch.bfloat16
    forward = forward_of(dev, serving, dtype, config)
    if verbose:
        print(f"{card(dev)}\n{'serving forward' if serving else 'eval model'}"
              f" {dtype}", flush=True)
    lines = []
    for batch in batches:
        sec = measure_forward(forward, batch, image_hw=image_hw, device=dev)
        lines.append({"batch": batch, "ms": sec * 1e3, "fps": batch / sec})
        if verbose:
            print(f"batch {batch}: {sec * 1e3:.2f} ms/pass, "
                  f"{batch / sec:.1f} fps", flush=True)
    return lines


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(
        prog="python -m uncertainty_model_tpu_torch.tools.measure_fps",
        description="Inference throughput by batch.")
    parser.add_argument("batches", nargs="*", type=int)
    parser.add_argument("--dtype", choices=("f32", "bf16"), default="bf16")
    parser.add_argument("--serving", action="store_true")
    device_argument(parser)
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    return run(tuple(args.batches) or (64,), args.dtype == "f32",
               args.serving, args.device)


if __name__ == "__main__":
    main()
