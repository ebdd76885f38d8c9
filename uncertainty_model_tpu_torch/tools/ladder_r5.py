"""Serving configurations timed A/B in one process (the port of
``tools/ladder_r5.py``)::

    python -m uncertainty_model_tpu_torch.tools.ladder_r5 [config ...] \\
        [--reps 5] [--batch 128] [--device cpu]

where each config is ``name=pipeline,elu_fold[,smax[,fused_stages]]``,
e.g. ``gate_z=gate_z,0``, ``gfold_w=gate_fold,0,window``,
``f1234=gate_fold,0,nomax,1234`` (default: the JAX tool's candidates,
``DEFAULT``; ``smax`` defaults to the port's "window", ``fused_stages``
to 2, 3 and 4).  The flagship's bf16 serving forward with
``s2d_stages=()`` at batch 128, 256x512: after a warm-up of every config,
``reps`` rounds (the JAX tool's ``REPS``, default 5) each take one slope
sample of every config in turn (``utils/benchmark.py::slope_sample``:
chains of 2 and 8 passes), so that a drift of the card moves every config
alike.  Prints each config's median ms/pass, frames/s and spread
((max - min) / median).
"""

from __future__ import annotations

import argparse
import statistics
import sys

import torch

from ..device import resolve_device
from ..serving import make_serving_forward
from ..utils.benchmark import chain, slope_sample
from . import IMAGE_HW, card, device_argument, eval_model

DEFAULT = ("gate_z=gate_z,0", "gfold=gate_fold,0", "gfold_elu=gate_fold,1")
K1, K2 = 2, 8


def parse(spec: str):
    """``name=pipeline,elu_fold[,smax[,fused_stages]]`` -> (name, the
    build's keyword arguments)."""
    name, rest = spec.split("=")
    parts = rest.split(",")
    options = {"s2d_stages": (), "dec_pipeline": parts[0],
               "elu_fold": parts[1] != "0"}
    if len(parts) > 2:
        options["smax"] = parts[2]
    if len(parts) > 3:
        options["fused_stages"] = tuple(int(c) for c in parts[3])
    return name, options


def run(specs=DEFAULT, batch: int = 128, reps: int = 5, device=None,
        config=None, image_hw=IMAGE_HW, verbose: bool = True,
        forwards=None) -> dict:
    """``{name: {ms, fps, spread, samples_ms}}`` of each config.
    ``forwards`` ({name: forward}) adds forwards built elsewhere."""
    dev = resolve_device(device)
    model = eval_model(dev, config) if specs else None
    runs = {}
    for spec in specs:
        name, options = parse(spec)
        runs[name] = make_serving_forward(model, torch.bfloat16, dev,
                                          **options)
    runs.update(forwards or {})
    x = torch.full((batch, *image_hw, 3), 0.5, device=dev)
    for forward in runs.values():
        chain(forward, x, K1)
        chain(forward, x, K2)
    samples = {name: [] for name in runs}
    for _ in range(reps):
        for name, forward in runs.items():
            samples[name].append(slope_sample(forward, x, K1, K2))
    result = {}
    for name, ss in samples.items():
        med = statistics.median(ss)
        result[name] = {"ms": med * 1e3, "fps": batch / med,
                        "spread": (max(ss) - min(ss)) / med,
                        "samples_ms": [s * 1e3 for s in ss]}
    if verbose:
        print(f"{card(dev)}\nbatch {batch}, {reps} rounds\n"
              f"{'config':<14}{'ms/pass':>9}{'fps':>9}{'spread':>8}")
        for name, r in result.items():
            print(f"{name:<14}{r['ms']:9.2f}{r['fps']:9.1f}"
                  f"{r['spread'] * 100:7.2f}%", flush=True)
    return result


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        prog="python -m uncertainty_model_tpu_torch.tools.ladder_r5",
        description="Serving configurations timed A/B in one process.")
    parser.add_argument("configs", nargs="*")
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--batch", type=int, default=128)
    device_argument(parser)
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    return run(tuple(args.configs) or DEFAULT, args.batch, args.reps,
               args.device)


if __name__ == "__main__":
    main()
