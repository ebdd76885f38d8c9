"""Inference throughput of the flagship's serving forward on one card (the
port of the repo's ``bench.py``)::

    python -m uncertainty_model_tpu_torch.bench [-v] [--device cpu] \\
        [--batch N]

prints one JSON line, ``{"metric": "inference_fps_per_chip", "value":
frames/s, "unit": "frames/sec", "spread": ...}``; with ``-v``, lines
before it name the card (``nvidia-smi``'s name and power limit) and give
the ms per pass, the batch and the spread.

The forward is ``bench.py``'s: the 22.5M-parameter flagship
(``configs/uncertainty.yml``, graphs ``graphs/nodes_5_seed_42``) with
weights from seed 0, in eval mode, folded by ``make_serving_forward``
into bf16 at 256x512, batch 128, with the options the JAX package takes
when no ``UMT_*`` variable is set: ``s2d_stages=()``, ``fused_stages=(2,
3, 4)``, the gate_fold pipeline, ``dec_fold``, no ``elu_fold`` and the
softmax without the max subtracted ("nomax", which overflows past
attention logits of ~88; the port's own default is "window").  Each is
passed here by name, so that a change of the port's defaults does not
move the bench.

The time is ``utils/benchmark.py::measure_forward_samples``'s, 9 samples
(each the slope between chains of 2 and 8 chained passes, on CUDA
events): sec/pass is their median, the spread ``(max - min) / median``,
as ``bench.py:75-80`` computes them.  ``bench.py``'s ``vs_baseline`` is
left out: its 2,000 frames/s is a TPU target, not the port's.

It runs on CUDA unless ``--device cpu`` is given, and raises where CUDA
is asked for and there is none.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from .device import resolve_device
from .entry import entry
from .serving import make_serving_forward
from .utils.benchmark import measure_forward_samples

BATCH = 128
REPS = 9


def bench_model(device):
    """The flagship's eval model, its weights from seed 0, on ``device``
    (``entry()``'s)."""
    return entry(device)[1][0]


def bench_forward(model, dtype=torch.bfloat16, device=None):
    """``bench.py``'s serving forward of ``model``: every build option
    named, at the JAX package's value with no ``UMT_*`` variable set."""
    return make_serving_forward(
        model, dtype, device, s2d_stages=(), fused_stages=(2, 3, 4),
        dec_pipeline="gate_fold", dec_fold=True, elu_fold=False,
        smax="nomax")


def card_line() -> str:
    """The first card's ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bench(verbose: bool = False, device=None, batch: int = BATCH) -> dict:
    """The bench's result line (see the module docstring) on ``device``
    (CUDA unless asked otherwise) at ``batch``."""
    dev = resolve_device(device)

    def log(msg):
        if verbose:
            print(f"[bench] {msg}", flush=True)

    log(card_line() if dev.type == "cuda" else f"device {dev}")
    forward = bench_forward(bench_model(dev), device=dev)
    samples = sorted(measure_forward_samples(forward, batch, reps=REPS,
                                             device=dev))
    sec_per_pass = samples[len(samples) // 2]
    fps = batch / sec_per_pass
    spread = (samples[-1] - samples[0]) / sec_per_pass
    log(f"{sec_per_pass * 1e3:.2f} ms/pass at batch {batch} (median of "
        f"{len(samples)}, spread {spread * 100:.1f}%)")
    return {"metric": "inference_fps_per_chip", "value": round(fps, 1),
            "unit": "frames/sec", "spread": round(spread, 4)}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m uncertainty_model_tpu_torch.bench",
        description="Serving throughput of the flagship on one card.")
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument("--device", default=None,
                        help="cpu to run on the CPU (default: CUDA)")
    parser.add_argument("--batch", type=int, default=BATCH)
    args = parser.parse_args(argv)
    print(json.dumps(bench(args.verbose, args.device, args.batch)))


if __name__ == "__main__":
    main()
