"""Serving throughput of the flagship by build option (the port of
``tools/measure_serving.py``)::

    python -m uncertainty_model_tpu_torch.tools.measure_serving [batch] \\
        [--direct] [--s2d 0,1] [--conv-backend pallas|lax] \\
        [--decoder fused|direct] [--model-apply] [--device cpu]

The bf16 serving forward at 256x512, batch 128 by default, with
``s2d_stages=(0, 1)`` (the JAX tool's default; ``--direct`` or ``--s2d
""`` for none), ``s2d_conv_backend`` ``--conv-backend`` and
``--decoder direct`` meaning ``fused_stages=()`` (as in
``trace_chained``); ``--model-apply`` times the eval model in bf16
instead.  Timed by ``utils/benchmark.py::measure_forward`` (the best of 3
slopes of chained passes); prints ms/pass and frames/s.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..device import resolve_device
from ..serving import make_serving_forward
from ..utils.benchmark import measure_forward
from . import (IMAGE_HW, card, device_argument, eval_forward, eval_model,
               stages)
from .trace_chained import serving_options


def run(batch: int = 128, s2d=(0, 1), conv_backend: str = "pallas",
        decoder: str = "fused", model_apply: bool = False, device=None,
        config=None, image_hw=IMAGE_HW, verbose: bool = True) -> dict:
    """One reading: ``label``, ``batch``, ``ms`` a pass and ``fps``."""
    dev = resolve_device(device)
    if model_apply:
        forward = eval_forward(eval_model(dev, config, torch.bfloat16),
                               torch.bfloat16)
        label = "model.apply"
    else:
        forward = make_serving_forward(
            eval_model(dev, config), torch.bfloat16, dev,
            s2d_conv_backend=conv_backend,
            **serving_options(s2d=s2d, decoder=decoder))
        label = (f"serving s2d={tuple(s2d)} backend={conv_backend} "
                 f"decoder={decoder}")
    sec = measure_forward(forward, batch, image_hw=image_hw, device=dev)
    line = {"label": label, "batch": batch, "ms": sec * 1e3,
            "fps": batch / sec}
    if verbose:
        print(f"{card(dev)}\n{label} batch={batch}: {sec * 1e3:.2f} ms/pass, "
              f"{batch / sec:.1f} fps", flush=True)
    return line


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        prog="python -m uncertainty_model_tpu_torch.tools.measure_serving",
        description="Serving throughput by build option.")
    parser.add_argument("batch", nargs="?", type=int, default=128)
    parser.add_argument("--direct", action="store_true",
                        help="no s2d stages (s2d_stages=())")
    parser.add_argument("--s2d", type=stages, default=None)
    parser.add_argument("--conv-backend", default="pallas")
    parser.add_argument("--decoder", default="fused")
    parser.add_argument("--model-apply", action="store_true")
    device_argument(parser)
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    s2d = () if args.direct else (args.s2d if args.s2d is not None else (0, 1))
    return run(args.batch, s2d, args.conv_backend, args.decoder,
               args.model_apply, args.device)


if __name__ == "__main__":
    main()
