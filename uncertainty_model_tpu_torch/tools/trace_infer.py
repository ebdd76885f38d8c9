"""Trace forwards of the inference model and print the per-scope attribution
(the port of ``tools/trace_infer.py``)::

    python -m uncertainty_model_tpu_torch.tools.trace_infer [batch] [outdir] \\
        [--serving [--s2d 0,1]] [--device cpu]

By default the flagship's f32 eval model in bf16 (bf16 compute, weights
cast to bf16: the JAX tool's ``model.apply`` path), its encoder stages in
scopes ``enc0``-``enc4`` and its decoder stages in ``dec0``-``dec4``
(``stage_scopes``: the JAX tool reads flax's module names there);
``--serving`` the bf16 serving forward (``make_serving_forward``, the
port's defaults, ``--s2d`` its encoder stages; its scopes are its own).
One call as the profiler's warm-up step, then ``CALLS`` calls at ``batch``
(default 128) in its window (``trace_chained.profile``); the trace goes to ``outdir/trace.json`` and
``analyze_trace``'s tables follow, divided by ``CALLS`` (ms a call).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

from ..device import resolve_device
from ..serving import make_serving_forward
from ..utils.scopes import scope
from . import (IMAGE_HW, analyze_trace, card, device_argument, eval_forward,
               eval_model, stages)
from .trace_chained import profile, write_outdir

DEFAULT_OUTDIR = os.path.join(tempfile.gettempdir(), "trace_infer")
CALLS = 3


def stage_scopes(model) -> list:
    """Hooks that run each encoder stage of an eval model in ``enc{i}`` and
    each decoder stage in ``dec{i}``; returns their handles (``.remove()``
    them)."""
    handles = []
    for prefix, layers in (("enc", model.encoder.layers),
                           ("dec", model.decoder.layers)):
        for i, stage in enumerate(layers):
            named = scope(f"{prefix}{i}")

            def enter(module, args, named=named):
                named.__enter__()

            def leave(module, args, out, named=named):
                named.__exit__(None, None, None)
            handles.append(stage.register_forward_pre_hook(enter))
            handles.append(stage.register_forward_hook(leave))
    return handles


def run(batch: int = 128, outdir: str = DEFAULT_OUTDIR, serving=False,
        s2d=(), device=None, config=None, image_hw=IMAGE_HW, depth: int = 3,
        verbose: bool = True) -> dict:
    """Trace ``CALLS`` forwards (see the module docstring); returns
    ``analyze_trace.attribute``'s result a call."""
    dev = resolve_device(device)
    handles = []
    if serving:
        forward = make_serving_forward(eval_model(dev, config), torch.bfloat16,
                                       dev, s2d_stages=tuple(s2d))
    else:
        model = eval_model(dev, config, torch.bfloat16)
        handles = stage_scopes(model)
        forward = eval_forward(model, torch.bfloat16)
    x = torch.full((batch, *image_hw, 3), 0.5, device=dev)
    os.makedirs(outdir, exist_ok=True)
    try:
        _, events, _ = profile(
            lambda: [forward(x) for _ in range(CALLS)], dev,
            warmup=lambda: forward(x),
            trace_path=os.path.join(outdir, analyze_trace.TRACE_FILE))
    finally:
        for h in handles:
            h.remove()
    card_text = card(dev)
    write_outdir(outdir, None, card_text)
    result = analyze_trace.attribute(events, CALLS)
    if verbose:
        print(f"{card_text}\ntrace in {outdir}; {CALLS} calls at batch "
              f"{batch}, ms a call", flush=True)
        print(analyze_trace.report(result, depth), flush=True)
    return result


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        prog="python -m uncertainty_model_tpu_torch.tools.trace_infer",
        description="Trace the inference forward by scope.")
    parser.add_argument("batch", nargs="?", type=int, default=128)
    parser.add_argument("outdir", nargs="?", default=DEFAULT_OUTDIR)
    parser.add_argument("--serving", action="store_true")
    parser.add_argument("--s2d", type=stages, default=())
    device_argument(parser)
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    return run(args.batch, args.outdir, args.serving, args.s2d, args.device)


if __name__ == "__main__":
    main()
