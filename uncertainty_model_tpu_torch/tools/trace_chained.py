"""Trace the chain of passes that ``utils/benchmark.py`` times (the port of
``tools/trace_chained.py``)::

    python -m uncertainty_model_tpu_torch.tools.trace_chained [batch] \\
        [outdir] [--s2d 0,1] [--k K] [--decoder fused|direct] \\
        [--pipeline gate_fold|gate_z|squeeze_first] [--elu-fold 0|1] \\
        [--smax window|slice|nomax] [--device cpu]

The flagship's bf16 serving forward at 256x512, batch 128 by default,
built with the options given (``--decoder direct``: ``fused_stages=()``;
an option not given keeps the port's default, so ``--smax nomax`` is
``bench.py``'s forward and no flag the port's default path): one chain of
``k`` passes (default 3; ``utils/benchmark.py::chain``) runs as the
profiler's warm-up step, then one in its window (``profile``: a launch
without its device record fails the run).  The outdir receives ``trace.json``
(the profiler's chrome trace), ``budget.json`` (``perf_budget.Recorder``
over one pass of the same forward on the same input) and ``card.txt``;
``analyze_trace``'s tables follow, every duration divided by ``k``.
``perf_budget <outdir> <k>`` then prints the budget.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

from ..device import resolve_device
from ..serving import FUSED_STAGES, make_serving_forward
from ..utils.benchmark import chain
from . import (IMAGE_HW, analyze_trace, card, device_argument, eval_model,
               stages)
from .perf_budget import BUDGET_FILE, Recorder

DEFAULT_OUTDIR = os.path.join(tempfile.gettempdir(), "trace_chained")
PAD_S = 0.05


def serving_options(s2d=(), decoder="fused", pipeline=None, elu_fold=None,
                    smax=None) -> dict:
    """``make_serving_forward``'s keyword arguments for the JAX tools'
    flags; a flag left at None keeps the port's default."""
    if decoder not in ("fused", "direct"):
        raise ValueError(f"--decoder takes fused or direct, not {decoder!r}")
    options = {"s2d_stages": tuple(s2d),
               "fused_stages": () if decoder == "direct" else FUSED_STAGES}
    for key, value in (("dec_pipeline", pipeline), ("elu_fold", elu_fold),
                       ("smax", smax)):
        if value is not None:
            options[key] = value
    return options


class LostDeviceRecords(RuntimeError):
    """A profiled window whose trace lacks the device record of a launch
    it holds."""


def profile(fn, dev: torch.device, activities=None, warmup=None,
            trace_path=None):
    """``fn()`` once in a ``torch.profiler`` window (the CPU's operators,
    and the device's activity on CUDA; or ``activities``), whose chrome
    trace is checked by ``analyze_trace.lost_device_records``: every launch
    in it must have its device record, else ``LostDeviceRecords``.
    Returns (the profiler, the trace's events, the wall seconds of
    ``fn()``); the trace is written to ``trace_path`` where one is given.

    The window opens after a warm-up step (a profiler ``schedule``) that
    runs ``warmup()`` (default ``fn()``) with the tracing already on, and on
    CUDA the device is idle for ``PAD_S`` at both ends of it.  Without the
    warm-up step the profiler drops the first device records of a window as
    outside it, more the longer the process has run (5 at 70 s, 24 at 311 s
    on an H100: ``profiler_windows``); with the warm-up step but no padding
    it still dropped records launched within a millisecond of the window's
    start, whose device timestamps, aligned to the host's clock, fell
    before it."""
    cuda = dev.type == "cuda"
    if activities is None:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    sync()
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=activities,
                                schedule=schedule) as prof:
        (fn if warmup is None else warmup)()
        sync()
        prof.step()
        if cuda:
            time.sleep(PAD_S)
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
        if cuda:
            time.sleep(PAD_S)
        prof.step()
    with tempfile.TemporaryDirectory() as tmp:
        path = trace_path or os.path.join(tmp, analyze_trace.TRACE_FILE)
        prof.export_chrome_trace(path)
        events = analyze_trace.load_events(path)
    launches = analyze_trace.launch_records(events)
    lost = analyze_trace.lost_device_records(events)
    device = any(e.get("cat") in analyze_trace.DEVICE_CATS for e in events)
    if device and not launches:
        raise LostDeviceRecords("the trace holds device records but no "
                                "launches to check them against")
    if lost:
        names = sorted({e["name"] for e in lost})
        raise LostDeviceRecords(
            f"{len(lost)} of {len(launches)} launches in the profiled window "
            f"have no device record ({', '.join(names)})")
    return prof, events, wall


def write_outdir(outdir, recorder, card_text) -> None:
    """``budget.json`` (where a recorder is given) and ``card.txt`` beside
    the trace ``profile`` wrote."""
    os.makedirs(outdir, exist_ok=True)
    if recorder is not None:
        with open(os.path.join(outdir, BUDGET_FILE), "w") as f:
            json.dump(recorder.to_json(), f)
    with open(os.path.join(outdir, "card.txt"), "w") as f:
        f.write(card_text + "\n")


def run(batch: int = 128, outdir: str = DEFAULT_OUTDIR, k: int = 3,
        device=None, config=None, image_hw=IMAGE_HW, depth: int = 3,
        verbose: bool = True, **options) -> dict:
    """Trace ``k`` chained passes of the forward that ``serving_options(
    **options)`` builds from ``eval_model(device, config)`` (default the
    flagship) and write the
    outdir; returns ``analyze_trace.attribute``'s result (divided by k)
    with ``wall_ms`` (the traced chain's wall time, dispatch included),
    ``counts`` (the recorder's ``to_json()``), ``outdir``, and the
    ``forward`` and its bf16 ``input``."""
    dev = resolve_device(device)
    forward = make_serving_forward(eval_model(dev, config), torch.bfloat16, dev,
                                   **serving_options(**options))
    x = torch.full((batch, *image_hw, 3), 0.5, device=dev)
    os.makedirs(outdir, exist_ok=True)
    _, events, wall = profile(
        lambda: chain(forward, x, k), dev,
        trace_path=os.path.join(outdir, analyze_trace.TRACE_FILE))
    x = x.to(torch.bfloat16)
    with Recorder() as recorder:
        forward(x)
    card_text = card(dev)
    write_outdir(outdir, recorder, card_text)
    result = analyze_trace.attribute(events, k)
    if verbose:
        print(f"{card_text}\ntrace and counts in {outdir}; k={k} passes at "
              f"batch {batch}, wall {wall * 1e3:.1f} ms ({wall / k * 1e3:.1f} "
              f"ms/pass incl. dispatch)", flush=True)
        print(analyze_trace.report(result, depth), flush=True)
    return {**result, "wall_ms": wall * 1e3, "counts": recorder.to_json(),
            "outdir": outdir, "forward": forward, "input": x}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        prog="python -m uncertainty_model_tpu_torch.tools.trace_chained",
        description="Trace the benchmark's chain of serving passes.")
    parser.add_argument("batch", nargs="?", type=int, default=128)
    parser.add_argument("outdir", nargs="?", default=DEFAULT_OUTDIR)
    parser.add_argument("--s2d", type=stages, default=())
    parser.add_argument("--k", type=int, default=3)
    parser.add_argument("--decoder", default="fused")
    parser.add_argument("--pipeline", default=None)
    parser.add_argument("--elu-fold", type=lambda v: v != "0", default=None)
    parser.add_argument("--smax", default=None)
    device_argument(parser)
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    return run(args.batch, args.outdir, args.k, args.device, s2d=args.s2d,
               decoder=args.decoder, pipeline=args.pipeline,
               elu_fold=args.elu_fold, smax=args.smax)


if __name__ == "__main__":
    main()
