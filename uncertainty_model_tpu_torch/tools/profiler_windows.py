"""How many device records a ``torch.profiler`` window loses as its process
ages, opened plainly and as the tools open it (``trace_chained.profile``)::

    python -m uncertainty_model_tpu_torch.tools.profiler_windows \\
        [--rounds 5] [--idle 50] [--kernels 300]

Each round waits ``--idle`` seconds with the card idle (the process ages;
nothing else runs), then traces ``--kernels`` small kernels three ways: a
plain window; a plain window whose first kernel sleeps 20 ms on the card
(so the others run 20 ms later: whether what is lost is a count of records
or a span of time); and ``trace_chained.profile``'s window (a warm-up step,
idle padding, the lost-record check).  For each it prints the seconds since
the tool started, the launches, the launches without a device record
(``analyze_trace.lost_device_records``) and the median offset of the kept
device records from their launches; one JSON line at the end.  With
``KINETO_LOG_LEVEL=1`` the profiler logs its own count of records dropped
as outside a window ("Out-of-range") after each.  CUDA only.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from . import analyze_trace, card
from .trace_chained import LostDeviceRecords, profile

START = time.perf_counter()   # the tool's start: the process's age
SLEEP_CYCLES = 40_000_000   # ~20 ms of the card's clock


def _read(events) -> dict:
    launches = {e["args"]["correlation"]: e
                for e in analyze_trace.launch_records(events)}
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in analyze_trace.DEVICE_CATS]
    offsets = [float(d["ts"]) - float(launches[d["args"]["correlation"]]["ts"])
               for d in device
               if d.get("args", {}).get("correlation") in launches]
    return {"launches": len(launches),
            "lost": len(analyze_trace.lost_device_records(events)),
            "offset_us": statistics.median(offsets) if offsets else None}


def _plain(work) -> dict:
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        work()
        torch.cuda.synchronize()
    return _read(analyze_trace.load_events(prof))


def _checked(work, dev) -> dict:
    try:
        _, events, _ = profile(work, dev)
    except LostDeviceRecords as e:
        return {"error": str(e)}
    return _read(events)


def run(rounds: int = 5, idle: float = 50.0, kernels: int = 300,
        verbose: bool = True) -> list:
    """The rounds' readings (see the module docstring)."""
    if not torch.cuda.is_available():
        raise RuntimeError("profiler_windows measures a CUDA device")
    dev = torch.device("cuda")
    x = torch.zeros(1 << 16, device=dev)

    def adds():
        for _ in range(kernels):
            x.add_(1.0)

    def sleep_then_adds():
        torch.cuda._sleep(SLEEP_CYCLES)
        adds()

    adds()
    out = []
    for i in range(rounds):
        if i:
            time.sleep(idle)
        row = {"seconds": time.perf_counter() - START,
               "plain": _plain(adds),
               "plain_behind_a_sleep": _plain(sleep_then_adds),
               "checked": _checked(adds, dev)}
        out.append(row)
        if verbose:
            print(json.dumps(row), flush=True)
    if verbose:
        print(card(dev), flush=True)
        print(json.dumps({"profiler_windows": out}), flush=True)
    return out


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(
        prog="python -m uncertainty_model_tpu_torch.tools.profiler_windows",
        description="Lost device records of profiler windows as a process "
                    "ages.")
    parser.add_argument("--rounds", type=int, default=5)
    parser.add_argument("--idle", type=float, default=50.0)
    parser.add_argument("--kernels", type=int, default=300)
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    return run(args.rounds, args.idle, args.kernels)


if __name__ == "__main__":
    main()
