"""Run one cell of the port's benchmark once::

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  It sets up the cell (weights and inputs from
``--seed``, the port's kernels built or loaded, every shape warmed up),
measures for ``--seconds``, checks what the measured path produced against
the plain reference, and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` a ``breakdown``, and ``checks`` (each compared number with
its limit), which also close standard error.

It exits non-zero without a result where CUDA is missing or has fewer
cards than the cell asks for, where the port cannot be imported, and where
the process has loaded JAX or the JAX package once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from portbench import harness  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench.run",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def result_line(r: harness.Run, metrics: dict) -> dict:
    import torch

    dev = r.device
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": r.cell.chips, "memory_peak_bytes": r.memory_peak_bytes}
    out = {"correct": r.correct, "attempted": r.attempted, "failed": r.failed,
           "metrics": metrics, "device": device}
    if r.trace and r.profiled is not None:
        device["busy_s"] = r.profiled.busy_s()
        device["window_s"] = r.profiled.wall_s
        out["breakdown"] = r.profiled.breakdown()
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in r.checks}
    return out


def metrics_of(r: harness.Run) -> dict:
    if not r.trace:
        return {m["name"]: {"value": r.e2e[m["name"]], "unit": m["unit"]}
                for m in r.cell.end_to_end}
    out = {}
    for m in r.cell.per_layer:
        value = r.cell.reader(m["name"]).read(r)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    cell = harness.Cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("portbench: CUDA is not available", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    r = harness.Run(cell, args.seed, args.seconds, bool(args.trace), T_START,
                    torch.device("cuda", 0))
    r.log(f"{args.workload} seed {args.seed}; card {card_line()}; peaks: "
          "H100 SXM 989 TFLOP/s bf16, 67 TFLOP/s f32, 3.35 TB/s")
    cell.driver().run(r)
    metrics = metrics_of(r)
    found = harness.loaded_forbidden()
    if found:
        print(f"portbench: the process loaded {', '.join(found)}",
              file=sys.stderr)
        return 4
    line = result_line(r, metrics)
    for name, v, lim in r.checks:
        ok = lim is not None and v <= lim
        print(f"check {name} {v!r} limit {lim!r} {'ok' if ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
