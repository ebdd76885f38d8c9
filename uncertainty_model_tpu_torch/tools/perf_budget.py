"""Per-scope budget of the serving forward: the measured ms beside the
bytes floor and the tensor-core floor (the port of ``tools/perf_budget.py``:
"no kernel work without a budget that says where the bytes/FLOPs actually
are")::

    python -m uncertainty_model_tpu_torch.tools.perf_budget <outdir> [k] \\
        [depth] [--hbm-gbps 3350] [--tflops 989]

``<outdir>`` is ``trace_chained``'s: its ``trace.json`` (the profiler's
trace of a chain of k passes, default 3) and its ``budget.json`` (this
module's ``Recorder`` over one pass of the same forward, in the same
scopes).  For every scope (the path cut to ``depth`` components, default
1):

  bytes  = the operands and outputs of each aten operation (``Recorder``, a
           ``TorchDispatchMode``), each counted once; view and alias
           operations move nothing and count 0, an in-place operation's
           buffer counts on both sides (read and written), the destination
           of ``copy_``, ``fill_`` and ``zero_`` once (written only); a hand
           kernel's through ``utils/scopes.py::note_kernel``;
  flops  = 2 x MACs of the convolution and matmul operations, by the
           formulas of ``torch.utils.flop_counter`` (elementwise work is
           never the bound here and is not counted), plus the conv kernels'
           (``gated_conv_elu``, ``conv_elu``) through ``note_kernel``;

  floor_ms = max(bytes / HBM rate, flops / tensor-core rate)

beside the trace's measured ms a pass (``analyze_trace``), then the gap.
The rates are the H100 SXM's data-sheet peaks (3.35 TB/s, 989 dense bf16
TFLOP/s at 700 W), the flags' defaults.  Two whole-forward lines follow:
the floor total over the measured total (the floor share) and the FLOPs
over measured time x the tensor-core rate (the tensor-core FLOP share).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..utils import scopes
from . import analyze_trace

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
F32_FLOP_PER_S = 67e12      # H100 SXM f32 outside the tensor cores
BF16_FLOP_PER_S = 989e12    # H100 SXM dense bf16 on the tensor cores
BUDGET_FILE = "budget.json"
# operations that allocate or alias and move no data
NO_DATA = frozenset({"empty", "empty_like", "empty_strided", "detach",
                     "alias", "lift_fresh", "resize_", "set_"})
# in-place operations that write their first operand without reading it
WRITE_ONLY = frozenset({"copy_", "fill_", "zero_"})


def op_bytes(func, args, kwargs, out) -> int:
    """The bytes one aten operation moves (the module docstring's rule)."""
    name = func.overloadpacket.__name__
    if func.is_view or name in NO_DATA:
        return 0
    operands = [t for t in tree_flatten(
        (args, {k: v for k, v in kwargs.items() if k != "out"}))[0]
        if isinstance(t, torch.Tensor)]
    if name in WRITE_ONLY:
        operands = operands[1:]
    outputs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
    return sum(scopes.tensor_bytes(t) for t in (*operands, *outputs))


def op_flops(func, args, kwargs, out) -> float:
    """2 x MACs of a convolution or matmul operation, else 0."""
    count = flop_registry.get(func.overloadpacket)
    return float(count(*args, **kwargs, out_val=out)) if count else 0.0


class Recorder(TorchDispatchMode):
    """Counts, per (scope path, operation), the calls, bytes and FLOPs of
    what runs inside ``with Recorder() as rec:`` on this thread: aten
    operations (outside ``utils/scopes.py::uncounted``; inside
    ``model_flops`` their FLOPs times its share) and the hand kernels'
    ``note_kernel`` calls."""

    def __init__(self):
        super().__init__()
        self.rows = collections.defaultdict(lambda: [0, 0, 0.0])
        self.kernels = set()   # the hand kernels' names seen

    def __enter__(self):
        super().__enter__()
        scopes.attach(self)
        return self

    def __exit__(self, *exc):
        scopes.detach(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        # the scopes' own profiler calls are no work of the forward's
        if scopes.counting() and func.namespace != "profiler":
            self._add(scopes.current(), func.overloadpacket.__name__,
                      op_bytes(func, args, kwargs, out),
                      op_flops(func, args, kwargs, out) * scopes.flop_share())
        return out

    def kernel(self, path, name, nbytes, flops):
        """``note_kernel``'s entry point."""
        self.kernels.add(name)
        self._add(path, name, nbytes, flops)

    def _add(self, path, name, nbytes, flops):
        row = self.rows[(path or analyze_trace.OUTSIDE, name)]
        row[0] += 1
        row[1] += nbytes
        row[2] += flops

    def to_json(self) -> dict:
        return {"rows": [[path, name, *row]
                         for (path, name), row in self.rows.items()],
                "kernels": sorted(self.kernels)}


def load_counts(source):
    """``({(path, operation): [calls, bytes, flops]}, the hand kernels'
    names)`` from a ``Recorder``'s ``to_json()`` or an outdir holding it as
    ``budget.json``."""
    if isinstance(source, str):
        with open(os.path.join(source, BUDGET_FILE)) as f:
            source = json.load(f)
    rows = {(path, name): [calls, nbytes, flops]
            for path, name, calls, nbytes, flops in source["rows"]}
    return rows, set(source["kernels"])


def _cut(path: str, depth: int) -> str:
    return "/".join(path.split("/")[:depth])


def _operation(path, op, chain, rows, kernels):
    """The recorder's name for a trace item: the hand kernel, else the
    first aten operator around its launch that the recorder counted in
    the same scope, else the outermost."""
    if op in kernels:
        return op
    names = [c.removeprefix("aten::") for c in chain]
    for name in names:
        if (path, name) in rows:
            return name
    return names[0] if names else op


def budget(trace, counts, depth: int = 1,
           hbm_bytes_per_s: float = HBM_BYTES_PER_S,
           flop_per_s: float = BF16_FLOP_PER_S) -> dict:
    """The budget table's numbers: ``trace`` is ``analyze_trace.attribute``'s
    result a pass (its divisor the chain's k), ``counts`` ``load_counts``'s
    source (one pass).  Returns ``scopes`` ({scope: {ms, gb, bw_ms,
    gflop, tc_ms, floor_ms, gap_ms}}), ``total`` (the same over every
    scope, the floor summed per scope), ``floor_share`` (floor total over
    measured total), ``tc_flop_share`` (FLOPs over measured time x the
    tensor-core rate) and ``ops`` (the top rows: per (scope, operation),
    measured ms beside its bytes and tensor-core floors)."""
    rows, kernels = load_counts(counts)
    per = collections.defaultdict(lambda: [0.0, 0.0, 0.0])  # ms, bytes, flops
    for path, ms in trace["by_scope"].items():
        per[_cut(path, depth)][0] += ms
    for (path, _), (_, nbytes, flops) in rows.items():
        per[_cut(path, depth)][1] += nbytes
        per[_cut(path, depth)][2] += flops

    def line(ms, nbytes, flops):
        bw_ms = nbytes / hbm_bytes_per_s * 1e3
        tc_ms = flops / flop_per_s * 1e3
        return {"ms": ms, "gb": nbytes / 1e9, "bw_ms": bw_ms,
                "gflop": flops / 1e9, "tc_ms": tc_ms,
                "floor_ms": max(bw_ms, tc_ms), "gap_ms": ms - max(bw_ms, tc_ms)}

    table = {scope: line(*v) for scope, v in per.items()}
    total = line(*(sum(v[i] for v in per.values()) for i in range(3)))
    total["floor_ms"] = sum(t["floor_ms"] for t in table.values())
    total["gap_ms"] = total["ms"] - total["floor_ms"]
    # the top rows: the trace's (scope, operator) rows by measured ms, with
    # the recorder's bytes and FLOPs of the same (scope, operation)
    measured = collections.Counter()
    for path, op, _, _, ms, chain in trace["items"]:
        measured[(path, _operation(path, op, chain, rows, kernels))] += ms
    ops = []
    for (path, op), ms in measured.most_common():
        _, nbytes, flops = rows.get((path, op), (0, 0, 0.0))
        ops.append({"scope": path, "op": op, "ms": ms,
                    "bw_ms": nbytes / hbm_bytes_per_s * 1e3,
                    "tc_ms": flops / flop_per_s * 1e3,
                    "counted": (path, op) in rows})
    return {"scopes": table, "total": total,
            "floor_share": total["floor_ms"] / total["ms"],
            "tc_flop_share": total["gflop"] * 1e9 / (
                total["ms"] / 1e3 * flop_per_s),
            "busy_ms": trace["busy_ms"], "ops": ops,
            "hbm_bytes_per_s": hbm_bytes_per_s, "flop_per_s": flop_per_s}


def report(result: dict, top: int = 30, card: str = "") -> str:
    """The JAX tool's printout of ``budget``'s result."""
    head = (f"{'scope':<22}{'meas ms':>9}{'GB':>8}{'bw ms':>8}"
            f"{'GFLOP':>9}{'tc ms':>8}{'floor':>8}{'gap':>8}")
    lines = [card] if card else []
    lines += [f"rates: {result['hbm_bytes_per_s'] / 1e12:.3g} TB/s, "
              f"{result['flop_per_s'] / 1e12:.4g} TFLOP/s (tensor cores)",
              head]

    def fmt(name, r):
        return (f"{name[:21]:<22}{r['ms']:9.3f}{r['gb']:8.3f}{r['bw_ms']:8.3f}"
                f"{r['gflop']:9.1f}{r['tc_ms']:8.3f}{r['floor_ms']:8.3f}"
                f"{r['gap_ms']:8.3f}")

    for name, r in sorted(result["scopes"].items(), key=lambda kv: kv[0]):
        lines.append(fmt(name, r))
    lines.append(fmt("TOTAL", result["total"]))
    lines.append(f"floor share (floor total / measured): "
                 f"{result['floor_share']:.4f}")
    lines.append(f"tensor-core FLOP share (FLOPs / (measured x "
                 f"{result['flop_per_s'] / 1e12:.4g} TFLOP/s)): "
                 f"{result['tc_flop_share']:.4f}")
    lines.append(f"device busy {result['busy_ms']:.3f} ms a pass")
    lines.append(f"\nTOP {top} (scope, operation) by measured ms:")
    for r in result["ops"][:top]:
        lines.append(f"{r['ms']:8.3f} ms  bw{r['bw_ms']:8.3f}  "
                     f"tc{r['tc_ms']:8.3f}  {r['scope'][:16]:<16s} "
                     f"{r['op'][:60]}" + ("" if r["counted"] else "  (not in "
                                          "the recorder's counts)"))
    return "\n".join(lines)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        prog="python -m uncertainty_model_tpu_torch.tools.perf_budget",
        description="Per-scope budget of trace_chained's outdir.")
    parser.add_argument("outdir")
    parser.add_argument("k", nargs="?", type=float, default=3.0)
    parser.add_argument("depth", nargs="?", type=int, default=1)
    parser.add_argument("--hbm-gbps", type=float,
                        default=HBM_BYTES_PER_S / 1e9)
    parser.add_argument("--tflops", type=float,
                        default=BF16_FLOP_PER_S / 1e12)
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    trace = analyze_trace.attribute(analyze_trace.load_events(args.outdir),
                                    args.k)
    result = budget(trace, args.outdir, args.depth, args.hbm_gbps * 1e9,
                    args.tflops * 1e12)
    card = ""
    card_file = os.path.join(args.outdir, "card.txt")
    if os.path.exists(card_file):
        with open(card_file) as f:
            card = f.read().strip()
    print(report(result, card=card), flush=True)
    return result


if __name__ == "__main__":
    main()
