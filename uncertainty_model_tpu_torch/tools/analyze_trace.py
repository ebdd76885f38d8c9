"""Per-scope and per-operator attribution of a ``torch.profiler`` trace
(the port of ``tools/analyze_trace.py``, which joins a ``jax.profiler``
trace with the HLO's ``op_name``)::

    python -m uncertainty_model_tpu_torch.tools.analyze_trace <trace> \\
        [depth] [divisor]

``<trace>`` is the chrome JSON that ``prof.export_chrome_trace`` wrote, or
a directory holding it as ``trace.json`` (``trace_chained``'s and
``trace_infer``'s outdir); in the same process ``load_events`` also takes
the profiler object.  ``depth``: the scope path's components the BY MODULE
table keeps (default 2); ``divisor``: every duration is divided by it
(the k of a chain of k passes, so that the numbers read as ms a pass).

Each device kernel, memcpy and memset goes to the innermost scope
(``utils/scopes.py``) that encloses it, as a path of the enclosing scopes
(``enc1``, ``dec4``):

1. the device join: the scopes' device-side ranges (``gpu_user_annotation``,
   the span of the device work launched inside the scope): a kernel whose
   device interval lies inside ``dec4``'s range is ``dec4``'s;
2. the host join, where no range holds it: its launch (the runtime or
   driver call with its correlation id) lies inside the scope's host range
   (``user_annotation``), or inside none: ``(outside)``;
3. else ``(unattributed)``, with the reason.  The port's kernels are
   launched through ``ctypes`` from a library that ``_build.py`` links
   itself: where the profiler records their device work but not their
   launch, only the device join places them.

Its operator is the hand kernel's name (``ops/kernels.py::hand_kernel``),
else the outermost aten operator around its launch, else the kernel's own
name.
The profiler's own ``ProfilerStep#N`` ranges around a schedule's steps
are no scope.

``lost_device_records`` lists the launches (``launch_records``) that no
device record answers by its correlation id; every window the tools
profile fails on one (``trace_chained.profile``).

A trace with no device activity (one taken on the CPU) is attributed by
the host alone: each aten operator's self time (its duration less its
child operators') goes to the scopes around it, or ``(outside)``.

It prints what the JAX tool prints: the total, the top 30 (scope,
operator) rows and the BY MODULE table, with ``(outside)`` (device time
under no scope) and ``(unattributed)`` rows; for a trace with device
activity also the top 30 (scope, device function) rows, which tell apart
the kernels one operator launches.
"""

from __future__ import annotations

import collections
import json
import os
import re
import sys
import tempfile

from ..ops.kernels import hand_kernel

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
LAUNCH_NAME = re.compile(r"Launch|Memcpy|Memset")
# the profiler's own range around each step of a schedule: no scope
PROFILER_STEP = re.compile(r"ProfilerStep#\d+$")
OUTSIDE = "(outside)"
UNATTRIBUTED = "(unattributed)"
NO_LAUNCH = ("no scope's device range holds it and its launch is not in the "
             "trace")
TRACE_FILE = "trace.json"


def launch_records(events) -> list:
    """The runtime and driver calls in ``events`` that put work on the
    device: kernel launches (``cudaLaunchKernel``, ``cuLaunchKernelEx``,
    ``cudaGraphLaunch``, ...), copies and sets, each with its correlation
    id.  A host function enqueued on a stream is no device work."""
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
            and LAUNCH_NAME.search(e.get("name", ""))
            and "HostFunc" not in e["name"]
            and e.get("args", {}).get("correlation") is not None]


def lost_device_records(trace) -> list:
    """The launch records of ``trace`` (a chrome JSON path, a directory
    holding ``trace.json``, a ``torch.profiler.profile`` or a list of
    events) that no device record (kernel, memcpy or memset) answers by its
    correlation id: the work the profiler saw enqueued but not run."""
    events = trace if isinstance(trace, list) else load_events(trace)
    ran = {e.get("args", {}).get("correlation") for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS}
    return [e for e in launch_records(events)
            if e["args"]["correlation"] not in ran]


def load_events(source) -> list:
    """The trace events of ``source``: a chrome JSON path, a directory
    holding ``trace.json``, or a ``torch.profiler.profile`` object (its
    trace exported to a temporary file and read back)."""
    if hasattr(source, "export_chrome_trace"):
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, TRACE_FILE)
            source.export_chrome_trace(path)
            return load_events(path)
    if os.path.isdir(source):
        source = os.path.join(source, TRACE_FILE)
    with open(source) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


class _Span:
    __slots__ = ("name", "kind", "start", "end", "children_us")

    def __init__(self, e, kind):
        self.name, self.kind = e["name"], kind
        self.start = float(e["ts"])
        self.end = self.start + float(e.get("dur", 0.0))
        self.children_us = 0.0


def _enclosing(spans):
    """``(span, the spans around it, outermost first)`` for each of one
    thread's nested spans, in the order they start."""
    stack = []
    for s in sorted(spans, key=lambda s: (s.start, -(s.end - s.start))):
        while stack and stack[-1].end <= s.start:
            stack.pop()
        yield s, list(stack)
        stack.append(s)


def _scope_range(e) -> bool:
    return not PROFILER_STEP.match(e["name"])


def _by_thread(events, cats):
    threads = collections.defaultdict(list)
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") in cats
                and (e["cat"] != "user_annotation" or _scope_range(e))):
            kind = "scope" if e["cat"] == "user_annotation" else "op"
            threads[(e.get("pid"), e.get("tid"))].append(_Span(e, kind))
    return threads


def _union_us(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def attribute(events, divisor: float = 1.0) -> dict:
    """The attribution of ``events`` (see the module docstring), every
    time in ms divided by ``divisor``: ``device`` (True where the trace
    has device activity), ``total_ms`` (the device work's summed
    durations; on the CPU the operators' self times), ``busy_ms`` (the
    union of the device work's intervals; the total on the CPU),
    ``by_scope`` ({path: ms}), ``rows`` ({(path, operator): [ms, count]}),
    ``unattributed`` ({reason: ms}), ``joins`` ({"device" | "host" |
    "none": count}) and ``items`` (one ``(path, operator, name, start_us,
    ms, operators)`` per event: ``operators`` the aten operators around
    its launch, outermost first)."""
    device = [e for e in events
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if device:
        items, unattributed, joins = _device_items(events, device)
        busy = _union_us((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                         for e in device) / 1e3
    else:
        items, unattributed, joins = _host_items(events), {}, {}
        busy = None
    rows = collections.defaultdict(lambda: [0.0, 0])
    by_scope = collections.Counter()
    items = [(path, op, name, start, ms / divisor, chain)
             for path, op, name, start, ms, chain in items]
    for path, op, _, _, ms, _ in items:
        rows[(path, op)][0] += ms
        rows[(path, op)][1] += 1
        by_scope[path] += ms
    total = sum(by_scope.values())
    return {"device": bool(device), "total_ms": total,
            "busy_ms": total if busy is None else busy / divisor,
            "by_scope": dict(by_scope), "rows": dict(rows),
            "unattributed": {k: v / divisor for k, v in unattributed.items()},
            "joins": joins, "items": items}


def _device_items(events, device):
    ranges = [_Span(e, "scope") for e in events
              if e.get("ph") == "X" and e.get("cat") == "gpu_user_annotation"
              and _scope_range(e)]
    ranges.sort(key=lambda s: (s.start, -(s.end - s.start)))
    # the host join: the scopes and operators around each launch (a span
    # of no duration, named by its correlation id)
    threads = _by_thread(events, ("user_annotation", "cpu_op"))
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS and corr is not None:
            threads[(e.get("pid"), e.get("tid"))].append(
                _Span({"name": corr, "ts": e["ts"]}, "launch"))
    host = {s.name: around for spans in threads.values()
            for s, around in _enclosing(spans) if s.kind == "launch"}
    items, unattributed = [], collections.Counter()
    joins = collections.Counter()
    eps = 1e-3   # us: the trace's timestamps are in whole nanoseconds
    for e in device:
        start = float(e["ts"])
        end = start + float(e["dur"])
        corr = e.get("args", {}).get("correlation")
        around = host.get(corr, [])
        ops = [s.name for s in around if s.kind == "op"]
        op = hand_kernel(e["name"]) or (ops[0] if ops else e["name"][:80])
        inside = [r.name for r in ranges
                  if r.start - eps <= start and end <= r.end + eps]
        if inside:
            path, join = "/".join(inside), "device"
        elif corr in host:
            path = "/".join(s.name for s in around if s.kind == "scope")
            path, join = path or OUTSIDE, "host"
        else:
            path, join = UNATTRIBUTED, "none"
            unattributed[NO_LAUNCH] += float(e["dur"]) / 1e3
        joins[join] += 1
        items.append((path, op, e["name"], start, float(e["dur"]) / 1e3,
                      tuple(ops)))
    return items, dict(unattributed), dict(joins)


def _host_items(events):
    """A CPU trace: each operator's self time under its scopes."""
    items = []
    for spans in _by_thread(events, ("user_annotation", "cpu_op")).values():
        ops = []
        for s, around in _enclosing(spans):
            if s.kind != "op":
                continue
            parents = [a for a in around if a.kind == "op"]
            if parents:
                parents[-1].children_us += s.end - s.start
            ops.append((s, "/".join(a.name for a in around
                                    if a.kind == "scope"),
                        tuple(a.name for a in parents) + (s.name,)))
        items += [(path or OUTSIDE, s.name, s.name, s.start,
                   (s.end - s.start - s.children_us) / 1e3, chain)
                  for s, path, chain in ops]
    return items


def by_module(result: dict, depth: int) -> dict:
    """``result["by_scope"]`` with each path cut to its first ``depth``
    components."""
    out = collections.Counter()
    for path, ms in result["by_scope"].items():
        out["/".join(path.split("/")[:depth])] += ms
    return dict(out)


def by_function(result: dict) -> list:
    """``((path, device function), [ms, count])`` of ``result``'s items,
    the most ms first: the kernels an operator launched, each on its own
    (a cuDNN conv's padding copy apart from the conv)."""
    rows = collections.defaultdict(lambda: [0.0, 0])
    for path, _, name, _, ms, _ in result["items"]:
        rows[(path, name)][0] += ms
        rows[(path, name)][1] += 1
    return sorted(rows.items(), key=lambda kv: -kv[1][0])


def report(result: dict, depth: int = 2, top: int = 30) -> str:
    """The JAX tool's printout of ``attribute``'s result."""
    what = "device time" if result["device"] else "host self time (CPU trace)"
    lines = [f"total: {result['total_ms']:.3f} ms of {what}"
             + (f", device busy {result['busy_ms']:.3f} ms"
                if result["device"] else "")]
    if result["joins"]:
        lines.append("joins: " + ", ".join(
            f"{k} {v}" for k, v in sorted(result["joins"].items())))
    lines.append(f"\nTOP {top} (scope, operator) (ms):")
    rows = sorted(result["rows"].items(), key=lambda kv: -kv[1][0])
    for (path, op), (ms, n) in rows[:top]:
        lines.append(f"{ms:9.3f}  x{n:<5d} {path[:24]:<24s} {op[:70]}")
    if result["device"]:
        lines.append(f"\nTOP {top} (scope, device function) (ms):")
        for (path, name), (ms, n) in by_function(result)[:top]:
            lines.append(f"{ms:9.3f}  x{n:<5d} {path[:24]:<24s} {name[:90]}")
    lines.append(f"\nBY MODULE (depth {depth}):")
    for path, ms in sorted(by_module(result, depth).items(),
                           key=lambda kv: -kv[1]):
        lines.append(f"{ms:9.3f}  {path}")
    for reason, ms in result["unattributed"].items():
        lines.append(f"{UNATTRIBUTED} {ms:.3f} ms: {reason}")
    return "\n".join(lines)


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise SystemExit(__doc__)
    depth = int(argv[1]) if len(argv) > 1 else 2
    divisor = float(argv[2]) if len(argv) > 2 else 1.0
    result = attribute(load_events(argv[0]), divisor)
    print(report(result, depth), flush=True)
    return result


if __name__ == "__main__":
    main()
