"""The port's span recorder (``uncertainty_model_tpu_torch/utils/scopes.py``)
as the per-layer metrics read it.

The program keeps its spans itself, always on: the drivers neither start
nor read the recorder, and a reader finds only what the program recorded.
A reader takes

* the measured window's spans: those that start and end inside
  ``[t_start + setup_s, + window_s]`` on ``perf_counter``, the clock the
  recorder reads (in ns);
* the profiled sub-window's: the spans after the window, mapped onto the
  trace's clock by the recorder's constant (``scopes.trace_offset_ns``,
  read from the scopes present in both), those inside the trace's
  profiler step kept.

A program without the recorder (a checkout from before it), a recorder
that overwrote a span of the interval, or no such span gives None.
"""

from __future__ import annotations

import bisect
import collections
import statistics
import time

PROFILER_STEP = "ProfilerStep#"


def recorder():
    """The port's ``utils.scopes`` where it keeps spans, else None."""
    try:
        from uncertainty_model_tpu_torch.utils import scopes
    except ImportError:
        return None
    if not (hasattr(scopes, "spans") and hasattr(scopes, "trace_offset_ns")):
        return None
    return scopes


def _window_ns(r):
    if r.setup_s is None or r.window_s is None:
        return None
    t0 = r.t_start + r.setup_s
    return round(t0 * 1e9), round((t0 + r.window_s) * 1e9)


def window_spans(r):
    """The measured window's spans (``scopes.Span``), or None."""
    rec, window = recorder(), _window_ns(r)
    if rec is None or window is None:
        return None
    return rec.spans(*window)


def mean_ms(r, name):
    """Mean ms of the window's spans named ``name``."""
    spans = window_spans(r)
    ms = [(s.end - s.start) / 1e6 for s in spans or () if s.name == name]
    return statistics.fmean(ms) if ms else None


def profiled_spans(r):
    """The profiled sub-window's spans as ``(name, start, end)`` in the
    trace's µs, or None."""
    rec, w, window = recorder(), r.profiled, _window_ns(r)
    if rec is None or w is None or window is None:
        return None
    spans = rec.spans(window[1], time.perf_counter_ns())
    if not spans:
        return None
    offset = rec.trace_offset_ns(w.events, spans)
    if offset is None:
        return None
    timed = [e for e in w.events if e.get("ph") == "X"]
    steps = [e for e in timed if e.get("name", "").startswith(PROFILER_STEP)]
    extent = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
              for e in steps or timed]
    lo, hi = min(a for a, _ in extent), max(b for _, b in extent)
    mapped = [(s.name, (s.start + offset) / 1e3, (s.end + offset) / 1e3)
              for s in spans]
    return [m for m in mapped if lo <= m[1] and m[2] <= hi]


def _intervals(r, name):
    mapped = profiled_spans(r)
    return sorted((a, b) for n, a, b in mapped or () if n == name)


def host_ops(r, outer):
    """Host operators a span named ``outer`` in the profiled sub-window:
    the ``cpu_op`` events, on any thread, that no other ``cpu_op`` of
    their thread holds and that start inside the span; the median over
    its spans, so that an operator a few µs from a mapped edge in one
    span does not move the count."""
    spans = _intervals(r, outer)
    if not spans:
        return None
    threads = collections.defaultdict(list)
    for e in r.profiled.events:
        if e.get("ph") == "X" and e.get("cat") == "cpu_op":
            s = float(e["ts"])
            threads[(e.get("pid"), e.get("tid"))].append(
                (s, s + float(e["dur"])))
    starts = [a for a, _ in spans]
    counts = [0] * len(spans)
    for ops in threads.values():
        end = None
        for s, t in sorted(ops, key=lambda o: (o[0], -o[1])):
            if end is not None and s < end:
                continue   # inside the operator before it
            end = t
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and s < spans[i][1]:
                counts[i] += 1
    return float(statistics.median(counts))


def idle_ms_inside(r, name):
    """Device-idle ms a span named ``name`` in the profiled sub-window:
    the time inside its spans in which no device operation ran."""
    spans = _intervals(r, name)
    if not spans or not r.profiled.device:
        return None
    busy = []
    for s, t in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in r.profiled.device):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], t)
        else:
            busy.append([s, t])
    idle = 0.0
    for a, b in spans:
        covered = sum(max(0.0, min(b, t) - max(a, s)) for s, t in busy
                      if s < b and t > a)
        idle += (b - a) - covered
    return idle / len(spans) / 1e3
