"""The readers of the port's span recorder (``portbench/spans.py``): on the
tiny cells, a window reader counts the window's spans alone (not set-up's
or the checked steps'); on a trace built from recorded spans, the profiled
readers take the traced steps alone, mapped by the recorder's constant;
and every reader returns None where the recorder overwrote the window's
spans, recorded nothing, or is not in the program."""

from __future__ import annotations

import statistics
import time
import types

import pytest

from portbench import harness, spans, trace
from portbench.tests.test_portbench_cells import run_cell
from uncertainty_model_tpu_torch.utils import scopes

PHASES = {"forward_host_ms.train": "train.forward",
          "loss_host_ms.train": "train.loss",
          "backward_host_ms.train": "train.backward",
          "adam_host_ms.train": "train.adam"}
SHIFT_NS = 5_000_000_000_123   # the made-up trace's clock less the recorder's


def _since(t_start):
    return scopes.spans(round(t_start * 1e9), time.perf_counter_ns())


def _mean_ms(recorded, name):
    return statistics.fmean((s.end - s.start) / 1e6 for s in recorded
                            if s.name == name)


def test_train_readers_count_the_window_alone(in_root):
    r = run_cell(in_root, "tiny-train-b8")
    window = spans.window_spans(r)
    steps = [s for s in window if s.name == "train.step"]
    assert len(steps) == r.counts["steps"]
    tr = r.traffic
    assert len([s for s in _since(r.t_start) if s.name == "train.step"]) == (
        r.counts["steps"] + tr["warmup_steps"] + tr["checked_steps"])
    total = 0.0
    for metric, name in PHASES.items():
        got = r.cell.reader(metric).read(r)
        assert len([s for s in window if s.name == name]) == len(steps)
        assert got == pytest.approx(_mean_ms(window, name), rel=1e-12)
        total += got
    step_ms = _mean_ms(window, "train.step")
    assert step_ms * 0.98 <= total <= step_ms


def test_stream_reader_counts_the_window_alone(in_root):
    r = run_cell(in_root, "tiny-stream-b1")
    window = spans.window_spans(r)
    serve = [s for s in window if s.name == "serve"]
    assert len(serve) == r.counts["requests"]
    assert len([s for s in _since(r.t_start) if s.name == "serve"]) == (
        r.counts["requests"] + r.traffic["warmup_requests"])
    assert r.cell.reader("forward_host_ms.stream").read(r) == pytest.approx(
        _mean_ms(window, "serve"), rel=1e-12)


def test_readers_return_none_without_the_window_spans(in_root, monkeypatch):
    small = scopes.Ring(16)
    monkeypatch.setattr(scopes, "RING", small)
    r = run_cell(in_root, "tiny-stream-b1")
    reader = r.cell.reader("forward_host_ms.stream")
    assert scopes.dropped() > 0
    assert reader.read(r) is None            # the window's spans overwritten
    monkeypatch.setattr(scopes, "RING", scopes.Ring(16))
    assert reader.read(r) is None            # nothing recorded
    monkeypatch.setattr(scopes, "RING", small)
    monkeypatch.delattr(scopes, "spans")     # a program without the recorder
    assert reader.read(r) is None
    train = harness.Cell("tiny-train-b8", in_root)
    for metric in list(PHASES) + ["adam_idle_ms.train", "host_ops.train"]:
        assert train.reader(metric).read(r) is None


def _step(adam_s):
    with scopes.scope("train.step"):
        with scopes.scope("train.forward"):
            time.sleep(adam_s)
        with scopes.scope("train.adam"):
            time.sleep(adam_s)


def _made_up_trace(traced):
    """A profiler trace of the recorded ``traced`` spans on a clock
    ``SHIFT_NS`` ahead: each scope's range, in each step three outermost
    operators on the main thread (one holding another) and one on a
    second, operators before and after the steps, and device work over the first
    half of each ``train.adam``."""
    def us(ns):
        return (ns + SHIFT_NS) / 1e3

    def x(cat, name, start_us, dur_us, tid=1):
        return {"ph": "X", "cat": cat, "name": name, "ts": start_us,
                "dur": dur_us, "pid": 1, "tid": tid}

    events = [x("user_annotation", s.name, us(s.start), (s.end - s.start)
                / 1e3) for s in traced]
    steps = [s for s in traced if s.name == "train.step"]
    events.append(x("user_annotation", "ProfilerStep#1", us(steps[0].start)
                    - 500, us(steps[-1].end) - us(steps[0].start) + 1000))
    for s in steps:
        a, d = us(s.start), (s.end - s.start) / 1e3
        events += [x("cpu_op", "aten::to", a + 0.1 * d, 0.1 * d),
                   x("cpu_op", "aten::copy_", a + 0.12 * d, 0.05 * d),
                   x("cpu_op", "aten::mul", a + 0.3 * d, 0.1 * d),
                   x("cpu_op", "aten::add", a + 0.6 * d, 0.1 * d),
                   x("cpu_op", "aten::mm", a + 0.4 * d, 0.1 * d, tid=2)]
    events += [x("cpu_op", "aten::fill_", us(steps[0].start) - 300, 50),
               x("cpu_op", "aten::fill_", us(steps[-1].end) + 100, 50)]
    for s in traced:
        if s.name == "train.adam":
            events.append(x("kernel", "k", us(s.start),
                            (s.end - s.start) / 2e3))
    return events


def test_profiled_readers_map_the_traced_steps_alone():
    t_start = time.perf_counter()
    _step(0.002)                                   # the window's step
    window_s = time.perf_counter() - t_start
    after = time.perf_counter_ns()
    for _ in range(5):   # the profiler's warm-up step, 2 traced, 2 checked
        _step(0.002)
    recorded = scopes.spans(after, time.perf_counter_ns())
    roots = sorted({s.root for s in recorded})
    traced = [s for s in recorded if s.root in roots[1:3]]
    events = _made_up_trace(traced)
    r = types.SimpleNamespace(t_start=t_start, setup_s=0.0,
                              window_s=window_s,
                              profiled=trace.Window(events, 0.01, 2))
    assert spans.host_ops(r, "train.step") == 4.0
    idle = statistics.fmean((s.end - s.start) / 2e6 for s in traced
                            if s.name == "train.adam")
    assert spans.idle_ms_inside(r, "train.adam") == pytest.approx(idle,
                                                                 rel=1e-6)
    window = [s for s in scopes.spans(round(t_start * 1e9), after)]
    assert spans.mean_ms(r, "train.adam") == pytest.approx(
        _mean_ms(window, "train.adam"), rel=1e-12)
    # a trace whose ranges the recorder does not hold maps nothing
    for e in events:
        e["name"] = e["name"].replace("train.", "other.")
    assert spans.host_ops(r, "train.step") is None
    assert spans.idle_ms_inside(r, "train.adam") is None
