"""The port's span recorder (``utils/scopes.py``) on the CPU, on the tiny
config:

- nested scopes and spans record their parents and their outermost span,
  and a ``span`` is no part of the scope path;
- the ring overwrites its oldest records, counts them as dropped, and
  ``spans`` refuses an interval that lost one, also with threads closing
  scopes at once;
- an epoch of one tiny step records ``train.load`` around each wait for a
  batch and one ``train.step`` whose children (``train.forward``,
  ``train.loss``, ``train.backward``, ``train.adam``, and ``train.disc``
  with a discriminator) cover it end to end;
- a tiny serving forward records ``serve`` around ``enc0``-``enc4`` and
  ``dec0``-``dec4``;
- under a CPU ``torch.profiler``, each recorded scope has its
  ``user_annotation``, and ``trace_offset_ns`` gives the constant that
  maps the recorder's starts onto the ranges' (their offsets' quartiles
  within ``MAP_NS``), and each span inside its range.
"""

import collections
import json
import statistics
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tiny_config import TINY_DISCRIMINATOR, TINY_INPUT, TINY_LOSS, TINY_MODEL

from uncertainty_model_tpu_torch.models import (RandomDiscriminator,
                                                RandomlyConnectedModel)
from uncertainty_model_tpu_torch.serving import make_serving_forward
from uncertainty_model_tpu_torch.train import Trainer
from uncertainty_model_tpu_torch.utils import scopes

STAGES = [f"enc{i}" for i in range(5)] + [f"dec{i}" for i in range(5)]
PHASES = ["train.forward", "train.loss", "train.backward", "train.adam"]
UNCOVERED = 0.02     # of a step: what its children leave out
MAP_NS = 100_000     # the recorder's times on the trace's clock


def _recorded(fn):
    t0 = time.perf_counter_ns()
    out = fn()
    got = scopes.spans(t0, time.perf_counter_ns())
    assert got is not None
    return out, got


def _batch(seed, b=2):
    rng = np.random.default_rng(seed)
    return {side: rng.uniform(size=(b, *TINY_INPUT, 3)).astype(np.float32)
            for side in ("left", "right")}


def _trainer(disc):
    model = RandomlyConnectedModel.from_config(**TINY_MODEL, device="cpu")
    d = (RandomDiscriminator.from_config(**TINY_DISCRIMINATOR, device="cpu")
         if disc else None)
    return Trainer(model, TINY_LOSS, disc=d, device="cpu")


def test_nested_scopes_record_parents_and_roots():
    paths = {}

    def nest():
        with scopes.scope("a") as a:
            with scopes.span("b") as b:
                with scopes.scope("c") as c:
                    paths["c"] = scopes.current()
                paths["b"] = scopes.current()
            with scopes.scope("d") as d:
                pass
        with scopes.scope("e") as e:
            pass
        return a, b, c, d, e

    (a, b, c, d, e), got = _recorded(nest)
    assert [s.name for s in got] == ["a", "b", "c", "d", "e"]
    by = {s.name: s for s in got}
    assert [by[n].id for n in "abcde"] == [x.id for x in (a, b, c, d, e)]
    assert (by["a"].parent, by["a"].root) == (-1, a.id)
    assert (by["b"].parent, by["b"].root) == (a.id, a.id)
    assert (by["c"].parent, by["c"].root) == (b.id, a.id)
    assert (by["d"].parent, by["d"].root) == (a.id, a.id)
    assert (by["e"].parent, by["e"].root) == (-1, e.id)
    assert paths == {"c": "a/c", "b": "a"}
    s = by
    assert (s["a"].start < s["b"].start < s["c"].start < s["c"].end
            < s["b"].end < s["d"].start < s["d"].end < s["a"].end
            < s["e"].start < s["e"].end)


def test_ring_overwrites_the_oldest_and_counts_them(monkeypatch):
    with pytest.raises(ValueError, match="power of two"):
        scopes.Ring(6)
    ring = scopes.Ring(8)
    monkeypatch.setattr(scopes, "RING", ring)
    t0 = time.perf_counter_ns()
    marks = []
    for i in range(12):
        with scopes.scope(f"s{i}"):
            pass
        marks.append(time.perf_counter_ns())
    t1 = time.perf_counter_ns()
    assert scopes.dropped() == 4
    assert scopes.spans(t0, t1) is None
    kept = scopes.spans(marks[3], t1)
    assert [s.name for s in kept] == [f"s{i}" for i in range(4, 12)]
    assert [s.name for s in scopes.spans(marks[5], marks[8])] == [
        "s6", "s7", "s8"]


def test_threads_record_their_own_spans(monkeypatch):
    """Threads closing scopes at once, with new names and past the ring's
    capacity, lose no name and no overwrite count."""
    ring = scopes.Ring(256)
    monkeypatch.setattr(scopes, "RING", ring)
    n_threads, n_spans = 8, 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=_nested, args=(k, n_spans))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert scopes.dropped() == 2 * n_threads * n_spans - 256
    now = time.perf_counter_ns()
    assert ring.spans(0, now) is None   # the oldest were overwritten
    kept = ring.spans(ring.lost_start + 1, now)
    assert kept
    by_id = {s.id: s for s in kept}
    for s in kept:
        if s.name.endswith(".inner"):
            outer = by_id.get(s.parent)
            assert outer is None or outer.name + ".inner" == s.name
            assert s.root == s.parent


def _nested(k, n):
    for _ in range(n):
        with scopes.scope(f"t{k}"):
            with scopes.scope(f"t{k}.inner"):
                pass


@pytest.mark.parametrize("disc", [False, True], ids=["plain", "disc"])
def test_train_step_children_cover_the_step(disc):
    trainer = _trainer(disc)
    _, got = _recorded(lambda: trainer.train_one_epoch(
        [_batch(3)], 0.3, 1e-4))
    assert [s.name for s in got if s.name == "train.load"] == [
        "train.load"] * 2   # the batch, then the loader's end
    steps = [s for s in got if s.name == "train.step"]
    assert len(steps) == 1
    step = steps[0]
    inside = [s for s in got if s.root == step.id and s.id != step.id]
    assert all(s.start >= step.start and s.end <= step.end for s in inside)
    children = [s for s in inside if s.parent == step.id]
    assert [s.name for s in children] == PHASES + (["train.disc"] if disc
                                                   else [])
    assert all(a.end <= b.start for a, b in zip(children, children[1:]))
    covered = sum(s.end - s.start for s in children)
    assert step.end - step.start - covered <= UNCOVERED * (step.end
                                                           - step.start)


def test_serving_forward_records_serve_around_the_stages():
    model = RandomlyConnectedModel.from_config(**TINY_MODEL,
                                               device="cpu").eval()
    forward = make_serving_forward(model, torch.float32, "cpu")
    x = torch.from_numpy(_batch(4)["left"])
    _, got = _recorded(lambda: forward(x))
    assert [s.name for s in got] == ["serve"] + STAGES
    serve = got[0]
    assert all(s.parent == serve.id and s.root == serve.id
               and serve.start <= s.start and s.end <= serve.end
               for s in got[1:])


def test_profiler_ranges_map_onto_the_recorder(tmp_path):
    """Every recorded scope has its range in the trace, one constant maps
    the recorder's starts and ends onto the ranges', and ``serve`` (a
    ``span``) has none."""
    trainer = _trainer(False)
    model = RandomlyConnectedModel.from_config(**TINY_MODEL,
                                               device="cpu").eval()
    forward = make_serving_forward(model, torch.float32, "cpu")
    x = torch.from_numpy(_batch(5)["left"])

    def work():
        trainer.train_step(_batch(6), 0.3, 1e-4)
        forward(x)

    work()
    t0 = time.perf_counter_ns()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        work()
    after = time.perf_counter_ns()
    work()
    got = scopes.spans(t0, time.perf_counter_ns())
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {s.name for s in got}
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation" and e["name"] in names]
    traced = [s for s in got if s.end <= after]
    ranged = collections.Counter(e["name"] for e in events)
    assert ranged == collections.Counter(s.name for s in traced
                                         if s.name != "serve")
    offset = scopes.trace_offset_ns(events, got)
    assert offset is not None
    marks = sorted(events, key=lambda e: e["ts"])
    mapped = [s for s in traced if s.name != "serve"]
    assert [e["name"] for e in marks] == [s.name for s in mapped]
    starts = [e["ts"] * 1e3 - s.start for e, s in zip(marks, mapped)]
    # their spread, first to third quartile (a thread preempted between
    # the range's stamp and the clock read puts one offset out of line)
    q1, _, q3 = statistics.quantiles(starts, n=4)
    assert q3 - q1 <= MAP_NS
    assert min(starts) <= offset <= max(starts)
    # each span, mapped, lies inside its range (the scope reads the clock
    # once inside it)
    for e, s in zip(marks, mapped):
        assert e["ts"] * 1e3 - MAP_NS <= s.start + offset
        assert s.end + offset <= (e["ts"] + e["dur"]) * 1e3 + MAP_NS
