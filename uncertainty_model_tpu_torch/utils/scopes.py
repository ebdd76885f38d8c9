"""Named scopes (the port's ``jax.named_scope``) and the budget hook of the
hand-written kernels.

``scope(name)`` names a stretch of the program: while a profiler records
(torch's own fast check, ``torch.autograd.profiler._is_profiler_enabled``)
it enters ``torch.profiler.record_function(name)``, so the profiler's host
trace holds the range (a ``user_annotation``) and its device trace the
span of the kernels launched inside it (a ``gpu_user_annotation``); a
range costs ~10 µs of host time, none is opened when nothing records.  It
pushes ``name`` on this thread's scope stack, which a budget recorder
(``tools/perf_budget.py::Recorder``) reads to file each operation under
its scope.  The serving forward runs each encoder stage in ``enc{i}`` and
each decoder stage in ``dec{i}``, as the JAX package's does.

A hand-written kernel is launched through ``ctypes``, so no aten operation
shows its operands to a recorder.  Its wrapper calls
``note_kernel(name, inputs, outputs, flops)`` instead, on the CUDA branch
and on the CPU branch alike, and runs its plain version under
``uncounted()`` so that the plain version's aten operations are not
counted a second time.  ``note_kernel`` does nothing unless a recorder is
active.  The bytes of a call are those of its operands and outputs, each
counted once; a buffer updated in place is an operand and an output, and
so counted on both sides, by the JAX tool's rule
(``tools/perf_budget.py:11-13``).  The JAX tool gives a Pallas call bytes
and no FLOPs; the conv kernels (``gated_conv_elu``, ``conv_elu``) also
give their FLOPs, 2 x MACs, because their bound is by operations.

Every scope that closes also leaves a record in an in-memory span
recorder, always on: its name, its start and end on
``time.perf_counter_ns()`` (the clock of ``time.perf_counter``), the
record of the scope around it on this thread, and the outermost one's (a
training step, a served request).  The records sit in preallocated
integer arrays (``Ring``, ``CAPACITY`` spans, ~12 MB), names as small
ids; once full, each new record overwrites the oldest and ``dropped()``
counts it.  A span costs two clock reads and one record (~1.3 µs of
host time on an H100 machine's host): no tensor operation, no device
sync, and the recorder never grows.  ``spans(t0, t1)`` returns
the spans between two ``perf_counter_ns`` times; ``trace_offset_ns``
maps them onto a ``torch.profiler`` trace's clock, so that a gap or an
operator in the trace is put down to the span that was open.  The spans
where the work happens: ``train.step`` around ``Trainer.train_step``,
partitioned by ``train.forward``, ``train.loss``, ``train.backward``,
``train.adam`` (and ``train.disc``, ``train.reduce``); ``train.load``
around each wait for the loader; ``serve`` around a serving forward.
``serve`` is a ``span``: the recorder's alone, with no profiler range
and no part of ``current()``'s path, so that the tools still key the
serving forward's work by ``enc0``, not ``serve/enc0``.
"""

from __future__ import annotations

import itertools
import statistics
import threading
import time
from array import array
from typing import NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

CAPACITY = 1 << 18   # spans the recorder keeps

_local = threading.local()
_ids = itertools.count()   # span ids, in the order the spans open


def _state():
    if not hasattr(_local, "stack"):
        _local.stack = []        # the scopes entered, outermost first
        _local.recorders = []    # the active recorders, innermost last
        _local.uncounted = 0
    return _local


class Span(NamedTuple):
    """One recorded span: ``start`` and ``end`` in ``perf_counter_ns``;
    ``parent`` the id of the span around it on its thread (-1 for none),
    ``root`` that of the outermost one (its own id where it is that)."""
    id: int
    name: str
    start: int
    end: int
    parent: int
    root: int


class Ring:
    """The span recorder: ``capacity`` (a power of two) records in
    preallocated arrays, span ``i`` in slot ``i % capacity``."""

    def __init__(self, capacity: int = CAPACITY) -> None:
        if capacity < 1 or capacity & (capacity - 1):
            raise ValueError(f"capacity {capacity} is not a power of two")
        self.mask = capacity - 1
        self.ids = array("q", [-1]) * capacity
        self.name_ids = array("i", [0]) * capacity
        self.starts = array("q", [0]) * capacity
        self.ends = array("q", [0]) * capacity
        self.parents = array("q", [0]) * capacity
        self.roots = array("q", [0]) * capacity
        self.names: list = []
        self._name_id: dict = {}
        self.dropped = 0
        self.lost_start = -1     # the latest start of an overwritten span
        # taken for a new name and an overwrite alone: a span's own slot
        # is no other open span's
        self._lock = threading.Lock()

    def add(self, sid, name, start, end, parent, root) -> None:
        slot = sid & self.mask
        if self.ids[slot] >= 0:
            with self._lock:
                self.dropped += 1
                self.lost_start = max(self.lost_start, self.starts[slot])
        nid = self._name_id.get(name)
        if nid is None:
            with self._lock:
                nid = self._name_id.get(name)
                if nid is None:
                    self.names.append(name)
                    nid = self._name_id[name] = len(self.names) - 1
        self.ids[slot], self.name_ids[slot] = sid, nid
        self.starts[slot], self.ends[slot] = start, end
        self.parents[slot], self.roots[slot] = parent, root

    def spans(self, t0: int, t1: int) -> Optional[list]:
        """The spans that start at or after ``t0`` and end at or before
        ``t1``, in the order they started; None where a span that started
        at or after ``t0`` was overwritten."""
        if self.lost_start >= t0:
            return None
        names = self.names
        out = [Span(sid, names[nid], s, e, p, r)
               for sid, nid, s, e, p, r in zip(
                   self.ids, self.name_ids, self.starts, self.ends,
                   self.parents, self.roots)
               if sid >= 0 and s >= t0 and e <= t1]
        out.sort(key=lambda sp: sp.start)
        return out


RING = Ring()


class scope:
    """``with scope(name):`` names what runs inside (see the module
    docstring).  A class rather than a generator, so that module hooks can
    enter and leave it as two calls (``tools/trace_infer.py``)."""

    annotate = True   # a profiler range, and a part of current()'s path

    def __init__(self, name: str) -> None:
        self.name = name
        self._range = None

    def __enter__(self):
        stack = _state().stack
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else -1
        self.root = stack[0].id if stack else self.id
        stack.append(self)
        if self.annotate and _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        try:
            if self._range is not None:
                self._range.__exit__(*exc)
        finally:
            self._range = None
            _state().stack.pop()
            RING.add(self.id, self.name, self.start, end, self.parent,
                     self.root)
        return False


class span(scope):
    """``with span(name):`` a scope that the span recorder alone sees: no
    profiler range, and no part of ``current()``'s path."""

    annotate = False


def current() -> str:
    """The path of the scopes entered on this thread, outermost first,
    joined by "/" ("" outside every scope; a ``span`` is no part of it)."""
    return "/".join(s.name for s in _state().stack if s.annotate)


def spans(t0_ns: int, t1_ns: int) -> Optional[list]:
    """The recorded spans (``Span``) that start at or after ``t0_ns`` and
    end at or before ``t1_ns`` (``time.perf_counter_ns()`` times), in the
    order they started; None where the recorder has overwritten one that
    started at or after ``t0_ns``.  A span still open is not among them."""
    return RING.spans(t0_ns, t1_ns)


def dropped() -> int:
    """The spans the recorder has overwritten since the process began."""
    return RING.dropped


def trace_offset_ns(events, recorded) -> Optional[int]:
    """The constant that maps a recorder time onto the clock of a
    ``torch.profiler`` trace (``events``, its chrome JSON's
    ``traceEvents``; ``ts`` in µs): trace ns = recorder ns + the constant.

    It is read from the spans present in both: each scope's range
    (``user_annotation``) in the trace and its record among ``recorded``
    (``spans()``'s list, which may hold spans before and after the
    trace's).  The trace's ranges, in the order they start, are matched
    to a run of as many consecutive records with the same names; of the
    runs that match, the one whose start offsets spread least is taken,
    and the constant is their median.  None where no run matches."""
    names = {s.name for s in recorded}
    marks = sorted((float(e["ts"]), e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e.get("name") in names)
    if not marks:
        return None
    ranged = {name for _, name in marks}
    recorded = sorted((s for s in recorded if s.name in ranged),
                      key=lambda s: s.start)
    n = len(marks)
    best, best_spread = None, None
    for k in range(len(recorded) - n + 1):
        offsets, lo, hi = [], None, None
        for i, (ts, name) in enumerate(marks):
            s = recorded[k + i]
            if s.name != name:
                break
            d = ts * 1e3 - s.start
            lo = d if lo is None else min(lo, d)
            hi = d if hi is None else max(hi, d)
            if best_spread is not None and hi - lo >= best_spread:
                break
            offsets.append(d)
        else:
            best, best_spread = offsets, hi - lo
    return None if best is None else round(statistics.median(best))


def attach(recorder) -> None:
    """Send ``note_kernel``'s calls on this thread to ``recorder`` (an
    object with ``kernel(scope, name, nbytes, flops)``) until
    ``detach(recorder)``."""
    _state().recorders.append(recorder)


def detach(recorder) -> None:
    _state().recorders.remove(recorder)


class uncounted:
    """``with uncounted():`` runs a hand kernel's plain version: an active
    recorder does not count its aten operations (``note_kernel`` counts
    the call)."""

    def __enter__(self):
        _state().uncounted += 1
        return self

    def __exit__(self, *exc):
        _state().uncounted -= 1
        return False


def counting() -> bool:
    """False inside ``uncounted()``."""
    return _state().uncounted == 0


def tensor_bytes(t) -> int:
    """The bytes a kernel moves reading (or writing) ``t`` once: its
    elements counted once, a broadcast (stride-0) dimension once."""
    if t is None:
        return 0
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def note_kernel(name: str, inputs, outputs, flops: float = 0.0) -> None:
    """One call of the hand kernel ``name`` that reads ``inputs`` and
    writes ``outputs`` (tensors, None skipped), doing ``flops`` operations
    that count toward an operations bound (0 for the glue and the warp):
    recorded in every active recorder under the current scope."""
    state = _state()
    if not state.recorders:
        return
    nbytes = (sum(tensor_bytes(t) for t in inputs)
              + sum(tensor_bytes(t) for t in outputs))
    path = current()
    for recorder in state.recorders:
        recorder.kernel(path, name, nbytes, float(flops))
