"""Named scopes (the port's ``jax.named_scope``) and the budget hook of the
hand-written kernels.

``scope(name)`` names a stretch of the program: it enters
``torch.profiler.record_function(name)``, so the profiler's host trace
holds the range (a ``user_annotation``) and its device trace the span of
the kernels launched inside it (a ``gpu_user_annotation``), and it pushes
``name`` on this thread's scope stack, which a budget recorder
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
"""

from __future__ import annotations

import threading

import torch

_local = threading.local()


def _state():
    if not hasattr(_local, "stack"):
        _local.stack = []        # the scopes entered, outermost first
        _local.recorders = []    # the active recorders, innermost last
        _local.uncounted = 0
    return _local


class scope:
    """``with scope(name):`` names what runs inside (see the module
    docstring).  A class rather than a generator, so that module hooks can
    enter and leave it as two calls (``tools/trace_infer.py``)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._range = None

    def __enter__(self):
        _state().stack.append(self.name)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self._range.__exit__(*exc)
        finally:
            self._range = None
            _state().stack.pop()
        return False


def current() -> str:
    """The path of the scopes entered on this thread, outermost first,
    joined by "/" ("" outside every scope)."""
    return "/".join(_state().stack)


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
