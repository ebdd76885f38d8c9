"""How the port runs a hand-written kernel, whatever the kernel.

A kernel's wrapper (``ops/attend.py``, ``ops/conv.py``, ...) checks its
operands' shapes, plans the launch and marshals the kernel's arguments; the
rest is the same for every kernel and lives here:

- ``run``, the device rule: the operands share one device; a CPU call runs
  the plain version under ``uncounted()``, a CUDA call the kernel, any
  other device raises ``RuntimeError("<name> has no kernel for
  <device>")``; either way the call is filed once with ``note_kernel``.
- ``check``, the rule for CUDA operands: one type from ``DTYPE_CODES``,
  contiguous, and 16-byte aligned where the kernel reads 16-byte vectors.
- ``c_function``: a C function of the kernels' libraries, its source built
  and loaded on first use (``_build.py``), never at import.
- ``launch``: one C call under the device's guard on its current stream,
  raising on a CUDA error, counted in the public function's ``launches``.

The kernels, their sources and their C functions' signatures are declared
in ``ops/kernels.py``, which imports the wrappers; this module imports
none of them.
"""

from __future__ import annotations

import functools

import torch

from .. import _build
from ..utils.scopes import note_kernel, uncounted

# the types the kernels take, and the code their ``dtype`` argument gives
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
F32 = {torch.float32: 0}


def _one(out):
    return (out,)


def run(fn, operands, plain, kernel, outputs=_one, flops=0.0):
    """One call of the hand kernel whose public function is ``fn`` on
    ``operands`` (its tensors, None skipped), which must share one device:
    ``plain()`` on the CPU, ``kernel()`` on CUDA.  The result is returned;
    ``outputs(result)`` are the tensors ``note_kernel`` counts as written,
    ``flops`` the operations it counts."""
    name = fn.__name__
    devices = {t.device for t in operands if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{name} operands must share one device, not "
                         f"{sorted(map(str, devices))}")
    device, = devices
    if device.type == "cpu":
        with uncounted():
            out = plain()
    elif device.type == "cuda":
        out = kernel()
    else:
        raise RuntimeError(f"{name} has no kernel for {device}")
    note_kernel(name, operands, outputs(out), flops)
    return out


def check(name, operands, aligned=False, dtypes=DTYPE_CODES) -> int:
    """The rule for the CUDA ``operands`` of the kernel ``name`` ({operand
    name: tensor or None}): one type among ``dtypes``, contiguous, and
    16-byte aligned where ``aligned``.  Returns the type's code."""
    first = dt = None
    for key, t in operands.items():
        if t is None:
            continue
        if dt is None:
            first, dt = key, t.dtype
            if dt not in dtypes:
                kinds = " or ".join(str(d).removeprefix("torch.")
                                    for d in dtypes)
                raise TypeError(f"{name} kernel takes {kinds}, not {dt}")
        elif t.dtype != dt:
            raise TypeError(f"{name} operands differ in type: {key} is "
                            f"{t.dtype}, {first} {dt}")
        if not t.is_contiguous() or (aligned and t.data_ptr() % 16):
            raise ValueError(f"{name} takes contiguous"
                             f"{', 16-byte aligned' if aligned else ''} "
                             f"tensors; {key} is not")
    return dtypes[dt]


@functools.lru_cache(maxsize=None)
def c_function(name: str):
    """The C function ``name`` with its argument and result types, from the
    library of the source that ``ops/kernels.py`` declares it in."""
    from .kernels import signature   # the list imports the wrappers

    source, argtypes, restype = signature(name)
    fn = getattr(_build.load(source), name)
    fn.argtypes, fn.restype = argtypes, restype
    return fn


def launch(fn, name: str, device: torch.device, *args) -> None:
    """Launch the C function ``name`` with ``args`` and the current stream
    of ``device``, under its guard; a CUDA error raises.  The launch is
    counted in ``fn.launches`` (``fn``: the kernel's public function)."""
    with torch.cuda.device(device):
        err = c_function(name)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: CUDA "
                           f"error {err}")
    fn.launches += 1
