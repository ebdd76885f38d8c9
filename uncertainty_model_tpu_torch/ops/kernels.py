"""The port's hand-written kernels, one declaration each.

A declaration names the kernel's public function (whose ``launches``
counts its launches), the ``csrc/<source>.cu`` that holds it, the
argument and result types of its C functions (``ops/hand.py`` loads them
with these), and what its device functions' names in a profiler trace
match (``hand_kernel``).  The tests, the trace tools and ``chip_smoke.py``
take the list of kernels from here.  Nothing is built or loaded at import.

Adding a kernel takes three things: its CUDA source ``csrc/<source>.cu``
with a plain C interface; its wrapper in an ``ops`` module, holding its
shape checks, its plan and its arguments and running through
``hand.run``, ``hand.check`` and ``hand.launch``, with a plain PyTorch
version beside it and a ``launches`` counter; and one declaration here.
"""

from __future__ import annotations

import ctypes
import re
from typing import Callable, NamedTuple

from .attend import attend
from .conv import conv_elu, gated_conv_elu
from .decoder_fused import assemble, assemble_z, gate_z, se_squeeze
from .pad import reflect_pad
from .upsample import upsample2x2
from .warp_rows import warp_rows_bwd, warp_rows_fwd

_I, _P = ctypes.c_int, ctypes.c_void_p


def _launch(*args):
    """A launching C function's types: ``args`` and the stream; it returns
    a CUDA error code."""
    return [*args, _P], _I


class Kernel(NamedTuple):
    """A hand kernel: ``fn`` its public function, ``source`` its
    ``csrc/<source>.cu``, ``functions`` its C functions' ``(argument
    types, result type)`` by name, ``device`` the pattern of its device
    functions' names."""
    fn: Callable
    source: str
    functions: dict
    device: re.Pattern

    @property
    def name(self) -> str:
        return self.fn.__name__


# in the order a trace's device function is matched, first match wins: the
# decoder glue's row kernel runs assemble_z, se_squeeze and assemble in
# modes 0, 1 and 2 (decoder_rows.cuh); conv_elu is gated_conv_elu's
# ungated mode
KERNELS = (
    Kernel(assemble_z, "assemble_z",
           {"umt_assemble_z": _launch(_I, *[_P] * 11, *[_I] * 12)},
           re.compile(r"decoder_rows<[^,<>]*,\s*0\s*,")),
    Kernel(se_squeeze, "decoder_fused",
           {"umt_se_squeeze": _launch(_I, *[_P] * 8, *[_I] * 10)},
           re.compile(r"decoder_rows<[^,<>]*,\s*1\s*,")),
    Kernel(assemble, "decoder_fused",
           {"umt_assemble": _launch(_I, *[_P] * 9, *[_I] * 12)},
           re.compile(r"decoder_rows<[^,<>]*,\s*2\s*,")),
    Kernel(gate_z, "decoder_fused",
           {"umt_gate_z": _launch(_I, _P, _P, *[_I] * 4)},
           re.compile(r"gate_z_flat")),
    Kernel(conv_elu, "gated_conv_elu",
           {"umt_conv_elu": _launch(_I, *[_P] * 4, *[_I] * 6, _P)},
           re.compile(r"gated_conv_(wgmma|f32)<\s*false")),
    Kernel(gated_conv_elu, "gated_conv_elu",
           {"umt_gated_conv_elu": _launch(_I, *[_P] * 5, *[_I] * 8, _P)},
           re.compile(r"gated_conv_(wgmma|f32)")),
    Kernel(upsample2x2, "upsample2x2",
           {"umt_upsample2x2": _launch(_I, *[_P] * 6, *[_I] * 4)},
           re.compile(r"upsample2x2_kernel")),
    Kernel(reflect_pad, "reflect_pad",
           {"umt_reflect_pad": _launch(_I, *[_P] * 3, *[_I] * 5)},
           re.compile(r"reflect_pad_kernel")),
    Kernel(attend, "attend",
           {"umt_attend_work": ([_I] * 6, ctypes.c_longlong),
            "umt_attend": _launch(*[_I] * 3, *[_P] * 5, *[_I] * 7)},
           re.compile(r"attend_(context|combine|apply)")),
    Kernel(warp_rows_fwd, "warp_rows",
           {"umt_warp_rows_fwd": _launch(_I, _P, _I)},
           re.compile(r"warp_rows_fwd")),
    Kernel(warp_rows_bwd, "warp_rows",
           {"umt_warp_rows_bwd": _launch(_I, _P, _I)},
           re.compile(r"warp_rows_bwd")),
)

# (name, device function pattern) in matching order
HAND_KERNELS = tuple((k.name, k.device) for k in KERNELS)


def hand_kernel(device_function: str):
    """The hand kernel whose device function ``device_function`` is, or
    None."""
    for name, pattern in HAND_KERNELS:
        if pattern.search(device_function):
            return name
    return None


def signature(c_function: str):
    """``(source, argument types, result type)`` of a declared C
    function."""
    for k in KERNELS:
        if c_function in k.functions:
            return (k.source, *k.functions[c_function])
    raise KeyError(f"no hand kernel declares the C function {c_function}")


def sources() -> list:
    """The ``csrc`` sources of the hand kernels, each once."""
    return list(dict.fromkeys(k.source for k in KERNELS))


def launch_counts() -> dict:
    """Each hand kernel's launches so far, by name."""
    return {k.name: k.fn.launches for k in KERNELS}


def reset_launches() -> None:
    """Set every hand kernel's launch counter to 0."""
    for k in KERNELS:
        k.fn.launches = 0
