"""The port's list of hand kernels (``ops/kernels.py``) and the protocol
they run by (``ops/hand.py``), on the CPU, for every declared kernel:

- a CPU call launches no kernel, and a budget recorder files exactly one
  call of it under the scope around it and no bytes under any aten
  operator (its plain version runs uncounted; views count zero);
- ``meta`` operands raise ``RuntimeError`` naming the kernel: the device
  rule has the CPU's plain version and the CUDA kernel, nothing else;
- its ``csrc`` source defines each declared C function as ``extern "C"``
  with as many parameters as the declaration gives it types (read from
  the text, not built), and every ``csrc/*.cu`` belongs to a declaration.
"""

import os
import re

import pytest
import torch

from uncertainty_model_tpu_torch import _build
from uncertainty_model_tpu_torch.ops import kernels
from uncertainty_model_tpu_torch.tools import perf_budget
from uncertainty_model_tpu_torch.utils import scopes


def _example(name, device="cpu"):
    """Small operands of the kernel ``name``, on ``device``."""
    gen = torch.Generator().manual_seed(sum(map(ord, name)))

    def t(*shape):
        return torch.rand(*shape, generator=gen).to(device)

    se_fm, skip_h = t(2, 8, 16, 6), t(2, 4, 8, 6)
    xc, disp_h = t(2, 4, 8, 12), t(2, 4, 8, 2)
    coords = (torch.rand(4, 8, generator=gen) * 10 - 1).to(device)
    return {
        "assemble_z": (se_fm, skip_h, xc, disp_h, t(6)),
        "se_squeeze": (se_fm, skip_h, t(6)),
        "assemble": (se_fm, skip_h, t(2, 6), xc, disp_h, t(6)),
        "gate_z": (t(2, 8, 16, 20), t(2, 6), 6),
        "conv_elu": (t(1, 6, 8, 4), t(3, 3, 4, 5), t(5)),
        "gated_conv_elu": ([t(1, 8, 10, 4), t(1, 8, 10, 4)], t(2),
                           t(3, 3, 4, 5), t(5)),
        "upsample2x2": (t(1, 3, 4, 5),),
        "reflect_pad": (t(2, 3, 4, 5), t(2, 5)),
        "attend": (t(2, 10, 16), t(2, 10, 16), t(2, 10, 16), 4, "window"),
        "warp_rows_fwd": (coords, t(4, 8, 3)),
        "warp_rows_bwd": (coords, t(4, 8, 3), t(4, 8, 3)),
    }[name]


NAMES = [k.name for k in kernels.KERNELS]
BY_NAME = {k.name: k for k in kernels.KERNELS}


def test_names_are_the_public_functions():
    assert len(set(NAMES)) == len(NAMES) == 11
    assert set(kernels.launch_counts()) == set(NAMES)
    for k in kernels.KERNELS:
        assert k.fn.launches >= 0


@pytest.mark.parametrize("name", NAMES)
def test_cpu_call_is_filed_once_and_launches_nothing(name):
    args = _example(name)
    before = kernels.launch_counts()
    with perf_budget.Recorder() as rec, scopes.scope("s"):
        BY_NAME[name].fn(*args)
    assert kernels.launch_counts() == before
    rows = {key: tuple(row) for key, row in rec.rows.items()}
    assert rows[("s", name)][0] == 1 and rows[("s", name)][1] > 0
    assert rec.kernels == {name}
    assert all(nbytes == 0 for (_, op), (_, nbytes, _) in rows.items()
               if op != name)


@pytest.mark.parametrize("name", NAMES)
def test_meta_operands_raise_naming_the_kernel(name):
    before = kernels.launch_counts()
    with pytest.raises(RuntimeError, match=f"^{name} has no kernel for meta"):
        BY_NAME[name].fn(*_example(name, "meta"))
    assert kernels.launch_counts() == before


def _extern_c(source):
    """{C function: its parameter count} of ``csrc/<source>.cu``."""
    with open(os.path.join(_build.CSRC, f"{source}.cu")) as f:
        text = f.read()
    return {m.group(1): len(m.group(2).split(","))
            for m in re.finditer(r'extern\s+"C"\s+[\w\s]+?\b(umt_\w+)\s*'
                                 r'\(([^)]*)\)', text)}


@pytest.mark.parametrize("name", NAMES)
def test_source_defines_the_declared_c_functions(name):
    k = BY_NAME[name]
    defined = _extern_c(k.source)
    for c_function, (argtypes, _) in k.functions.items():
        assert defined.get(c_function) == len(argtypes), c_function
        assert kernels.signature(c_function)[0] == k.source


def test_every_cuda_source_is_declared():
    on_disk = {f[:-3] for f in os.listdir(_build.CSRC) if f.endswith(".cu")}
    assert on_disk == set(kernels.sources())
    declared = {c for k in kernels.KERNELS for c in k.functions}
    assert declared == {c for s in on_disk for c in _extern_c(s)}


@pytest.mark.parametrize("device_function, name", [
    ("void decoder_rows<__nv_bfloat16, 0, 8>(RowArgs)", "assemble_z"),
    ("void decoder_rows<float, 1, 1>(RowArgs)", "se_squeeze"),
    ("void decoder_rows<__nv_bfloat16, 2, 8>(RowArgs)", "assemble"),
    ("void gate_z_flat<float>(float*, float const*, int, int)", "gate_z"),
    ("void gated_conv_wgmma<false, 64, 64>(TcArgs)", "conv_elu"),
    ("void gated_conv_f32<false>(Args<float>)", "conv_elu"),
    ("void gated_conv_wgmma<true, 64, 64>(TcArgs)", "gated_conv_elu"),
    ("void attend_combine(float const*)", "attend"),
    ("sm90_xmma_fprop_implicit_gemm", None),
])
def test_device_functions_map_to_their_kernel(device_function, name):
    assert kernels.hand_kernel(device_function) == name
