"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch and a CUDA card:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest``: the suite's conftest sets JAX up.)  Without a card every
test skips.
"""

import numpy as np
import pytest
import torch

from uncertainty_model_tpu_torch.ops import decoder_fused as tdf

# (H/2, W/2, Cso, Cu, Cd, cf): small shapes, odd widths, and the ragged
# cases the kernel's index arithmetic meets (Cso not a power of two, h2 = 1)
SHAPES = {
    "disp": (8, 16, 16, 8, 4, 0),
    "no_disp": (8, 16, 16, 8, 0, 0),
    "fold": (8, 16, 32, 8, 4, 3),
    "fold_no_disp": (4, 7, 32, 4, 0, 3),
    "cso48": (5, 9, 48, 4, 4, 0),
    "one_row": (1, 3, 16, 4, 4, 3),
}


def _inputs(seed, b, h2, w2, cso, cu, cd, cf, device, dtype):
    rng = np.random.default_rng(seed)

    def t(*shape, dt=dtype):
        a = rng.normal(size=shape).astype(np.float32)
        return torch.from_numpy(a).to(device=device, dtype=dt)

    se = t(b, 2 * h2, 2 * w2, cf or cso)
    skip, xc = t(b, h2, w2, cso), t(b, h2, w2, 4 * cu)
    disp = t(b, h2, w2, cd) if cd else None
    bias = t(cso, dt=torch.float32)
    k_fm = t(cf, cso, dt=torch.float32) if cf else None
    return se, skip, xc, disp, bias, k_fm


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(SHAPES))
def test_assemble_z_kernel_matches_plain(case, dtype):
    """f32: rtol 1e-5, atol 1e-5 (expm1 and the fold's summation order may
    differ by an ulp); bf16: within one bf16 ulp of the output (rtol 2^-7,
    atol 1e-2); mean: rtol 1e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    args = _inputs(17, 3, *SHAPES[case], device="cuda", dtype=dt)
    before = tdf.assemble_z.launches
    cat, mean = tdf.assemble_z(*args)
    torch.cuda.synchronize()
    assert tdf.assemble_z.launches == before + 1
    ref_cat, ref_mean = tdf.assemble_z_plain(*args)
    tol = dict(rtol=1e-5, atol=1e-5) if dt == torch.float32 else \
        dict(rtol=2 ** -7, atol=1e-2)
    torch.testing.assert_close(cat.float(), ref_cat.float(), **tol)
    torch.testing.assert_close(mean, ref_mean, rtol=1e-3, atol=1e-5)


@pytest.mark.gpu
def test_assemble_z_kernel_is_deterministic():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    args = _inputs(18, 2, 16, 32, 64, 16, 4, 0, "cuda", torch.bfloat16)
    a = tdf.assemble_z(*args)
    b = tdf.assemble_z(*args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_assemble_z_kernel_rejects_non_contiguous():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    se, skip, xc, disp, bias, _ = _inputs(19, 2, 4, 8, 16, 4, 4, 0, "cuda",
                                          torch.float32)
    se_t = se.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tdf.assemble_z(se_t, skip, xc, disp, bias)
