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
from uncertainty_model_tpu_torch.ops import warp_rows as twr

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


# (R, W, C, x): widths of the flagship's pyramid ends and a 1-pixel row,
# the channel counts on the path (4: image + disparity, 1: the uncertainty
# term) and a ragged one, and x inside, outside or on integers
WARP_CASES = {
    "w64_c4": (16, 64, 4, "mixed"),
    "w512_c4": (8, 512, 4, "mixed"),
    "w512_c1": (8, 512, 1, "mixed"),
    "w64_c3": (5, 64, 3, "mixed"),
    "w1_c4": (6, 1, 4, "mixed"),
    "out_of_range": (4, 64, 4, "outside"),
    "integer": (4, 64, 1, "integer"),
    "one_row": (1, 64, 3, "mixed"),
}


def _warp_inputs(seed, r, w, c, kind):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.3 * w - 1, 1.3 * w + 1, size=(r, w))
    if kind == "outside":  # both taps outside [0, W)
        x = np.where(rng.uniform(size=(r, w)) < 0.5,
                     rng.uniform(-2 * w - 2, -1.01, size=(r, w)),
                     rng.uniform(w, 2 * w + 2, size=(r, w)))
    elif kind == "integer":
        x = np.round(x)
    else:
        integer = rng.uniform(size=(r, w)) < 1 / 3
        x[integer] = np.round(x[integer])

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to("cuda")

    return (t(x), t(rng.normal(size=(r, w, c))),
            t(rng.normal(size=(r, w, c))))


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(WARP_CASES))
def test_warp_rows_kernels_match_plain(case):
    """Forward and dx: rtol 1e-5, atol 1e-5 (separately rounded products,
    as the plain version).  dsrc: its shared-memory atomics sum a tap's
    terms in any order, so it is held within 1e-5 * (1 + the sum of the
    terms' magnitudes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, src, dout = _warp_inputs(23, *WARP_CASES[case])
    before = (twr.warp_rows_fwd.launches, twr.warp_rows_bwd.launches)
    xg = x.clone().requires_grad_()
    sg = src.clone().requires_grad_()
    out = twr.warp_rows(xg, sg)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (twr.warp_rows_fwd.launches, twr.warp_rows_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(out.detach(), twr.warp_rows_plain(x, src),
                               rtol=1e-5, atol=1e-5)
    dx, dsrc = twr.warp_rows_bwd_plain(x, src, dout)
    _, dsrc_abs = twr.warp_rows_bwd_plain(x, src, dout.abs())
    torch.testing.assert_close(xg.grad, dx, rtol=1e-5, atol=1e-5)
    assert bool(((sg.grad - dsrc).abs() <= 1e-5 * (1 + dsrc_abs)).all())
    if case == "outside":
        assert not out.any() and not sg.grad.any() and not xg.grad.any()


@pytest.mark.gpu
def test_warp_rows_forward_is_deterministic_and_rejects_bad_operands():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, src, dout = _warp_inputs(24, 8, 64, 4, "mixed")
    assert torch.equal(twr.warp_rows_fwd(x, src), twr.warp_rows_fwd(x, src))
    dx1, _ = twr.warp_rows_bwd(x, src, dout)
    dx2, _ = twr.warp_rows_bwd(x, src, dout)
    assert torch.equal(dx1, dx2)
    with pytest.raises(ValueError, match="contiguous"):
        twr.warp_rows_fwd(x, src.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(TypeError):
        twr.warp_rows_fwd(x, src.double())
