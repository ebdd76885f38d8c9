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
# cases the kernel's index arithmetic meets (Cso not a power of two, h2 = 1,
# w2 = 1); odd Cso and Ccat at small W (rows not 16-byte aligned, one
# channel a thread); rows too wide for one block (column tiles, in bf16
# and f32)
SHAPES = {
    "disp": (8, 16, 16, 8, 4, 0),
    "no_disp": (8, 16, 16, 8, 0, 0),
    "fold": (8, 16, 32, 8, 4, 3),
    "fold_no_disp": (4, 7, 32, 4, 0, 3),
    "cso48": (5, 9, 48, 4, 4, 0),
    "one_row": (1, 3, 16, 4, 4, 3),
    "one_column": (4, 1, 8, 4, 4, 0),
    "odd_ccat": (3, 5, 5, 3, 1, 0),
    "odd_fold": (2, 3, 7, 1, 3, 3),
    "wide_tiles": (4, 400, 32, 8, 4, 3),
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
    """f32: rtol 1e-5, atol 1e-5 (expm1 and the card's f32 paths may
    differ by an ulp); bf16: bit for bit (each operation rounded on its
    own, as the plain version does it); mean: rtol 1e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    args = _inputs(17, 3, *SHAPES[case], device="cuda", dtype=dt)
    before = tdf.assemble_z.launches
    cat, mean = tdf.assemble_z(*args)
    torch.cuda.synchronize()
    assert tdf.assemble_z.launches == before + 1
    ref_cat, ref_mean = tdf.assemble_z_plain(*args)
    if dt == torch.bfloat16:
        assert torch.equal(cat, ref_cat)
    else:
        torch.testing.assert_close(cat, ref_cat, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(mean, ref_mean, rtol=1e-3, atol=1e-5)


@pytest.mark.gpu
def test_assemble_z_kernel_is_deterministic():
    """The SE mean is summed in a fixed order whichever block finishes
    last: assemble_z and se_squeeze give the same bits call after call,
    with one column tile and with several (f32 at 800 columns)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for dtype, shape in ((torch.bfloat16, (16, 32, 64, 16, 4, 0)),
                         (torch.float32, (4, 400, 32, 8, 4, 3))):
        args = _inputs(18, 2, *shape, "cuda", dtype)
        se, skip, _, _, bias, k_fm = args
        a = tdf.assemble_z(*args)
        for _ in range(3):
            b = tdf.assemble_z(*args)
            for x, y in zip(a, b):
                assert torch.equal(x, y)
            assert torch.equal(tdf.se_squeeze(se, skip, bias, k_fm), a[1])


def _offset(t, k):
    """A contiguous copy of ``t`` that starts ``k`` elements past the start
    of its allocation (so off 16 bytes for k not a multiple of the vector)."""
    buf = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
    out = buf[k:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["disp", "fold", "odd_ccat"])
def test_glue_kernels_unaligned_operands(case, dtype):
    """Operands that do not start on 16 bytes take the narrow copies (one
    channel a thread, thread copies of the skip rows, gate_z's ragged head
    and tail); the tensors equal the aligned call's bit for bit, the SE
    means within rtol 1e-3 (one channel a thread sums in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    args = _inputs(22, 2, *SHAPES[case], device="cuda", dtype=dt)
    se, skip, xc, disp, bias, k_fm = args
    cso = skip.shape[-1]
    gates = torch.rand(2, cso, device="cuda").to(dt)
    moved = [None if t is None else _offset(t, 1) for t in (se, skip, xc, disp)]
    m_se, m_skip, m_xc, m_disp = moved
    cat, mean = tdf.assemble_z(se, skip, xc, disp, bias, k_fm)
    m_cat, m_mean = tdf.assemble_z(*moved, bias, k_fm)
    assert torch.equal(m_cat, cat)
    torch.testing.assert_close(m_mean, mean, rtol=1e-3, atol=1e-5)
    assert torch.equal(tdf.se_squeeze(m_se, m_skip, bias, k_fm), m_mean)
    assert torch.equal(
        tdf.assemble(m_se, m_skip, gates, m_xc, m_disp, bias, k_fm),
        tdf.assemble(se, skip, gates, xc, disp, bias, k_fm))
    cat, _ = tdf.assemble_z(*args)
    for k in range(1, 8):
        shifted = _offset(cat, k)
        assert torch.equal(tdf.gate_z(shifted, gates, cso),
                           tdf.gate_z_plain(cat.clone(), gates, cso))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(SHAPES))
def test_gate_z_kernel_leaves_other_channels_unwritten(case, dtype):
    """Channels >= Cso hold a sentinel (NaN and a finite value) before and
    the same bits after: gate_z never stores there, not even the value it
    read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    h2, w2, cso, cu, cd, _ = SHAPES[case]
    cat = torch.randn(2, 2 * h2, 2 * w2, cso + cu + cd, device="cuda").to(dt)
    cat[..., cso::2] = float("nan")
    cat[..., cso + 1::2] = -7.5
    rest = cat[..., cso:].clone()
    gates = torch.rand(2, cso, device="cuda").to(dt)
    want = cat[..., :cso] * gates[:, None, None, :]
    tdf.gate_z(cat, gates, cso)
    assert torch.equal(cat[..., :cso], want)
    assert torch.equal(cat[..., cso:].view(torch.int16 if dt == torch.bfloat16
                                           else torch.int32),
                       rest.view(torch.int16 if dt == torch.bfloat16
                                 else torch.int32))


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


# groups of (R, W) problems that share C: the 8 problems of a training
# step's reconstruction warps at batch 2 (4 scales x 2 views, C 4) and the
# uncertainty term's pair at the full scale (C 1); a W = 1 and a one-row
# problem; a group with an empty problem; 9 problems (two launches)
WARP_GROUPS = {
    "step_b2": ([(2 * (256 >> i), 512 >> i) for i in range(4)
                 for _ in range(2)], 4),
    "step_c1": ([(512, 512)] * 2, 1),
    "w1_one_row": ([(6, 1), (1, 64), (16, 64)], 4),
    "w1_one_row_c3": ([(6, 1), (1, 512), (5, 64)], 3),
    "empty": ([(4, 64), (0, 64), (3, 32)], 4),
    "nine": ([(2, 16 * (i + 1)) for i in range(9)], 1),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(WARP_GROUPS))
def test_warp_rows_grouped_kernels_match_plain(case):
    """``warp_rows_many``: one launch each way for up to 8 problems, and
    each problem's out, dx and dsrc within the tolerances of
    ``test_warp_rows_kernels_match_plain``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    problems, c = WARP_GROUPS[case]
    inputs = [_warp_inputs(30 + i, r, w, c, "mixed")
              for i, (r, w) in enumerate(problems)]
    before = (twr.warp_rows_fwd.launches, twr.warp_rows_bwd.launches)
    xg = [x.clone().requires_grad_() for x, _, _ in inputs]
    sg = [s.clone().requires_grad_() for _, s, _ in inputs]
    outs = twr.warp_rows_many(xg, sg)
    torch.autograd.backward(outs, [d for *_, d in inputs])
    torch.cuda.synchronize()
    launches = -(-sum(1 for r, w in problems if r * w) // 8)
    assert (twr.warp_rows_fwd.launches, twr.warp_rows_bwd.launches) == (
        before[0] + launches, before[1] + launches)
    for (x, src, dout), out, xi, si in zip(inputs, outs, xg, sg):
        torch.testing.assert_close(out.detach(), twr.warp_rows_plain(x, src),
                                   rtol=1e-5, atol=1e-5)
        dx, dsrc = twr.warp_rows_bwd_plain(x, src, dout)
        _, dsrc_abs = twr.warp_rows_bwd_plain(x, src, dout.abs())
        torch.testing.assert_close(xi.grad, dx, rtol=1e-5, atol=1e-5)
        assert bool(((si.grad - dsrc).abs() <= 1e-5 * (1 + dsrc_abs)).all())


@pytest.mark.gpu
def test_warp_rows_grouped_rejects_mixed_operands():
    """Operands on two devices, of another dtype or of two C raise, and
    nothing is launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, src, _ = _warp_inputs(25, 8, 64, 4, "mixed")
    before = (twr.warp_rows_fwd.launches, twr.warp_rows_bwd.launches)
    with pytest.raises(ValueError, match="device"):
        twr.warp_rows_fwd_many([x, x.cpu()], [src, src.cpu()])
    with pytest.raises(TypeError):
        twr.warp_rows_fwd_many([x, x], [src, src.double()])
    with pytest.raises(ValueError, match="one C"):
        twr.warp_rows_fwd_many([x, x], [src, src[..., :3].contiguous()])
    with pytest.raises(ValueError, match="device"):
        twr.warp_rows_bwd_many([x, x], [src, src], [src, src.cpu()])
    assert (twr.warp_rows_fwd.launches, twr.warp_rows_bwd.launches) == before


# ---------------------------------------------------------------------------
# gate_z, se_squeeze, assemble


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(SHAPES))
def test_decoder_glue_kernels_match_plain(case, dtype):
    """se_squeeze: its plain version within rtol 1e-3, and assemble_z's
    mean bit for bit (the same row kernel and tiles); assemble: its plain
    version as assemble_z (bf16 bit for bit), and gate_z(assemble_z) bit
    for bit;
    gate_z: its plain version bit for bit (one rounded product), channels
    >= Cso untouched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    se, skip, xc, disp, bias, k_fm = _inputs(20, 3, *SHAPES[case],
                                             device="cuda", dtype=dt)
    cso = skip.shape[-1]
    gates = torch.rand(3, cso, device="cuda").to(dt)
    before = (tdf.gate_z.launches, tdf.se_squeeze.launches,
              tdf.assemble.launches)
    mean = tdf.se_squeeze(se, skip, bias, k_fm)
    cat = tdf.assemble(se, skip, gates, xc, disp, bias, k_fm)
    cat_z, mean_z = tdf.assemble_z(se, skip, xc, disp, bias, k_fm)
    untouched = cat_z[..., cso:].clone()
    gated = tdf.gate_z(cat_z, gates, cso)
    torch.cuda.synchronize()
    assert gated.data_ptr() == cat_z.data_ptr()
    assert (tdf.gate_z.launches, tdf.se_squeeze.launches,
            tdf.assemble.launches) == tuple(n + 1 for n in before)
    torch.testing.assert_close(mean, tdf.se_squeeze_plain(se, skip, bias, k_fm),
                               rtol=1e-3, atol=1e-5)
    assert torch.equal(mean, mean_z)
    want = tdf.assemble_plain(se, skip, gates, xc, disp, bias, k_fm)
    if dt == torch.bfloat16:
        assert torch.equal(cat, want)
    else:
        torch.testing.assert_close(cat, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(cat, gated)
    assert torch.equal(gated[..., cso:], untouched)
    ref = tdf.gate_z_plain(cat_z.clone(), gates, cso)
    assert torch.equal(tdf.gate_z(cat_z.clone(), gates, cso), ref)


@pytest.mark.gpu
def test_gate_z_kernel_rejects_bad_operands():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    cat = torch.zeros(2, 4, 6, 20, device="cuda")
    with pytest.raises(ValueError):
        tdf.gate_z(cat, torch.ones(2, 8, device="cuda"), 16)
    with pytest.raises(ValueError, match="contiguous"):
        tdf.gate_z(cat.transpose(1, 2), torch.ones(2, 16, device="cuda"), 16)


# ---------------------------------------------------------------------------
# gated_conv_elu

# (n, H, W, extra W pad, C, Co, k): the tiny config's s2d stages, a ragged
# width beyond one tile, Co not a multiple of 32, two output channel tiles
# and four input channel chunks (C = Co = 256); the planner's edges: H not
# a multiple of the tile's rows, W below the narrowest tile, narrow N (Co
# 16, 32, 48, 64), small chunks (C 16, 32, 48), a Co tile padded past Co
# (144); and the flagship's s2d stages cut to 3 rows, n = 1..4 each
CONV_CASES = {
    "tiny_s0_n4": (4, 8, 16, 0, 32, 32, 5),
    "tiny_s1_n1": (1, 4, 8, 0, 32, 32, 3),
    "ragged_n2": (2, 3, 70, 6, 32, 48, 3),
    "stage0_n3": (3, 2, 20, 4, 128, 128, 5),
    "stage1_n4": (4, 2, 64, 0, 256, 256, 3),
    "rows_ragged": (2, 21, 19, 2, 64, 64, 3),
    "narrow_w": (3, 5, 5, 0, 16, 16, 5),
    "c16_co32": (1, 6, 40, 0, 16, 32, 7),
    "c48_co48": (2, 4, 33, 3, 48, 48, 3),
    "c64_co144": (1, 3, 20, 0, 64, 144, 3),
    **{f"s2d0_n{n}": (n, 3, 128, 0, 128, 128, 5) for n in (1, 2, 3, 4)},
    **{f"s2d1_n{n}": (n, 3, 64, 0, 256, 256, 3) for n in (1, 2, 3, 4)},
}


def _conv_inputs(seed, b, n, h, w, extra, c, co, k, dtype):
    rng = np.random.default_rng(seed)
    p = (k - 1) // 2

    def t(*shape, scale=1.0, dt=dtype):
        a = (scale * rng.normal(size=shape)).astype(np.float32)
        return torch.from_numpy(a).to(device="cuda", dtype=dt)

    xs = [torch.nn.functional.pad(t(b, h, w, c), (0, 0, p, p + extra, p, p))
          for _ in range(n)]
    gates = torch.sigmoid(t(n, dt=torch.float32))
    w_ = t(k, k, c, co, scale=(k * k * c) ** -0.5)
    return xs, gates, w_, t(co, dt=torch.float32), w


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_gated_conv_elu_kernel_matches_plain(case, dtype):
    """bf16: one output ulp (rtol 2^-7, atol 1e-2): the matrix operands
    equal the plain version's and only the f32 summation order differs.
    f32: 1e-5 * (1 + the sum of the conv terms' magnitudes), for sums of
    up to k*k*C terms taken in another order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from uncertainty_model_tpu_torch.ops import conv as tconv

    torch.backends.cudnn.allow_tf32 = False
    dt = getattr(torch, dtype)
    n, h, w, extra, c, co, k = CONV_CASES[case]
    xs, gates, w_, b, width = _conv_inputs(25, 2, n, h, w, extra, c, co, k, dt)
    before = tconv.gated_conv_elu.launches
    got = tconv.gated_conv_elu(xs, gates, w_, b, width=width)
    torch.cuda.synchronize()
    assert tconv.gated_conv_elu.launches == before + 1
    want = tconv.gated_conv_elu_plain(xs, gates, w_, b, width=width)
    assert got.shape == want.shape == (2, h, w, co)
    if dt == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=1e-2)
    else:
        terms = tconv.conv_magnitude(xs, gates, w_, width=width)
        assert bool(((got - want).abs() <= 1e-5 * (1 + terms)).all())


@pytest.mark.gpu
def test_gated_conv_elu_kernel_refuses_untiled_channels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from uncertainty_model_tpu_torch.ops import conv as tconv

    xs, gates, w_, b, width = _conv_inputs(26, 1, 2, 4, 8, 0, 8, 16, 3,
                                           torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 16"):
        tconv.gated_conv_elu(xs, gates, w_, b)


# ---------------------------------------------------------------------------
# conv_elu (the ungated mode of the gated_conv_elu kernel)

# (B, H, W, C, Co, k): the flagship's native encoder interiors cut to a few
# rows (7x7 C=32, 5x5 C=64, 3x3 C=128, C=256 and C=512: enc4 at its full
# 8x16), a ragged width beyond one tile with Co not a multiple of 32, a
# 1-row, 1-column input (all pad), H and W off the tile, C 16 and 48
# (16-channel chunks), Co 48 and a Co tile padded past Co (144)
CONV_ELU_CASES = {
    "enc0_7x7": (2, 5, 70, 32, 32, 7),
    "enc1_5x5": (2, 4, 40, 64, 64, 5),
    "enc2_3x3": (2, 4, 64, 128, 128, 3),
    "enc3_3x3": (1, 3, 32, 256, 256, 3),
    "enc4_3x3": (2, 8, 16, 512, 512, 3),
    "ragged": (2, 3, 67, 16, 48, 3),
    "one_pixel": (2, 1, 1, 32, 16, 5),
    "rows_ragged": (1, 19, 21, 64, 64, 3),
    "c48_co32": (1, 4, 24, 48, 32, 3),
    "c32_co48": (1, 6, 40, 32, 48, 5),
    "c64_co144": (1, 3, 20, 64, 144, 3),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CONV_ELU_CASES))
def test_conv_elu_kernel_matches_plain(case, dtype):
    """The SAME zero-pad conv from the unpadded input: bf16 within one
    output ulp (rtol 2^-7, atol 1e-2); f32 within 1e-5 * (1 + the sum of
    the conv terms' magnitudes), the sums taken in another order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from uncertainty_model_tpu_torch.ops import conv as tconv

    torch.backends.cudnn.allow_tf32 = False
    dt = getattr(torch, dtype)
    b, h, w, c, co, k = CONV_ELU_CASES[case]
    rng = np.random.default_rng(27)

    def t(*shape, scale=1.0, dt=dt):
        a = (scale * rng.normal(size=shape)).astype(np.float32)
        return torch.from_numpy(a).to(device="cuda", dtype=dt)

    x, wt, bias = t(b, h, w, c), t(k, k, c, co, scale=(k * k * c) ** -0.5), \
        t(co, dt=torch.float32)
    before = (tconv.conv_elu.launches, tconv.gated_conv_elu.launches)
    got = tconv.conv_elu(x, wt, bias)
    torch.cuda.synchronize()
    assert (tconv.conv_elu.launches, tconv.gated_conv_elu.launches) == (
        before[0] + 1, before[1])
    want = tconv.conv_elu_plain(x, wt, bias)
    assert got.shape == want.shape == (b, h, w, co)
    if dt == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=1e-2)
    else:
        p = (k - 1) // 2
        terms = tconv.conv_magnitude(
            [torch.nn.functional.pad(x, (0, 0, p, p, p, p))],
            torch.ones(1, device="cuda"), wt)
        assert bool(((got - want).abs() <= 1e-5 * (1 + terms)).all())


@pytest.mark.gpu
def test_conv_elu_kernel_refuses_what_it_cannot_hold():
    """Channel counts the bf16 tiles cannot take, and a 31x31 kernel, whose
    halo chunk of 46x46 pixels does not fit in a block's shared memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from uncertainty_model_tpu_torch.ops import conv as tconv

    def zeros(*shape):
        return torch.zeros(shape, device="cuda", dtype=torch.bfloat16)

    bias = torch.zeros(16, device="cuda")
    before = tconv.conv_elu.launches
    with pytest.raises(ValueError, match="multiples of 16"):
        tconv.conv_elu(zeros(1, 4, 8, 8), zeros(3, 3, 8, 16), bias)
    with pytest.raises(ValueError, match="shared memory"):
        tconv.conv_elu(zeros(1, 8, 16, 64), zeros(31, 31, 64, 16), bias)
    assert tconv.conv_elu.launches == before


# ---------------------------------------------------------------------------
# upsample2x2

# (B, H, W, C): the decoder's 2x sites cut down (C = 32, 512, 256), channel
# counts that are not a multiple of a 16-byte vector, a 1-row input (one
# row tap) and a 1-column one
UPSAMPLE_CASES = {
    "c32": (2, 16, 24, 32),
    "c512": (1, 4, 8, 512),
    "c3": (2, 9, 13, 3),
    "c12": (1, 6, 5, 12),
    "one_row": (2, 1, 7, 8),
    "one_column": (1, 5, 1, 16),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(UPSAMPLE_CASES))
def test_upsample2x2_kernel_matches_plain(case, dtype):
    """Both passes in the plain version's order, every operation rounded
    on its own and the intermediate rounded to the storage type: bit for
    bit in f32 and bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from uncertainty_model_tpu_torch.ops import upsample as tup

    dt = getattr(torch, dtype)
    x = torch.from_numpy(np.random.default_rng(28).normal(
        size=UPSAMPLE_CASES[case]).astype(np.float32)).to("cuda", dt)
    before = tup.upsample2x2.launches
    got = tup.upsample2x2(x)
    torch.cuda.synchronize()
    assert tup.upsample2x2.launches == before + 1
    torch.testing.assert_close(got, tup.upsample2x2_plain(x), rtol=0, atol=0)


@pytest.mark.gpu
def test_upsample2x2_kernel_rejects_bad_operands():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from uncertainty_model_tpu_torch.ops import upsample as tup

    x = torch.zeros(2, 4, 6, 8, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        tup.upsample2x2(x.transpose(1, 2))
    with pytest.raises(TypeError):
        tup.upsample2x2(x.double())


# ---------------------------------------------------------------------------
# reflect_pad

def _reflect_pad_cases():
    """(B, H, W, C) by name: every input of the flagship's decoder reflect
    convs at 256x512 and b2 (``serving.reflect_conv_inputs``: upsample of
    dec0-dec4; iconv, whose concat widths 164, 84 and 44 in dec2-dec4 are
    not multiples of 8; disp of dec1-dec4), and 1x1, 1x2 and 2x3 maps,
    where numpy's rule repeats or reflects an index more than once."""
    from uncertainty_model_tpu_torch.config import (FLAGSHIP_INPUT,
                                                    FLAGSHIP_MODEL)
    from uncertainty_model_tpu_torch.serving import reflect_conv_inputs

    cases = {name: (2, *hwc) for name, hwc, _, _ in reflect_conv_inputs(
        FLAGSHIP_MODEL["decoder"]["layers"], FLAGSHIP_INPUT)}
    return {**cases, "map_1x1": (3, 1, 1, 5), "map_1x2": (2, 1, 2, 16),
            "map_2x3": (2, 2, 3, 3)}


REFLECT_PAD_CASES = _reflect_pad_cases()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scaled", [False, True], ids=["plain", "scaled"])
@pytest.mark.parametrize("case", sorted(REFLECT_PAD_CASES))
def test_reflect_pad_kernel_matches_plain(case, scaled, dtype):
    """The gather, the product rounded once and the zero channels: bit for
    bit in f32 and bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from uncertainty_model_tpu_torch.ops import pad as tpad

    dt = getattr(torch, dtype)
    shape = REFLECT_PAD_CASES[case]
    rng = np.random.default_rng(29)

    def t(*s):
        return torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
            "cuda", dt)

    x = t(*shape)
    scale = t(shape[0], shape[-1]) if scaled else None
    before = tpad.reflect_pad.launches
    got = tpad.reflect_pad(x, scale)
    torch.cuda.synchronize()
    assert tpad.reflect_pad.launches == before + 1
    assert got.shape[-1] == tpad.padded_channels(shape[-1])
    torch.testing.assert_close(got, tpad.reflect_pad_plain(x, scale), rtol=0,
                               atol=0)


@pytest.mark.gpu
def test_reflect_pad_launches_in_serving_not_training():
    """14 launches in one flagship serving forward (upsample and iconv of
    dec0-dec4, disp of dec1-dec4), none in a training step, whose
    ``reflect_conv`` keeps the gather."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from uncertainty_model_tpu_torch.config import (
        FLAGSHIP_INPUT, FLAGSHIP_LOSS, FLAGSHIP_MODEL)
    from uncertainty_model_tpu_torch.models import RandomlyConnectedModel
    from uncertainty_model_tpu_torch.ops import pad as tpad
    from uncertainty_model_tpu_torch.serving import (make_serving_forward,
                                                      reflect_conv_inputs)
    from uncertainty_model_tpu_torch.train import Trainer

    model = RandomlyConnectedModel.from_config(**FLAGSHIP_MODEL, seed=0,
                                               device="cuda")
    rng = np.random.default_rng(30)

    def images(b):
        return torch.from_numpy(rng.uniform(size=(b, *FLAGSHIP_INPUT, 3))
                                .astype(np.float32)).to("cuda")

    forward = make_serving_forward(model.eval(), torch.bfloat16, "cuda")
    before = tpad.reflect_pad.launches
    forward(images(1))
    torch.cuda.synchronize()
    assert tpad.reflect_pad.launches == before + len(
        reflect_conv_inputs(FLAGSHIP_MODEL["decoder"]["layers"],
                            FLAGSHIP_INPUT)) == before + 14
    del forward
    trainer = Trainer(model.train(), FLAGSHIP_LOSS, device="cuda")
    before = tpad.reflect_pad.launches
    trainer.train_step({"left": images(2), "right": images(2)}, 0.3, 1e-4)
    torch.cuda.synchronize()
    assert tpad.reflect_pad.launches == before


@pytest.mark.gpu
def test_reflect_pad_kernel_rejects_bad_operands():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from uncertainty_model_tpu_torch.ops import pad as tpad

    x = torch.zeros(2, 4, 6, 12, device="cuda", dtype=torch.bfloat16)
    before = tpad.reflect_pad.launches
    with pytest.raises(ValueError, match="contiguous"):
        tpad.reflect_pad(x.transpose(1, 2))
    with pytest.raises(TypeError):
        tpad.reflect_pad(x.double())
    with pytest.raises(ValueError, match="scale"):
        tpad.reflect_pad(x, torch.ones(2, 6, device="cuda",
                                       dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="scale"):
        tpad.reflect_pad(x, torch.ones(2, 12, device="cuda"))
    assert tpad.reflect_pad.launches == before


# ---------------------------------------------------------------------------
# attend

def _attend_cases():
    """(B, N, heads, d, keys_smax, smax) by name: the five stages at b1 and
    b8 in the cells' "window"; the s2d path's maps of stage 1, (B, 4hw,
    C/4) on its 32x64 s2d grid, with the keys "window" and the queries
    "nomax" as ``serving._attention_s2d`` takes them under the JAX
    package's default; a ragged N (no multiple of a chunk or a lane's
    step) in "slice" and "nomax"."""
    from uncertainty_model_tpu_torch.config import (FLAGSHIP_INPUT,
                                                    FLAGSHIP_MODEL)

    h, w = FLAGSHIP_INPUT
    cases = {f"enc{i}_b{b}": ((b, (h >> (i + 1)) * (w >> (i + 1)),
                               layer["heads"],
                               layer["out_channels"] // layer["heads"],
                               "window", "window"))
             for i, layer in enumerate(FLAGSHIP_MODEL["encoder"]["layers"])
             for b in (1, 8)}
    cases["s2d_enc1_b8"] = (8, 4 * 32 * 64, 8, 8, "window", "nomax")
    cases["ragged_b3"] = (3, 4099, 8, 16, "slice", "nomax")
    return cases


ATTEND_CASES = _attend_cases()


def _attend_operands(seed, b, n, c):
    """Keys and queries N(0, 2^2), values N(0, 1), f32 on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def t(scale):
        return scale * torch.randn(b, n, c, generator=gen, device="cuda")

    return t(2.0), t(2.0), t(1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(ATTEND_CASES))
def test_attend_kernel_matches_plain(case):
    """The yardstick is the plain version in f32 on the same bf16 inputs.
    The bf16 kernel (f32 throughout, the output rounded once) is no
    farther from it than the bf16 plain version (each softmax and the
    context rounded as well), by the norm of the difference and by its
    largest element; the f32 kernel is within rtol 1e-4, atol 1e-5 of the
    f32 plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from uncertainty_model_tpu_torch.ops import attend as tat

    b, n, heads, d, keys_smax, smax = ATTEND_CASES[case]
    operands = _attend_operands(32, b, n, heads * d)
    before = tat.attend.launches
    got32 = tat.attend(*operands, heads, smax, keys_smax)
    torch.testing.assert_close(
        got32, tat.attend_plain(*operands, heads, smax, keys_smax),
        rtol=1e-4, atol=1e-5)
    low = [t.bfloat16() for t in operands]
    got = tat.attend(*low, heads, smax, keys_smax)
    torch.cuda.synchronize()
    assert tat.attend.launches == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == low[0].shape
    want = tat.attend_plain(*[t.float() for t in low], heads, smax, keys_smax)
    plain = tat.attend_plain(*low, heads, smax, keys_smax)
    err = (got.float() - want).flatten()
    err_plain = (plain.float() - want).flatten()
    assert err.norm() <= err_plain.norm(), (err.norm(), err_plain.norm())
    assert err.abs().max() <= err_plain.abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("side", ["keys", "queries"])
def test_attend_kernel_overflows_where_plain_does(side):
    """A logit of 100 in one head of one image: under "nomax" exp
    overflows (bf16 and f32 share its range), and the kernel's output is
    non-finite exactly where the plain version's is (the whole head of the
    image for a key, the token's head for a query), finite and no farther
    from the f32 yardstick elsewhere; "window" stays finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from uncertainty_model_tpu_torch.ops import attend as tat

    heads = 8
    operands = list(_attend_operands(33, 2, 3001, heads * 8))
    operands[0 if side == "keys" else 1][0, 17, 3] = 100.0
    low = [t.bfloat16() for t in operands]
    got = tat.attend(*low, heads, "nomax")
    plain = tat.attend_plain(*low, heads, "nomax")
    finite = torch.isfinite(plain)
    assert not finite.all()
    assert torch.equal(torch.isfinite(got), finite)
    want = tat.attend_plain(*[t.float() for t in low], heads, "nomax")
    assert ((got.float() - want)[finite].norm()
            <= (plain.float() - want)[finite].norm())
    safe = tat.attend(*low, heads, "window")
    assert torch.isfinite(safe).all()
    want = tat.attend_plain(*[t.float() for t in low], heads, "window")
    assert ((safe.float() - want).norm()
            <= (tat.attend_plain(*low, heads, "window").float() - want).norm())


@pytest.mark.gpu
def test_attend_launches_in_serving_not_training():
    """5 launches in one flagship serving forward (the attention of
    enc0-enc4), native or with the s2d stages (0, 1), none in a training
    step, whose ``EfficientAttention`` runs under autograd."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from uncertainty_model_tpu_torch.config import (
        FLAGSHIP_INPUT, FLAGSHIP_LOSS, FLAGSHIP_MODEL)
    from uncertainty_model_tpu_torch.models import RandomlyConnectedModel
    from uncertainty_model_tpu_torch.ops import attend as tat
    from uncertainty_model_tpu_torch.serving import make_serving_forward
    from uncertainty_model_tpu_torch.train import Trainer

    model = RandomlyConnectedModel.from_config(**FLAGSHIP_MODEL, seed=0,
                                               device="cuda")
    rng = np.random.default_rng(34)

    def images(b):
        return torch.from_numpy(rng.uniform(size=(b, *FLAGSHIP_INPUT, 3))
                                .astype(np.float32)).to("cuda")

    for s2d in ((), (0, 1)):
        forward = make_serving_forward(model.eval(), torch.bfloat16, "cuda",
                                       s2d_stages=s2d)
        before = tat.attend.launches
        out = forward(images(1))
        torch.cuda.synchronize()
        assert tat.attend.launches == before + 5
        assert torch.isfinite(out).all()
        del forward
    trainer = Trainer(model.train(), FLAGSHIP_LOSS, device="cuda")
    before = tat.attend.launches
    trainer.train_step({"left": images(2), "right": images(2)}, 0.3, 1e-4)
    torch.cuda.synchronize()
    assert tat.attend.launches == before


@pytest.mark.gpu
def test_attend_kernel_rejects_bad_operands():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from uncertainty_model_tpu_torch.ops import attend as tat

    x = torch.zeros(2, 40, 64, device="cuda", dtype=torch.bfloat16)
    before = tat.attend.launches
    with pytest.raises(ValueError, match="contiguous"):
        tat.attend(x.transpose(0, 1).contiguous().transpose(0, 1), x, x, 8,
                   "window")
    with pytest.raises(TypeError):
        tat.attend(x.double(), x.double(), x.double(), 8, "window")
    with pytest.raises(TypeError, match="differ"):
        tat.attend(x, x.float(), x, 8, "window")
    with pytest.raises(ValueError, match="channels"):
        tat.attend(x[..., :48].contiguous(), x[..., :48].contiguous(),
                   x[..., :48].contiguous(), 8, "window")   # d = 6
    assert tat.attend.launches == before
