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
