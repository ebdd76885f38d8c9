"""The port's decoder glue (``assemble_z``, ``gate_z``, ``se_squeeze``,
``assemble``) against the JAX package's: the plain PyTorch versions against
the JAX fallbacks and against the Pallas kernels in interpret mode.  (The
CUDA kernels are held against the plain versions on the card by
tests/test_torch_kernels_gpu.py and chip_smoke.py.)

Inputs come from a numpy seed and are shared by both sides as numpy arrays.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_port_helpers  # noqa: F401  (sets the torch thread count)

import uncertainty_model_tpu.ops.pallas.decoder_fused as jdf

from uncertainty_model_tpu_torch.ops import decoder_fused as tdf
from uncertainty_model_tpu_torch.ops import resize_bilinear, shuffle_phase_major
from uncertainty_model_tpu_torch.ops.resize import bf16_weights


def _inputs(seed, b=4, h2=8, w2=16, cso=16, cu=8, cd=4, cf=None):
    """(se_fm or fm, skip_h, xc, disp_h or None, bias, k_fm or None)."""
    rng = np.random.default_rng(seed)
    h, w = 2 * h2, 2 * w2

    def normal(*shape):
        return rng.normal(size=shape).astype(np.float32)

    se = normal(b, h, w, cf if cf else cso)
    skip, xc = normal(b, h2, w2, cso), normal(b, h2, w2, 4 * cu)
    disp = normal(b, h2, w2, cd) if cd else None
    bias = normal(cso)
    k_fm = normal(cf, cso) if cf else None
    return se, skip, xc, disp, bias, k_fm


def _jax(args):
    return [None if a is None else jnp.asarray(a) for a in args]


def _torch(args, **kw):
    return [None if a is None else torch.from_numpy(a).to(**kw) for a in args]


CASES = {
    "disp": dict(cd=4),
    "no_disp": dict(cd=0),
    "fold": dict(cd=4, cf=3),
    "fold_no_disp": dict(cd=0, cf=3),
}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jdf, "_INTERPRET", True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_fallback(case):
    args = _inputs(10, **CASES[case])
    cat, mean = tdf.assemble_z_plain(*_torch(args))
    ref_cat, ref_mean = jdf.assemble_z(*_jax(args))
    np.testing.assert_allclose(cat.numpy(), np.asarray(ref_cat),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mean.numpy(), np.asarray(ref_mean),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_pallas_interpret(case, interpret):
    args = _inputs(11, **CASES[case])
    cat, mean = tdf.assemble_z_plain(*_torch(args))
    ref_cat, ref_mean = jdf.assemble_z(*_jax(args))
    np.testing.assert_allclose(cat.numpy(), np.asarray(ref_cat),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(mean.numpy(), np.asarray(ref_mean),
                               rtol=1e-4, atol=1e-5)


def test_channel_order():
    """cat = [z | xup | disp], each block computed independently."""
    se, skip, xc, disp, bias, _ = [
        None if a is None else torch.from_numpy(a) for a in _inputs(12)]
    cso, cu = skip.shape[-1], xc.shape[-1] // 4
    cat, mean = tdf.assemble_z_plain(se, skip, xc, disp, bias)
    h, w = se.shape[1:3]
    z = torch.nn.functional.elu(se + resize_bilinear(skip, (h, w)) + bias)
    torch.testing.assert_close(cat[..., :cso], z, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(
        cat[..., cso:cso + cu],
        shuffle_phase_major(torch.nn.functional.elu(xc)), rtol=0, atol=0)
    torch.testing.assert_close(cat[..., cso + cu:],
                               resize_bilinear(disp, (h, w)), rtol=0, atol=0)
    torch.testing.assert_close(mean, z.mean(dim=(1, 2)), rtol=1e-6, atol=1e-6)


def test_fold_equals_unfolded():
    """The fold is the ordered sum fm[0] k[0] + fm[1] k[1] + ..., each
    product and sum rounded on its own (the kernel's order)."""
    fm, skip, xc, disp, bias, k_fm = _torch(_inputs(13, cf=3))
    folded = tdf.assemble_z_plain(fm, skip, xc, disp, bias, k_fm=k_fm)
    se = fm[..., 0:1] * k_fm[0]
    for ci in range(1, k_fm.shape[0]):
        se = se + fm[..., ci:ci + 1] * k_fm[ci]
    unfolded = tdf.assemble_z_plain(se, skip, xc, disp, bias)
    for a, b in zip(folded, unfolded):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _up2_bf16_weights(x):
    """The 2x upsample in numpy f32 with the JAX package's bf16 weights,
    H then W, not rounded: x[lo] bf16(1 - frac) + x[hi] bf16(frac)."""
    _, h2, w2, _ = x.shape
    lo, hi, a, b = bf16_weights(2 * h2, h2)
    x = x[:, lo] * a[None, :, None, None] + x[:, hi] * b[None, :, None, None]
    lo, hi, a, b = bf16_weights(2 * w2, w2)
    return x[:, :, lo] * a[None, None, :, None] + x[:, :, hi] * b[None, None, :, None]


def test_bf16_plain_rounds_once():
    """bf16 inputs: z is computed in f32 (the fold in order, up2 with the
    JAX package's bf16 weights bf16(1 - frac) and bf16(frac), no rounding
    between the axes) and rounded once; the disparity block likewise.
    Written out here in numpy; rounding each axis to bf16 gives other
    values."""
    args = _torch(_inputs(14, cf=3), dtype=torch.bfloat16)
    fm, skip, xc, disp, bias, k_fm = args
    cat, mean = tdf.assemble_z_plain(*args)
    assert cat.dtype == torch.bfloat16 and mean.dtype == torch.float32
    fm32, k32 = fm.float().numpy(), k_fm.float().numpy()
    se = fm32[..., 0:1] * k32[0]
    for ci in range(1, k32.shape[0]):
        se = se + fm32[..., ci:ci + 1] * k32[ci]
    se = se + _up2_bf16_weights(skip.float().numpy()) + bias.float().numpy()
    z = torch.nn.functional.elu(torch.from_numpy(se)).to(torch.bfloat16)
    cso, cu = skip.shape[-1], xc.shape[-1] // 4
    assert torch.equal(cat[..., :cso], z)
    up_disp = torch.from_numpy(_up2_bf16_weights(disp.float().numpy()))
    assert torch.equal(cat[..., cso + cu:], up_disp.to(torch.bfloat16))
    per_axis = resize_bilinear(disp, tuple(cat.shape[1:3]))
    assert not torch.equal(cat[..., cso + cu:], per_axis)
    torch.testing.assert_close(mean, cat[..., :cso].float().mean(dim=(1, 2)),
                               rtol=1e-6, atol=1e-6)


# the port's bf16 plain versions against the JAX package's in bf16: both
# take the same bf16 upsample weights, but the JAX package rounds
# up2(skip_h) after each axis and se + up2 to bf16 before the f32 bias add,
# where the port rounds z once.  Read on these N(0, 1) inputs: at most
# 0.03125 (two bf16 steps of |se + up2| in [2, 4)) for the fallback and the
# interpret-mode kernel alike, and 0.004 in the means over 512 pixels; the
# limits keep twice that
BF16_JAX_TOL = dict(rtol=2 ** -7, atol=2 ** -4)
BF16_JAX_MEAN_ATOL = 1e-2


def _bf16(args):
    """Tensors and arrays in bf16, except bias and k_fm (f32, as serving
    passes them)."""
    *acts, bias, k_fm = args
    return ([None if a is None else torch.from_numpy(a).bfloat16()
             for a in acts] + _torch([bias, k_fm]),
            [None if a is None else jnp.asarray(a).astype(jnp.bfloat16)
             for a in acts] + _jax([bias, k_fm]))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("kernel", ["assemble_z", "se_squeeze", "assemble"])
@pytest.mark.parametrize("reference", ["fallback", "interpret"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_plain_close_to_jax_bf16(case, reference, kernel, monkeypatch):
    monkeypatch.setattr(jdf, "_INTERPRET", reference == "interpret")
    (se, skip, xc, disp, bias, k_fm), jargs = _bf16(_inputs(30, **CASES[case]))
    jse, jskip, jxc, jdisp, jbias, jk_fm = jargs
    gates = _gates(30)
    if kernel == "assemble_z":
        got, got_mean = tdf.assemble_z_plain(se, skip, xc, disp, bias, k_fm)
        want, want_mean = jdf.assemble_z(*jargs)
    elif kernel == "se_squeeze":
        got, want = None, None
        got_mean = tdf.se_squeeze_plain(se, skip, bias, k_fm)
        want_mean = jdf.se_squeeze(jse, jskip, jbias, jk_fm)
    else:
        got_mean, want_mean = None, None
        got = tdf.assemble_plain(se, skip, torch.from_numpy(gates).bfloat16(),
                                 xc, disp, bias, k_fm)
        want = jdf.assemble(jse, jskip, jnp.asarray(gates).astype(jnp.bfloat16),
                            jxc, jdisp, jbias, jk_fm)
    if got is not None:
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_f32(got), _f32(want), **BF16_JAX_TOL)
    if got_mean is not None:
        np.testing.assert_allclose(got_mean.numpy(), np.asarray(want_mean),
                                   rtol=0, atol=BF16_JAX_MEAN_ATOL)


def test_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    args = _torch(_inputs(15))
    before = tdf.assemble_z.launches
    got = tdf.assemble_z(*args)
    want = tdf.assemble_z_plain(*args)
    assert tdf.assemble_z.launches == before
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["odd_size", "xc_channels", "bias", "k_fm"])
def test_wrapper_rejects_bad_shapes(bad):
    se, skip, xc, disp, bias, k_fm = _torch(_inputs(16, cf=3))
    if bad == "odd_size":
        se = se[:, :-1]
    elif bad == "xc_channels":
        xc = xc[..., :-1]
    elif bad == "bias":
        bias = bias[:-1]
    else:
        k_fm = k_fm[:, :-1]
    with pytest.raises(ValueError):
        tdf.assemble_z(se, skip, xc, disp, bias, k_fm=k_fm)


def _gates(seed, b=4, cso=16):
    return np.random.default_rng(seed).uniform(0.1, 1.0, (b, cso)).astype(
        np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_se_squeeze_plain_matches_jax_pallas_interpret(case, interpret):
    se, skip, _, _, bias, k_fm = _inputs(17, **CASES[case])
    got = tdf.se_squeeze_plain(*_torch([se, skip, bias, k_fm]))
    want = jdf.se_squeeze(*_jax([se, skip, bias, k_fm]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_assemble_plain_matches_jax_pallas_interpret(case, interpret):
    se, skip, xc, disp, bias, k_fm = _inputs(18, **CASES[case])
    args = [se, skip, _gates(18), xc, disp, bias, k_fm]
    got = tdf.assemble_plain(*_torch(args))
    want = jdf.assemble(*_jax(args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("case", ["disp", "no_disp"])
def test_gate_z_plain_matches_jax_pallas_interpret(case, interpret):
    cat, _ = tdf.assemble_z_plain(*_torch(_inputs(19, **CASES[case])))
    gates = _gates(19)
    want = np.asarray(jdf.gate_z(jnp.asarray(cat.numpy()), jnp.asarray(gates),
                                 16))
    before = cat.clone()
    got = tdf.gate_z_plain(cat, torch.from_numpy(gates), 16)
    assert got.data_ptr() == cat.data_ptr()  # in place
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[..., 16:].numpy(), before[..., 16:].numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_assemble_equals_gate_z_of_assemble_z(case, dtype):
    """The squeeze_first pipeline's tensors equal the gate_z pipeline's bit
    for bit, and its mean equals assemble_z's."""
    se, skip, xc, disp, bias, k_fm = _torch(_inputs(20, **CASES[case]),
                                            dtype=dtype)
    bias = bias.float()
    k_fm = None if k_fm is None else k_fm.float()
    gates = torch.from_numpy(_gates(20)).to(dtype)
    cat, mean = tdf.assemble_z(se, skip, xc, disp, bias, k_fm)
    gated = tdf.gate_z(cat, gates, 16)
    assert torch.equal(tdf.assemble(se, skip, gates, xc, disp, bias, k_fm),
                       gated)
    assert torch.equal(tdf.se_squeeze(se, skip, bias, k_fm), mean)


def test_glue_wrappers_on_cpu_count_no_launch():
    se, skip, xc, disp, bias, _ = _torch(_inputs(21))
    gates = torch.from_numpy(_gates(21))
    before = (tdf.gate_z.launches, tdf.se_squeeze.launches,
              tdf.assemble.launches)
    tdf.gate_z(tdf.assemble(se, skip, gates, xc, disp, bias), gates, 16)
    tdf.se_squeeze(se, skip, bias)
    assert (tdf.gate_z.launches, tdf.se_squeeze.launches,
            tdf.assemble.launches) == before


@pytest.mark.parametrize("bad", ["gates", "cso"])
def test_gate_z_and_assemble_reject_bad_shapes(bad):
    se, skip, xc, disp, bias, _ = _torch(_inputs(22))
    gates = torch.from_numpy(_gates(22))
    cat, _ = tdf.assemble_z(se, skip, xc, disp, bias)
    with pytest.raises(ValueError):
        if bad == "gates":
            tdf.assemble(se, skip, gates[:, :-1], xc, disp, bias)
        else:
            tdf.gate_z(cat, gates, cat.shape[-1] + 1)


# dec0- and dec1-like stages (fused_stages=(0, ..., 4)): no disparity to
# concat, no fold, Cso 8x and 4x the tiny stages' 16
WIDE = {
    "dec0_like": dict(b=2, h2=2, w2=4, cso=128, cu=32, cd=0),
    "dec1_like": dict(b=2, h2=4, w2=8, cso=64, cu=16, cd=0),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["assemble_z", "gate_z", "se_squeeze",
                                    "assemble"])
@pytest.mark.parametrize("case", sorted(WIDE))
def test_wide_plain_matches_jax_pallas_interpret(case, kernel, dtype,
                                                 interpret):
    """Each kernel's plain version against the JAX Pallas kernel in
    interpret mode on the same inputs: f32 within rtol 1e-4, atol 1e-5;
    bf16 within ``BF16_JAX_TOL`` (the JAX package rounds each bf16 step;
    gate_z, one product a lane, bit for bit)."""
    shape = WIDE[case]
    args = _inputs(70, **shape)
    gates = np.random.default_rng(70).uniform(
        0.1, 1.0, (shape["b"], shape["cso"])).astype(np.float32)
    if dtype == "bf16":
        (se, skip, xc, disp, bias, k_fm), jargs = _bf16(args)
        tgates = torch.from_numpy(gates).bfloat16()
        jgates = jnp.asarray(gates).astype(jnp.bfloat16)
        tol, mean_tol = BF16_JAX_TOL, dict(rtol=0, atol=BF16_JAX_MEAN_ATOL)
    else:
        se, skip, xc, disp, bias, k_fm = _torch(args)
        jargs = _jax(args)
        tgates, jgates = torch.from_numpy(gates), jnp.asarray(gates)
        tol = mean_tol = dict(rtol=1e-4, atol=1e-5)
    jse, jskip, jxc, jdisp, jbias, _ = jargs
    assert disp is None and k_fm is None
    got_mean = want_mean = None
    if kernel == "assemble_z":
        got, got_mean = tdf.assemble_z_plain(se, skip, xc, None, bias)
        want, want_mean = jdf.assemble_z(jse, jskip, jxc, None, jbias)
    elif kernel == "gate_z":
        cat, _ = tdf.assemble_z_plain(se, skip, xc, None, bias)
        jcat = jnp.asarray(cat.float().numpy().copy()).astype(jgates.dtype)
        # finish the JAX call before the port's gates cat in place
        want = np.asarray(jdf.gate_z(jcat, jgates, shape["cso"]))
        got = tdf.gate_z_plain(cat, tgates, shape["cso"])
        tol = dict(rtol=0, atol=0)
    elif kernel == "se_squeeze":
        got = want = None
        got_mean = tdf.se_squeeze_plain(se, skip, bias)
        want_mean = jdf.se_squeeze(jse, jskip, jbias)
    else:
        got = tdf.assemble_plain(se, skip, tgates, xc, None, bias)
        want = jdf.assemble(jse, jskip, jgates, jxc, None, jbias)
    if got is not None:
        assert got.shape[-1] == shape["cso"] + shape["cu"]
        np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    if got_mean is not None:
        np.testing.assert_allclose(got_mean.numpy(), np.asarray(want_mean),
                                   **mean_tol)
