"""The port's ``assemble_z`` against the JAX package's: the plain PyTorch
version against the JAX fallback and against the Pallas kernel in interpret
mode.  (The CUDA kernel is held against the plain version on the card by
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
    fm, skip, xc, disp, bias, k_fm = _torch(_inputs(13, cf=3))
    folded = tdf.assemble_z_plain(fm, skip, xc, disp, bias, k_fm=k_fm)
    unfolded = tdf.assemble_z_plain(fm @ k_fm, skip, xc, disp, bias)
    for a, b in zip(folded, unfolded):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_bf16_plain_rounds_once():
    """bf16 inputs: computed in f32, cast at the end — so the result is the
    f32 result of the bf16-rounded inputs, rounded once."""
    args = _torch(_inputs(14, cf=3), dtype=torch.bfloat16)
    cat, mean = tdf.assemble_z_plain(*args)
    assert cat.dtype == torch.bfloat16 and mean.dtype == torch.float32
    ref_cat, _ = tdf.assemble_z_plain(
        *[None if a is None else a.float() for a in args])
    torch.testing.assert_close(cat, ref_cat.to(torch.bfloat16), rtol=0, atol=0)
    torch.testing.assert_close(mean, cat[..., :args[1].shape[-1]].float()
                               .mean(dim=(1, 2)), rtol=1e-6, atol=1e-6)


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
