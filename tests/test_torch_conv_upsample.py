"""The port's ``conv_elu`` and ``upsample2x2`` (the last two TPU kernels,
K6 and K8) against the JAX package's: the plain versions against the
Pallas kernels in interpret mode, as tests/test_pallas_kernels.py runs them.
(The CUDA kernels are held against the plain versions on the card by
tests/test_torch_kernels_gpu.py and chip_smoke.py.)

Inputs come from a numpy seed and are shared by both sides as numpy arrays.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_port_helpers  # noqa: F401  (sets the torch thread count)

import uncertainty_model_tpu.ops.pallas.conv as jconv
import uncertainty_model_tpu.ops.pallas.upsample as jup
from uncertainty_model_tpu.ops.resize import resize_bilinear as jax_resize

from uncertainty_model_tpu_torch.ops import conv as tconv
from uncertainty_model_tpu_torch.ops import upsample as tup
from uncertainty_model_tpu_torch.ops.resize import _lerp_coeffs, resize_bilinear

BF16_ULP = dict(rtol=2 ** -7, atol=1e-2)   # one bf16 ulp of the output


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jconv, "_INTERPRET", True)
    monkeypatch.setattr(jup, "_INTERPRET", True)


def _conv_inputs(shape, seed=0):
    """x (B, H, W, C), HWIO w scaled by 0.1 and b, as
    tests/test_pallas_kernels.py draws them."""
    b, h, w, c, co, k = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, w, c)).astype(np.float32),
            (rng.standard_normal((k, k, c, co)) * 0.1).astype(np.float32),
            rng.standard_normal(co).astype(np.float32))


# (B, H, W, C, Co, k): tests/test_pallas_kernels.py's two shapes and a 7x7
CONV_SHAPES = [(2, 16, 32, 8, 16, 5), (1, 8, 16, 16, 8, 3),
               (1, 8, 12, 8, 8, 7)]


@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv_elu_plain_matches_jax_pallas_interpret(shape, interpret):
    """f32 at atol 1e-5 (the conv's sums in another order)."""
    x, w, b = _conv_inputs(shape)
    got = tconv.conv_elu_plain(*map(torch.from_numpy, (x, w, b)))
    want = jconv.conv_elu(*map(jnp.asarray, (x, w, b)))
    assert got.shape == want.shape == (*shape[:3], shape[4])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("shape", CONV_SHAPES[::2])
def test_conv_elu_bf16_plain_within_one_ulp_of_jax_pallas(shape, interpret):
    """bf16 operands, the sums and the epilogue in f32 and one rounding in
    both: within one bf16 ulp of the output."""
    x, w, b = _conv_inputs(shape, seed=1)
    got = tconv.conv_elu_plain(torch.from_numpy(x).bfloat16(),
                               torch.from_numpy(w).bfloat16(),
                               torch.from_numpy(b))
    want = jconv.conv_elu(jnp.asarray(x, jnp.bfloat16),
                          jnp.asarray(w, jnp.bfloat16), jnp.asarray(b))
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(
        got.float(), torch.from_numpy(np.asarray(want.astype(jnp.float32))),
        **BF16_ULP)


def test_conv_elu_is_the_gated_conv_of_the_padded_input():
    """``conv_elu(x)`` equals ``gated_conv_elu`` of the zero-padded ``x``
    with one gate of 1, bit for bit: the same conv, the pad done first."""
    x, w, b = map(torch.from_numpy, _conv_inputs(CONV_SHAPES[0], seed=2))
    p = (w.shape[0] - 1) // 2
    xp = torch.nn.functional.pad(x, (0, 0, p, p, p, p))
    torch.testing.assert_close(
        tconv.conv_elu(x, w, b),
        tconv.gated_conv_elu([xp], torch.ones(1), w, b), rtol=0, atol=0)


def test_conv_elu_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    args = tuple(map(torch.from_numpy, _conv_inputs(CONV_SHAPES[1], seed=3)))
    before = (tconv.conv_elu.launches, tconv.gated_conv_elu.launches)
    got = tconv.conv_elu(*args)
    assert (tconv.conv_elu.launches, tconv.gated_conv_elu.launches) == before
    torch.testing.assert_close(got, tconv.conv_elu_plain(*args), rtol=0,
                               atol=0)


@pytest.mark.parametrize("bad", ["even_k", "channels", "bias", "rank"])
def test_conv_elu_rejects_bad_operands(bad):
    x, w, b = map(torch.from_numpy, _conv_inputs(CONV_SHAPES[1], seed=4))
    if bad == "even_k":
        w = w[:2, :2]
    elif bad == "channels":
        x = x[..., :-1]
    elif bad == "bias":
        b = b[:-1]
    else:
        x = x[0]
    with pytest.raises(ValueError):
        tconv.conv_elu(x, w, b)


# ---------------------------------------------------------------------------
# upsample2x2


def _image(shape, seed=2):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("shape", [(2, 16, 16, 8), (1, 32, 8, 4)])
def test_upsample2x2_plain_matches_jax_pallas_interpret(shape, interpret):
    """f32 at atol 2e-6 (tests/test_pallas_kernels.py's limit): the same
    taps; the row pass is a matmul there, two rounded products here."""
    x = _image(shape)
    got = tup.upsample2x2_plain(torch.from_numpy(x))
    want = jup.upsample2x2(jnp.asarray(x))
    assert got.shape == want.shape == (shape[0], 2 * shape[1], 2 * shape[2],
                                       shape[3])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6)


@pytest.mark.parametrize("shape", [(1, 8, 32, 3), (2, 1, 5, 3), (1, 3, 1, 2)])
def test_upsample2x2_plain_matches_resize_below_the_jax_guard(shape):
    """Shapes the JAX entry point sends to ``resize_bilinear`` (H < 16; a
    1-row and a 1-column input), held against it at the same 2e-6, and the
    port's own resize."""
    x = _image(shape, seed=3)
    got = tup.upsample2x2_plain(torch.from_numpy(x))
    size = (2 * shape[1], 2 * shape[2])
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_resize(jnp.asarray(x), size)),
                               rtol=0, atol=2e-6)
    torch.testing.assert_close(
        got, resize_bilinear(torch.from_numpy(x), size), rtol=0, atol=2e-6)


def test_upsample2x2_bf16_plain_within_one_ulp_of_jax_pallas(interpret):
    """bf16: the column pass rounded to bf16 as the Pallas kernel stores
    it, the row pass in f32 and one rounding; within one bf16 ulp."""
    x = _image((2, 16, 24, 8), seed=4)
    got = tup.upsample2x2_plain(torch.from_numpy(x).bfloat16())
    want = jup.upsample2x2(jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(
        got.float(), torch.from_numpy(np.asarray(want.astype(jnp.float32))),
        **BF16_ULP)


def test_upsample2x2_bf16_plain_rounds_the_column_pass():
    """bf16: the column pass in f32 rounded to bf16 (the Pallas kernel's
    intermediate), the row pass in f32 and one rounding, written out here
    in numpy from ``_lerp_coeffs``; rounding only once gives other
    values."""
    x = torch.from_numpy(_image((2, 5, 7, 3), seed=5)).bfloat16()
    xf = x.float().numpy()
    _, _, fw = _lerp_coeffs(14, 7)
    lo, hi, fh = _lerp_coeffs(10, 5)
    prev = np.concatenate([xf[:, :, :1], xf[:, :, :-1]], axis=2)
    nxt = np.concatenate([xf[:, :, 1:], xf[:, :, -1:]], axis=2)
    even = prev + fw[0::2, None] * (xf - prev)
    odd = xf + fw[1::2, None] * (nxt - xf)
    y1 = np.stack([even, odd], axis=3).reshape(2, 5, 14, 3)
    y1 = torch.from_numpy(y1).bfloat16().float().numpy()
    rows = ((np.float32(1) - fh)[:, None, None] * y1[:, lo]
            + fh[:, None, None] * y1[:, hi])
    got = tup.upsample2x2_plain(x)
    np.testing.assert_array_equal(
        got.float().numpy(), torch.from_numpy(rows).bfloat16().float().numpy())
    once = tup.upsample2x2_plain(x.float()).bfloat16()
    assert not torch.equal(got, once)


def test_upsample2x2_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    x = torch.from_numpy(_image((1, 16, 16, 3), seed=6))
    before = tup.upsample2x2.launches
    got = tup.upsample2x2(x)
    assert tup.upsample2x2.launches == before
    torch.testing.assert_close(got, tup.upsample2x2_plain(x), rtol=0, atol=0)
    with pytest.raises(ValueError):
        tup.upsample2x2(x[0])
