"""The port's space-to-depth rewrites (``ops/s2d.py``) and its
``gated_conv_elu`` against the JAX package's: the transforms exactly, and
the plain version against the Pallas kernel in interpret mode and against
the JAX fallback.  (The CUDA kernel is held against the plain version on
the card by tests/test_torch_kernels_gpu.py and chip_smoke.py.)

Inputs come from a numpy seed and are shared by both sides as numpy arrays.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_port_helpers  # noqa: F401  (sets the torch thread count)

import uncertainty_model_tpu.ops.pallas.conv as jconv
import uncertainty_model_tpu.ops.s2d as js2d

from uncertainty_model_tpu_torch.ops import conv as tconv
from uncertainty_model_tpu_torch.ops import s2d as ts2d


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


@pytest.mark.parametrize("k", [3, 5, 7, 9])
def test_s2d_conv_kernel_equals_jax(k):
    w = _normal(np.random.default_rng(k), k, k, 3, 5)
    got = ts2d.s2d_conv_kernel(torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, np.asarray(js2d.s2d_conv_kernel(
        jnp.asarray(w))))


@pytest.mark.parametrize("k", [3, 5, 7, 9])
def test_s2d_out_stride2_conv_kernel_equals_jax(k):
    w = _normal(np.random.default_rng(10 + k), k, k, 3, 5)
    got = ts2d.s2d_out_stride2_conv_kernel(torch.from_numpy(w))
    want = js2d.s2d_out_stride2_conv_kernel(jnp.asarray(w))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[1:] == want[1:]


@pytest.mark.parametrize("k", [5, 9])
def test_s2d_in_stride2_conv_kernel_equals_jax(k):
    w = _normal(np.random.default_rng(20 + k), k, k, 3, 5)
    got = ts2d.s2d_in_stride2_conv_kernel(torch.from_numpy(w))
    want = js2d.s2d_in_stride2_conv_kernel(jnp.asarray(w))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[1:] == want[1:]


def test_s2d_in_stride2_conv_kernel_refuses_odd_pad():
    with pytest.raises(ValueError, match="even pad"):
        ts2d.s2d_in_stride2_conv_kernel(torch.zeros(7, 7, 2, 2))


def test_block_diag_and_bias_equal_jax():
    rng = np.random.default_rng(30)
    w, b = _normal(rng, 1, 1, 3, 5), _normal(rng, 5)
    np.testing.assert_array_equal(
        ts2d.block_diag_1x1_kernel(torch.from_numpy(w)).numpy(),
        np.asarray(js2d.block_diag_1x1_kernel(jnp.asarray(w))))
    np.testing.assert_array_equal(ts2d.s2d_bias(torch.from_numpy(b)).numpy(),
                                  np.asarray(js2d.s2d_bias(jnp.asarray(b))))


def test_space_to_depth_equals_jax_and_round_trips():
    x = _normal(np.random.default_rng(31), 2, 6, 10, 3)
    s = ts2d.space_to_depth(torch.from_numpy(x))
    np.testing.assert_array_equal(s.numpy(), np.asarray(
        js2d.space_to_depth(jnp.asarray(x))))
    np.testing.assert_array_equal(ts2d.depth_to_space(s).numpy(), x)
    y = _normal(np.random.default_rng(33), 2, 3, 5, 12)
    np.testing.assert_array_equal(
        ts2d.depth_to_space(torch.from_numpy(y)).numpy(),
        np.asarray(js2d.depth_to_space(jnp.asarray(y))))


def test_s2d_conv_equals_native_conv():
    """The rewritten conv on the s2d map is the native conv, in s2d form."""
    rng = np.random.default_rng(32)
    x = torch.from_numpy(_normal(rng, 2, 8, 12, 3))
    w = torch.from_numpy(_normal(rng, 7, 7, 3, 4))
    native = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2),
                                        w.permute(3, 2, 0, 1), padding=3)
    ws = ts2d.s2d_conv_kernel(w)
    s2d = torch.nn.functional.conv2d(
        ts2d.space_to_depth(x).permute(0, 3, 1, 2), ws.permute(3, 2, 0, 1),
        padding=2)
    torch.testing.assert_close(
        ts2d.depth_to_space(s2d.permute(0, 2, 3, 1)),
        native.permute(0, 2, 3, 1), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# gated_conv_elu


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jconv, "_INTERPRET", True)


def _conv_inputs(seed, n, extra, b=2, h=8, w=12, c=8, co=8, k=5):
    """``n`` zero-padded (B, H+2p, W+2p+extra, C) inputs, gates, HWIO w, b."""
    rng = np.random.default_rng(seed)
    p = (k - 1) // 2
    xs = [np.pad(_normal(rng, b, h, w, c), ((0, 0), (p, p), (p, p + extra),
                                            (0, 0))) for _ in range(n)]
    gates = rng.uniform(0.2, 0.9, n).astype(np.float32)
    return xs, gates, _normal(rng, k, k, c, co, scale=0.1), _normal(rng, co), w


@pytest.mark.parametrize("extra", [0, 4])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_gated_conv_elu_plain_matches_jax_pallas_interpret(n, extra, interpret):
    xs, gates, w, b, width = _conv_inputs(40 + n, n, extra)
    got = tconv.gated_conv_elu_plain(
        [torch.from_numpy(x) for x in xs], torch.from_numpy(gates),
        torch.from_numpy(w), torch.from_numpy(b), width=width)
    want = jconv.gated_conv_elu([jnp.asarray(x) for x in xs],
                                jnp.asarray(gates), jnp.asarray(w),
                                jnp.asarray(b), width=width)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("extra", [0, 4])
@pytest.mark.parametrize("n", [1, 4])
def test_gated_conv_elu_plain_matches_jax_fallback(n, extra):
    xs, gates, w, b, width = _conv_inputs(50 + n, n, extra, k=3)
    got = tconv.gated_conv_elu_plain(
        [torch.from_numpy(x) for x in xs], torch.from_numpy(gates),
        torch.from_numpy(w), torch.from_numpy(b), width=width)
    want = jconv.gated_conv_elu([jnp.asarray(x) for x in xs],
                                jnp.asarray(gates), jnp.asarray(w),
                                jnp.asarray(b), width=width)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_gated_conv_elu_bf16_plain_rounds_once():
    """bf16: the gated sum in bf16 (each product and sum rounded), then the
    conv, bias and ELU in f32 and one rounding."""
    xs, gates, w, b, width = _conv_inputs(60, 3, 0)
    xs16 = [torch.from_numpy(x).bfloat16() for x in xs]
    w16 = torch.from_numpy(w).bfloat16()
    got = tconv.gated_conv_elu_plain(xs16, torch.from_numpy(gates), w16,
                                     torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    g = torch.from_numpy(gates).bfloat16()
    h = ((g[0] * xs16[0] + g[1] * xs16[1]) + g[2] * xs16[2]).float()
    want = tconv.gated_conv_elu_plain([h], torch.ones(1), w16.float(),
                                      torch.from_numpy(b))
    torch.testing.assert_close(got, want.bfloat16(), rtol=0, atol=0)


def test_gated_conv_elu_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    xs, gates, w, b, width = _conv_inputs(61, 2, 4)
    args = ([torch.from_numpy(x) for x in xs], torch.from_numpy(gates),
            torch.from_numpy(w), torch.from_numpy(b))
    before = tconv.gated_conv_elu.launches
    got = tconv.gated_conv_elu(*args, width=width)
    assert tconv.gated_conv_elu.launches == before
    torch.testing.assert_close(got, tconv.gated_conv_elu_plain(
        *args, width=width), rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["shapes", "gates", "bias", "width", "count"])
def test_gated_conv_elu_rejects_bad_operands(bad):
    xs, gates, w, b, width = _conv_inputs(62, 2, 0)
    xs = [torch.from_numpy(x) for x in xs]
    gates, w, b = (torch.from_numpy(a) for a in (gates, w, b))
    if bad == "shapes":
        xs[1] = xs[1][:, :-1]
    elif bad == "gates":
        gates = gates[:1]
    elif bad == "bias":
        b = b[:-1]
    elif bad == "width":
        width += 1
    else:
        xs, gates = xs * 3, torch.ones(6)
    with pytest.raises(ValueError):
        tconv.gated_conv_elu(xs, gates, w, b, width=width)
