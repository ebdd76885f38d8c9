"""The port's bf16 align-corners resize against the JAX package's, bit for
bit: both weight the two taps by bf16(1 - frac) and bf16(frac), sum the
products in f32 and round to bf16 once per axis (the JAX package as a
contraction with its interpolation matrix in bf16).  f32 keeps the exact
fractions.

Inputs come from a numpy seed and are shared by both sides as numpy
arrays."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_port_helpers  # noqa: F401  (sets the torch thread count)

from uncertainty_model_tpu.ops.resize import _interp_matrix
from uncertainty_model_tpu.ops.resize import resize_bilinear as jax_resize

from uncertainty_model_tpu_torch.ops.resize import (
    bf16_weights, lerp_taps, resize_bf16_weights, resize_bilinear)

# (input NHWC, output size): the unfused decoder's 2x sites of the tiny
# config (stages 0-1: the SE skip features and the disparity) and of the
# flagship (stage 0: 8x16x512, stage 1: 16x32x256), a 1-pixel source, a
# general scale and a downsample
SHAPES = {
    "tiny_dec0_skip": ((2, 1, 2, 32), (2, 4)),
    "tiny_dec1_skip": ((2, 2, 4, 16), (4, 8)),
    "tiny_dec1_disp": ((2, 2, 4, 4), (4, 8)),
    "flagship_dec0_skip": ((1, 8, 16, 512), (16, 32)),
    "flagship_dec1_skip": ((2, 16, 32, 256), (32, 64)),
    "general": ((2, 5, 7, 3), (12, 20)),
    "downsample": ((1, 9, 10, 2), (4, 5)),
}


def _normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_bf16_resize_equals_jax_bit_for_bit(case):
    shape, size = SHAPES[case]
    x = torch.from_numpy(_normal(1, shape)).bfloat16()
    got = resize_bilinear(x, size)
    want = jax_resize(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), size)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_f32_resize_keeps_exact_fractions(case):
    """f32: the lerp x[lo] + frac (x[hi] - x[lo]) of ``lerp_taps`` (for a
    2x resize; ``_lerp_coeffs`` otherwise), bit for bit, as before the bf16
    form; the JAX package's within its own f32 tests' 1e-6."""
    shape, size = SHAPES[case]
    x = _normal(2, shape)
    got = resize_bilinear(torch.from_numpy(x), size).numpy()
    want = x
    for axis, out in zip((1, 2), size):
        if want.shape[axis] == out:
            continue
        lo, hi, frac = lerp_taps(out, want.shape[axis])
        bshape = [1, 1, 1, 1]
        bshape[axis] = out
        a, b = np.take(want, lo, axis), np.take(want, hi, axis)
        want = a + frac.reshape(bshape) * (b - a)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(
        got, np.asarray(jax_resize(jnp.asarray(x), size)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("out_size,in_size",
                         [(4, 2), (16, 8), (64, 32), (512, 256), (2, 1),
                          (12, 5), (4, 9)])
def test_bf16_weights_are_the_jax_interp_matrix_in_bf16(out_size, in_size):
    lo, hi, w_lo, w_hi = bf16_weights(out_size, in_size)
    m = np.asarray(jnp.asarray(_interp_matrix(out_size, in_size),
                               jnp.bfloat16).astype(jnp.float32))
    rows = np.arange(out_size)
    two = lo != hi
    np.testing.assert_array_equal(m[rows[two], lo[two]], w_lo[two])
    np.testing.assert_array_equal(m[rows[two], hi[two]], w_hi[two])
    # a repeated tap (a 1-pixel source) carries the rounded sum
    np.testing.assert_array_equal(m[rows[~two], lo[~two]],
                                  w_lo[~two] + w_hi[~two])


def test_glue_upsample_rounds_once():
    """``resize_bf16_weights`` is the bf16 form in f32, not rounded between
    or after the axes; rounding it after each axis gives the bf16 resize."""
    x = torch.from_numpy(_normal(3, (2, 8, 16, 4))).bfloat16()
    once = resize_bf16_weights(x, (16, 32))
    assert once.dtype == torch.float32
    per_axis = resize_bilinear(
        resize_bilinear(x, (16, 16)), (16, 32))
    assert torch.equal(resize_bilinear(x, (16, 32)), per_axis)
    assert not torch.equal(once.bfloat16(), per_axis)
