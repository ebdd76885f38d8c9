"""The PyTorch port's numerics ops and graph loader against the JAX
package's (f32, same inputs from a numpy seed)."""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

import torch_port_helpers  # noqa: F401  (sets the torch thread count)

from uncertainty_model_tpu.models.graph import load_graph_spec as jax_load_graph
from uncertainty_model_tpu.models.graph import resolve_stage_graph as jax_resolve
from uncertainty_model_tpu.ops import avg_pool2d as jax_avg_pool2d
from uncertainty_model_tpu.ops import global_avg_pool as jax_global_avg_pool
from uncertainty_model_tpu.ops import pad2d as jax_pad2d
from uncertainty_model_tpu.ops import pixel_shuffle as jax_pixel_shuffle
from uncertainty_model_tpu.ops import resize_bilinear as jax_resize
from uncertainty_model_tpu.ops import scale_pyramid as jax_scale_pyramid
from uncertainty_model_tpu.ops.pallas.decoder_fused import (
    _shuffle_phase_major as jax_shuffle_phase_major)
from uncertainty_model_tpu.ops.resize import _lerp_coeffs as jax_lerp_coeffs

from uncertainty_model_tpu_torch.models.graph import (
    load_graph_spec, resolve_stage_graph)
from uncertainty_model_tpu_torch.ops import (
    avg_pool2d, global_avg_pool, pad2d, pixel_shuffle, reflect_pad2d,
    resize_bilinear, scale_pyramid, shuffle_phase_major)
from uncertainty_model_tpu_torch.ops.pad import reflect_pad, reflect_pad_plain
from uncertainty_model_tpu_torch.ops.resize import _lerp_coeffs, lerp_taps


def _normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("out_size,in_size",
                         [(16, 8), (512, 256), (2, 1), (1, 5), (12, 5), (3, 7)])
def test_lerp_coeffs_bit_for_bit(out_size, in_size):
    for a, b in zip(_lerp_coeffs(out_size, in_size),
                    jax_lerp_coeffs(out_size, in_size)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape,size", [
    ((2, 8, 16, 3), (16, 32)),    # 2x: shift-lerp form
    ((1, 4, 6, 5), (8, 12)),
    ((2, 1, 2, 4), (2, 4)),       # 1-pixel source rows
    ((2, 5, 7, 3), (12, 20)),     # general sizes: gather-lerp form
    ((1, 9, 10, 2), (4, 5)),      # downsample
])
def test_resize_bilinear_matches_jax(shape, size):
    x = _normal(0, shape)
    got = resize_bilinear(torch.from_numpy(x), size).numpy()
    want = np.asarray(jax_resize(jnp.asarray(x), size))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("h2,w2", [(8, 16), (1, 3), (32, 64)])
def test_lerp_taps_reproduce_resize(h2, w2):
    """The tap tables the CUDA assemble_z kernel reads give, with the
    kernel's separately rounded f32 lerps (rows first, then columns),
    exactly the port's 2x resize."""
    x = _normal(1, (h2, w2))
    ylo, yhi, yf = lerp_taps(2 * h2, h2)
    xlo, xhi, xf = lerp_taps(2 * w2, w2)

    def lerp(a, b, w):
        return (a + (w * (b - a)).astype(np.float32)).astype(np.float32)

    rows = lerp(x[ylo], x[yhi], yf[:, None])
    got = lerp(rows[:, xlo], rows[:, xhi], xf[None, :])
    want = resize_bilinear(torch.from_numpy(x[None, :, :, None]),
                           (2 * h2, 2 * w2))[0, :, :, 0].numpy()
    np.testing.assert_array_equal(got, want)


def test_pixel_shuffle_matches_jax():
    x = _normal(2, (2, 3, 5, 4 * 6))
    got = pixel_shuffle(torch.from_numpy(x), 2).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_pixel_shuffle(jnp.asarray(x), 2)))
    # torch channel order: the NCHW op agrees
    nchw = torch.nn.functional.pixel_shuffle(
        torch.from_numpy(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, nchw)


def test_shuffle_phase_major_matches_jax():
    x = _normal(3, (2, 3, 5, 4 * 6))
    got = shuffle_phase_major(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_shuffle_phase_major(jnp.asarray(x))))


REFLECT_CASES = [
    ((2, 5, 7, 3), (1, 1, 1, 1)),
    ((2, 1, 2, 3), (1, 1, 1, 1)),   # size-1 H: torch's reflect pad raises
    ((1, 3, 4, 2), (2, 1, 0, 2)),   # asymmetric
    ((1, 2, 3, 2), (3, 3, 2, 2)),   # pad wider than the dim: numpy's rule
]


@pytest.mark.parametrize("shape,padding", REFLECT_CASES)
def test_reflect_pad_matches_jax(shape, padding):
    x = _normal(4, shape)
    got = reflect_pad2d(torch.from_numpy(x), padding).numpy()
    want = np.asarray(jax_pad2d(jnp.asarray(x), padding, mode="reflect"))
    np.testing.assert_array_equal(got, want)


# reflect_pad at test_reflect_pad_matches_jax's shapes, and a channel count
# that is already a multiple of 8 (no zero channels)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scaled", [False, True], ids=["plain", "scaled"])
@pytest.mark.parametrize("shape", [s for s, _ in REFLECT_CASES]
                         + [(2, 3, 4, 8)])
def test_reflect_pad_plain_is_gather_product_zero_channels(shape, scaled,
                                                           dtype):
    """The plain version (the CPU's path through ``reflect_pad``) is the
    gather, then the product in ``x``'s type, then zero channels up to a
    multiple of 8, exactly; the CPU launches no kernel."""
    dt = getattr(torch, dtype)
    x = torch.from_numpy(_normal(5, shape)).to(dt)
    scale = (torch.from_numpy(_normal(6, (shape[0], shape[-1]))).to(dt)
             if scaled else None)
    want = reflect_pad2d(x, (1, 1, 1, 1))
    if scaled:
        want = want * scale[:, None, None, :]
    c = shape[-1]
    want = F.pad(want, (0, -(-c // 8) * 8 - c))
    before = reflect_pad.launches
    for got in (reflect_pad_plain(x, scale), reflect_pad(x, scale)):
        assert got.dtype == dt and got.shape[-1] % 8 == 0
        assert torch.equal(got, want)
    assert reflect_pad.launches == before
    with pytest.raises(ValueError, match="scale"):
        reflect_pad(x, torch.ones(shape[0], c + 1, dtype=dt))


@pytest.mark.parametrize("stage", [1, 2, 3, 4, 5])
def test_graph_loader_matches_jax(stage):
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        f"graphs/nodes_5_seed_42/stage_{stage}.json")
    port, ref = load_graph_spec(path), jax_load_graph(path)
    assert tuple(tuple(n) for n in port.nodes) == tuple(tuple(n) for n in ref.nodes)
    assert (port.in_nodes, port.out_nodes) == (ref.in_nodes, ref.out_nodes)


@pytest.mark.parametrize("stage", [1, 3])
def test_built_graph_matches_jax(stage):
    """Without a graph directory both sides build the same Watts-Strogatz
    graph from ``stage * seed``, neighbour order included."""
    port = resolve_stage_graph(stage, seed=42)
    ref = jax_resolve(stage, seed=42)
    assert tuple(tuple(n) for n in port.nodes) == tuple(tuple(n) for n in ref.nodes)


@pytest.mark.parametrize("shape,k", [
    ((2, 8, 10, 3), 3), ((1, 12, 13, 30), 3), ((2, 11, 11, 2), 11),
    ((1, 3, 5, 4), 3)])
def test_avg_pool2d_matches_jax(shape, k):
    """Valid stride-1 pooling; the window sums are taken in another order
    (rtol 1e-6)."""
    x = _normal(5, shape)
    got = avg_pool2d(torch.from_numpy(x), k).numpy()
    want = np.asarray(jax_avg_pool2d(jnp.asarray(x), k, 1))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        global_avg_pool(torch.from_numpy(x)).numpy(),
        np.asarray(jax_global_avg_pool(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mode", ["zeros", "replicate", "reflect"])
@pytest.mark.parametrize("padding", [(0, 1, 0, 0), (0, 0, 0, 1), (2, 1, 3, 0)])
def test_pad2d_matches_jax(mode, padding):
    x = _normal(6, (2, 4, 5, 3))
    got = pad2d(torch.from_numpy(x), padding, mode).numpy()
    want = np.asarray(jax_pad2d(jnp.asarray(x), padding, mode=mode))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(2, 32, 64, 6), (1, 24, 40, 3)])
def test_scale_pyramid_matches_jax(shape):
    x = _normal(7, shape)
    got = scale_pyramid(torch.from_numpy(x), 4)
    want = jax_scale_pyramid(jnp.asarray(x), 4)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
