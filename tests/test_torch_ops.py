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
from uncertainty_model_tpu_torch.config import FLAGSHIP_INPUT, FLAGSHIP_MODEL
from uncertainty_model_tpu_torch.models.layers import SMAX
from uncertainty_model_tpu_torch.ops.attend import (
    THREADS, attend, attend_plain, context_threads, plan_attend)
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


# every (keys', queries') softmax formulation pair; None: the keys take smax's
SMAX_PAIRS = [(k, q) for k in (None, *SMAX) for q in SMAX]


def _attend_operands(seed, b, n, c, dtype=torch.float32):
    """Keys, queries and values (B, N, C): the keys' logits rise along the
    tokens, so that an online softmax's running max moves again and
    again."""
    rng = np.random.default_rng(seed)
    k = 3 * rng.normal(size=(b, n, c)) + np.linspace(0, 4, n)[None, :, None]
    q = 3 * rng.normal(size=(b, n, c))
    v = rng.normal(size=(b, n, c))
    return [torch.from_numpy(a.astype(np.float32)).to(dtype)
            for a in (k, q, v)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("keys_smax,smax", SMAX_PAIRS)
def test_attend_on_cpu_is_plain(keys_smax, smax, dtype):
    """On the CPU ``attend`` is ``attend_plain`` bit for bit, launches
    nothing, and refuses unequal maps and unknown formulations."""
    keys, queries, values = _attend_operands(
        8, 2, 37, 16, getattr(torch, dtype))
    before = attend.launches
    got = attend(keys, queries, values, 4, smax, keys_smax)
    assert attend.launches == before
    assert torch.equal(got, attend_plain(keys, queries, values, 4, smax,
                                         keys_smax))
    with pytest.raises(ValueError, match="token maps"):
        attend(keys, queries[:, 1:], values, 4, smax, keys_smax)
    with pytest.raises(ValueError, match="formulations"):
        attend(keys, queries, values, 4, "max", keys_smax)


def _merge(states, keys_max):
    """Online-softmax states ``(m, s, acc)`` of disjoint token sets ->
    theirs together: each rescaled to the common max (0 without one)."""
    if keys_max:
        top = torch.stack([m for m, _, _ in states]).amax(0)
    else:
        top = torch.zeros_like(states[0][0])
    s = sum(s * torch.exp(m - top) for m, s, _ in states)
    acc = sum(a * torch.exp(m - top)[..., None] for m, _, a in states)
    return top, s, acc


def _attend_as_the_kernel(keys, queries, values, heads, smax, keys_smax,
                          chunk, lanes):
    """``csrc/attend.cu``'s algorithm in plain PyTorch: each chunk of
    ``chunk`` tokens cut among ``lanes`` lanes (a lane every lanes-th
    token, four at a time, its running max, sum and context rescaled when
    the max rises), the lanes merged, the chunks' partials rescaled to the
    global max and summed; the context normalised; the queries' softmax
    and the product, token by token."""
    b, n, c = keys.shape
    d = c // heads
    keys_max = (keys_smax or smax) != "nomax"
    kh, vh = (t.reshape(b, n, heads, d) for t in (keys, values))
    parts = []
    for n0 in range(0, n, chunk):
        states = []
        for lane in range(lanes):
            m = torch.full((b, heads, d), -np.inf if keys_max else 0.0)
            s = torch.zeros(b, heads, d)
            acc = torch.zeros(b, heads, d, d)
            tokens = torch.arange(n0 + lane, min(n, n0 + chunk), lanes)
            for at in range(0, len(tokens), 4):
                step = tokens[at:at + 4]
                x = kh[:, step]
                if keys_max:
                    top = torch.maximum(m, x.amax(1))
                    s = s * torch.exp(m - top)
                    acc = acc * torch.exp(m - top)[..., None]
                    m = top
                e = torch.exp(x - m[:, None])
                s = s + e.sum(1)
                acc = acc + torch.einsum("buhk,buhv->bhkv", e, vh[:, step])
            states.append((m, s, acc))
        parts.append(_merge(states, keys_max))
    _, s, acc = _merge(parts, keys_max)
    context = acc / s[..., None]
    q = queries.reshape(b, n, heads, d)
    if smax != "nomax":
        q = q - q.amax(-1, keepdim=True)
    e = torch.exp(q)
    w = e * (1 / e.sum(-1, keepdim=True))
    return torch.einsum("bnhk,bhkv->bnhv", w, context).reshape(b, n, c)


@pytest.mark.parametrize("keys_smax,smax", SMAX_PAIRS)
@pytest.mark.parametrize("d,heads,n,chunk", [
    (4, 8, 1001, 96),    # enc0's heads: 32 lanes, the last chunk 41 tokens
    (64, 2, 203, 64),    # enc4's width: 2 lanes, the last chunk 11 tokens
], ids=["d4", "d64"])
def test_attend_kernel_algorithm_matches_plain(d, heads, n, chunk, keys_smax,
                                               smax):
    """The kernel's online softmax over ragged chunks and lanes, its
    rescaled combine and its apply equal ``attend_plain`` in f32 (1e-5):
    the keys' softmax over all the tokens, exactly but for rounding."""
    keys, queries, values = _attend_operands(9, 2, n, d * heads)
    group = plan_attend(2, n, heads, d, 132).group
    lanes = THREADS // (group * context_threads(d))
    assert n % chunk and n > chunk
    got = _attend_as_the_kernel(keys, queries, values, heads, smax,
                                keys_smax, chunk, lanes)
    torch.testing.assert_close(
        got, attend_plain(keys, queries, values, heads, smax, keys_smax),
        rtol=1e-5, atol=1e-5)


# the flagship's encoder attention at 256x512: (tokens, heads, d) of
# enc0-enc4
FLAGSHIP_ATTENTION = [
    ((FLAGSHIP_INPUT[0] >> (i + 1)) * (FLAGSHIP_INPUT[1] >> (i + 1)),
     layer["heads"], layer["out_channels"] // layer["heads"])
    for i, layer in enumerate(FLAGSHIP_MODEL["encoder"]["layers"])]


@pytest.mark.parametrize("batch", [1, 128])
def test_plan_attend_covers_the_tokens(batch):
    """The cut of each flagship stage on a 132-SM card: a block's heads
    divide the heads and fit its threads, the chunks and apply blocks
    cover the tokens, each lane takes at least 8 tokens where the image
    takes more than one chunk, and a single image is cut finely enough for
    the card (enc0 at b1: 128 chunks)."""
    for n, heads, d in FLAGSHIP_ATTENTION:
        group, chunk, block = plan_attend(batch, n, heads, d, 132)
        assert heads % group == 0
        assert THREADS % (group * context_threads(d)) == 0
        lanes = THREADS // (group * context_threads(d))
        for size in (chunk, block):
            assert 1 <= size <= n
        if chunk < n:
            assert chunk >= 8 * lanes
        if batch == 128 and d == 64:
            assert (chunk, block) == (n, n)
    assert plan_attend(1, 32768, 8, 4, 132).chunk == 32768 // 128


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
