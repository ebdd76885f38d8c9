"""The port's stereo warp against the JAX package's: the plain versions of
the ``warp_rows`` kernel pair against the Pallas kernel in interpret mode
and its VJP, the plain backward against autograd of the plain forward, and
``warp_by_disparity`` / ``reconstruct_pyramid_with_lr`` against the JAX
functions (which take the gather path on the CPU).  The grouped entry
points (``warp_rows_many``, ``warp_by_disparities``) are held to the same
references and to the one-problem calls.  Inputs from numpy seeds; the JAX
layout of ``warp_rows`` is (R, C, W), the port's (R, W, C)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_helpers  # noqa: F401  (sets the torch thread count)

from uncertainty_model_tpu.ops import reconstruct_pyramid_with_lr as jax_recon_lr
from uncertainty_model_tpu.ops import warp_by_disparity as jax_warp
from uncertainty_model_tpu.ops.pallas.warp import warp_rows as jax_warp_rows

from uncertainty_model_tpu_torch.ops import (
    reconstruct_pyramid_with_lr, warp_by_disparities, warp_by_disparity)
from uncertainty_model_tpu_torch.ops.warp_rows import (
    warp_rows, warp_rows_bwd, warp_rows_bwd_many, warp_rows_bwd_plain,
    warp_rows_fwd, warp_rows_fwd_many, warp_rows_many, warp_rows_plain)

# (R, W, C): the tiny pyramid's row counts and widths, a row count that is
# not a multiple of the Pallas kernel's 32-row block, and C = 1 / 3 / 4
SHAPES = [(64, 64, 4), (5, 32, 3), (16, 8, 1), (3, 1, 2)]
# (R, W) of a group's problems: widths 64, 512 and 1, row counts 16, 1, 5
GROUP = [(16, 64), (1, 512), (5, 1), (5, 64)]
# the group's C: the reconstruction warps (4), the uncertainty term (1), the
# evaluation (3)
GROUP_CHANNELS = [4, 1, 3]


def _rows(seed, r, w, c):
    """x with values outside [0, W) and integer values (a third of them),
    src and a cotangent."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.3 * w - 1, 1.3 * w + 1, size=(r, w)).astype(np.float32)
    integer = rng.uniform(size=(r, w)) < 1 / 3
    x[integer] = np.round(x[integer])
    x.flat[:4] = [-1.0, 0.0, w - 1.0, float(w)][:x.size]
    src = rng.normal(size=(r, w, c)).astype(np.float32)
    dout = rng.normal(size=(r, w, c)).astype(np.float32)
    return x, src, dout


def _jax_layout(a):
    return jnp.asarray(np.ascontiguousarray(np.swapaxes(a, 1, 2)))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_forward_matches_pallas_interpret(shape):
    x, src, _ = _rows(1, *shape)
    got = warp_rows_plain(torch.from_numpy(x), torch.from_numpy(src)).numpy()
    want = np.swapaxes(np.asarray(jax_warp_rows(
        jnp.asarray(x), _jax_layout(src), True)), 1, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_pallas_vjp(shape):
    """The Pallas backward builds the one-hot slope on the window
    (x - 1, x + 1]; the plain formulas give the same dx and dsrc (atol
    1e-5, the MXU contraction sums in another order)."""
    x, src, dout = _rows(2, *shape)
    _, vjp = jax.vjp(lambda a, b: jax_warp_rows(a, b, True),
                     jnp.asarray(x), _jax_layout(src))
    want_dx, want_dsrc = vjp(_jax_layout(dout))
    dx, dsrc = warp_rows_bwd_plain(torch.from_numpy(x), torch.from_numpy(src),
                                   torch.from_numpy(dout))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(dsrc.numpy(),
                               np.swapaxes(np.asarray(want_dsrc), 1, 2),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_autograd(shape):
    """The written-out backward equals autograd of the gather form (the
    same products, summed in another order: rtol/atol 1e-6)."""
    x, src, dout = _rows(3, *shape)
    xt = torch.from_numpy(x).requires_grad_()
    st = torch.from_numpy(src).requires_grad_()
    warp_rows_plain(xt, st).backward(torch.from_numpy(dout))
    dx, dsrc = warp_rows_bwd_plain(torch.from_numpy(x), torch.from_numpy(src),
                                   torch.from_numpy(dout))
    torch.testing.assert_close(dx, xt.grad, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dsrc, st.grad, rtol=1e-6, atol=1e-6)


def test_warp_rows_on_cpu_runs_the_plain_versions():
    """The autograd Function on CPU tensors: forward and backward are the
    plain versions exactly, and no kernel is launched."""
    x, src, dout = _rows(4, 8, 16, 4)
    before = (warp_rows_fwd.launches, warp_rows_bwd.launches)
    xt = torch.from_numpy(x).requires_grad_()
    st = torch.from_numpy(src).requires_grad_()
    out = warp_rows(xt, st)
    out.backward(torch.from_numpy(dout))
    assert torch.equal(out.detach(), warp_rows_plain(torch.from_numpy(x),
                                                     torch.from_numpy(src)))
    dx, dsrc = warp_rows_bwd_plain(torch.from_numpy(x), torch.from_numpy(src),
                                   torch.from_numpy(dout))
    assert torch.equal(xt.grad, dx) and torch.equal(st.grad, dsrc)
    assert (warp_rows_fwd.launches, warp_rows_bwd.launches) == before


def test_warp_rows_checks_shapes():
    with pytest.raises(ValueError):
        warp_rows_fwd(torch.zeros(4, 8), torch.zeros(4, 9, 2))
    with pytest.raises(ValueError):
        warp_rows_bwd(torch.zeros(4, 8), torch.zeros(4, 8, 2),
                      torch.zeros(4, 8, 3))


def _stereo(seed, b=2, h=32, w=64):
    rng = np.random.default_rng(seed)
    disp = rng.uniform(0.0, 0.3, size=(b, h, w, 4)).astype(np.float32)
    images = rng.uniform(size=(b, h, w, 6)).astype(np.float32)
    return disp, images


@pytest.mark.parametrize("c", [1, 3, 4])
def test_warp_by_disparity_matches_jax(c):
    """Value (atol 1e-6) and the gradient in the disparity and the source
    of ``sum(warp * cotangent)`` (rtol 1e-6, atol 1e-5: the disparity
    gradient is W times the pixel slope, so it reaches tens)."""
    rng = np.random.default_rng(5)
    disp = rng.uniform(-0.4, 0.4, size=(2, 16, 32, 1)).astype(np.float32)
    src = rng.normal(size=(2, 16, 32, c)).astype(np.float32)
    cot = rng.normal(size=(2, 16, 32, c)).astype(np.float32)

    want, vjp = jax.vjp(jax_warp, jnp.asarray(disp), jnp.asarray(src))
    want_dd, want_ds = vjp(jnp.asarray(cot))
    dt = torch.from_numpy(disp).requires_grad_()
    st = torch.from_numpy(src).requires_grad_()
    got = warp_by_disparity(dt, st)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(dt.grad.numpy(), np.asarray(want_dd),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(want_ds),
                               rtol=1e-6, atol=1e-5)


def test_reconstruct_pyramid_with_lr_matches_jax():
    """The tiny config's 4-scale pyramid (32x64 down to 4x8), atol 1e-6."""
    levels = [_stereo(10 + i, h=32 >> i, w=64 >> i) for i in range(4)]
    disps = [d for d, _ in levels]
    pyramid = [im for _, im in levels]
    want_recon, want_lr = jax_recon_lr([jnp.asarray(d) for d in disps],
                                       [jnp.asarray(p) for p in pyramid])
    recon, lr = reconstruct_pyramid_with_lr(
        [torch.from_numpy(d) for d in disps],
        [torch.from_numpy(p) for p in pyramid])
    for got, want in zip(recon + lr, list(want_recon) + list(want_lr)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)


def _group(seed, c):
    """The ``GROUP`` problems at C = ``c`` as torch tensors: (xs, srcs,
    douts)."""
    rows = [_rows(seed + i, r, w, c) for i, (r, w) in enumerate(GROUP)]
    return tuple([torch.from_numpy(p[k]) for p in rows] for k in range(3))


@pytest.mark.parametrize("c", GROUP_CHANNELS)
def test_grouped_plain_matches_pallas(c):
    """The grouped entry points on CPU tensors, problem by problem, against
    the Pallas kernel in interpret mode and its VJP (atol 1e-5, as the
    one-problem tests)."""
    xs, srcs, douts = _group(20, c)
    outs = warp_rows_fwd_many(xs, srcs)
    dxs, dsrcs = warp_rows_bwd_many(xs, srcs, douts)
    for x, src, dout, out, dx, dsrc in zip(xs, srcs, douts, outs, dxs, dsrcs):
        want, vjp = jax.vjp(lambda a, b: jax_warp_rows(a, b, True),
                            jnp.asarray(x.numpy()), _jax_layout(src.numpy()))
        want_dx, want_dsrc = vjp(_jax_layout(dout.numpy()))
        np.testing.assert_allclose(out.numpy(),
                                   np.swapaxes(np.asarray(want), 1, 2),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(dsrc.numpy(),
                                   np.swapaxes(np.asarray(want_dsrc), 1, 2),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("c", GROUP_CHANNELS)
@pytest.mark.parametrize("used", ["all", "first"])
def test_grouped_autograd_equals_single_calls(c, used):
    """``warp_rows_many`` on CPU tensors gives each problem's ``out``,
    ``dx`` and ``dsrc`` exactly as a one-problem ``warp_rows`` call; an
    output that receives no gradient gives zeros (``used="first"``), and
    no kernel is launched."""
    xs, srcs, douts = _group(30, c)
    before = (warp_rows_fwd.launches, warp_rows_bwd.launches)
    n = len(xs) if used == "all" else 1

    def run(group):
        xg = [x.clone().requires_grad_() for x in xs]
        sg = [s.clone().requires_grad_() for s in srcs]
        outs = (warp_rows_many(xg, sg) if group else
                [warp_rows(x, s) for x, s in zip(xg, sg)])
        torch.autograd.backward(outs[:n], douts[:n])
        return ([o.detach() for o in outs],
                [x.grad if x.grad is not None else torch.zeros_like(x)
                 for x in xg],
                [s.grad if s.grad is not None else torch.zeros_like(s)
                 for s in sg])

    for got, want in zip(run(True), run(False)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    _, dxs, dsrcs = run(True)
    assert not any(d.any() for d in dxs[n:] + dsrcs[n:])
    assert (warp_rows_fwd.launches, warp_rows_bwd.launches) == before


@pytest.mark.parametrize("case", ["channels", "lengths", "devices", "empty"])
def test_grouped_entry_checks_its_group(case):
    """One C for the group, as many x as src, one device, at least one
    problem."""
    x, src = torch.zeros(4, 8), torch.zeros(4, 8, 2)
    xs, srcs = {
        "channels": ([x, x], [src, torch.zeros(4, 8, 3)]),
        "lengths": ([x, x], [src]),
        "devices": ([x, x.to("meta")], [src, src.to("meta")]),
        "empty": ([], []),
    }[case]
    with pytest.raises(ValueError):
        warp_rows_fwd_many(xs, srcs)


@pytest.mark.parametrize("c", GROUP_CHANNELS)
def test_warp_by_disparities_matches_jax(c):
    """Each pair of a group of three (two image sizes) against the JAX
    ``warp_by_disparity``: value atol 1e-6, the source gradient rtol 1e-6,
    atol 1e-5 (as ``warp_by_disparity``'s test).  The disparity gradient is
    W times a sum over C of products, which the two frameworks sum in other
    orders; where that sum cancels, the difference is a few ulps of its
    largest terms (read: up to 3.1e-5 at values of 300-400), so it is held
    within 1e-6 of the gradient's largest magnitude."""
    rng = np.random.default_rng(40 + c)
    shapes = [(2, 16, 32), (1, 8, 16), (2, 16, 32)]
    disps = [rng.uniform(-0.4, 0.4, size=(*s, 1)).astype(np.float32)
             for s in shapes]
    srcs = [rng.normal(size=(*s, c)).astype(np.float32) for s in shapes]
    cots = [rng.normal(size=(*s, c)).astype(np.float32) for s in shapes]
    dt = [torch.from_numpy(d).requires_grad_() for d in disps]
    st = [torch.from_numpy(s).requires_grad_() for s in srcs]
    got = warp_by_disparities(dt, st)
    torch.autograd.backward(got, [torch.from_numpy(t) for t in cots])
    for i in range(len(shapes)):
        want, vjp = jax.vjp(jax_warp, jnp.asarray(disps[i]),
                            jnp.asarray(srcs[i]))
        want_dd, want_ds = vjp(jnp.asarray(cots[i]))
        np.testing.assert_allclose(got[i].detach().numpy(), np.asarray(want),
                                   rtol=0, atol=1e-6)
        want_dd = np.asarray(want_dd)
        np.testing.assert_allclose(dt[i].grad.numpy(), want_dd, rtol=0,
                                   atol=1e-6 * np.abs(want_dd).max())
        np.testing.assert_allclose(st[i].grad.numpy(), np.asarray(want_ds),
                                   rtol=1e-6, atol=1e-5)
