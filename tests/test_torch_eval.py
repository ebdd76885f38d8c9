"""The port's evaluation against the JAX package's: gaussian SSIM, the
sparsification curves and AUSE/AURG, one ``eval_step`` and
``evaluate_model`` on the tiny config (``torch_port_helpers.PORT_MODEL``,
32x64) from the same converted weights, and the comparison images (the
inferno colour map and the PNG writer the port keeps in place of
matplotlib and PIL).  Also the progress output where ``tqdm`` is not
installed.

Inputs come from a numpy seed and are shared by both sides as numpy arrays;
the JAX random curve's uniform draw is handed to the port as its noise.
"""

import os
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tiny_config import TINY_INPUT, TINY_LOSS
from torch_port_helpers import PORT_MODEL, models as build_models, port_model

from uncertainty_model_tpu.train import metrics as jmetrics
from uncertainty_model_tpu.train import sparsification as jspars
from uncertainty_model_tpu.train.evaluate import _eval_step
from uncertainty_model_tpu.train.evaluate import evaluate_model as jax_evaluate
from uncertainty_model_tpu.utils import viz as jviz

from uncertainty_model_tpu_torch.ops import resize_bilinear
from uncertainty_model_tpu_torch.ops.warp_rows import warp_rows_fwd
from uncertainty_model_tpu_torch.train import Trainer, eval_step, evaluate_model
from uncertainty_model_tpu_torch.train import metrics, sparsification as spars
from uncertainty_model_tpu_torch.utils import viz

SCALE = 0.7
# The JAX reference's own jitted and eager runs of one eval step differ by
# up to 1.6e-6 in AUSE and 1.3e-6 in AURG (XLA fuses the warp's coordinate
# arithmetic into an FMA under jit, which moves the reconstruction by up to
# 4e-6), and the port's disparities differ from the JAX model's by ~1e-7
# (the convs' summation order), which moves the warp's x by ~6e-6 pixels.
# So SSIM sums are held relatively, and AUSE and AURG, which average
# differences of curves near 1, absolutely.
SSIM_RTOL = 5e-5
SPARS_ATOL = 5e-6


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, JAX variables, the port's eval model) of the tiny
    config."""
    return build_models("fc")


def _stereo(seed, b=2):
    """A smooth left view (bilinear from a 5x9 grid) and a right view
    shifted by 2 pixels with a little noise, so the reconstructions are
    meaningful and SSIM is not near 0."""
    rng = np.random.default_rng(seed)
    low = torch.from_numpy(rng.uniform(size=(b, 5, 9, 3)).astype(np.float32))
    left = resize_bilinear(low, TINY_INPUT).numpy()
    right = (np.roll(left, 2, axis=2) * 0.9 + 0.05
             + 0.02 * rng.uniform(size=left.shape)).astype(np.float32)
    return {"left": left, "right": right}


@pytest.mark.parametrize("shape", [(2, 20, 30, 3), (1, 32, 64, 6)])
def test_gaussian_ssim_matches_jax(shape):
    rng = np.random.default_rng(shape[1])
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=shape), 0, 1).astype(np.float32)
    got = metrics.gaussian_ssim(torch.from_numpy(a), torch.from_numpy(b))
    want = jmetrics.gaussian_ssim(jnp.asarray(a), jnp.asarray(b))
    assert got.shape == (shape[0],)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def _curve_inputs(case):
    """(oracle error, predicted uncertainty, kernel size, curve atol)."""
    rng = np.random.default_rng(7)
    shape = (2, 24, 32, 2)
    e = rng.uniform(size=shape).astype(np.float32)
    u = rng.uniform(size=shape).astype(np.float32)
    ties = (np.round(u * 4) / 4).astype(np.float32)
    if case == "dyadic_ties_k1":
        # every sum exact in any order: the curves agree to the divisions'
        # last bit
        return (np.round(e * 64) / 64).astype(np.float32), ties, 1, 1e-6
    # the pooled values equal the JAX package's bit for bit, but its
    # cumulative sum (a reduce-window) and torch's sequential one round
    # differently: up to ~2 ulp of a running total of a few hundred,
    # divided by the few pixels left at the curve's last steps
    return e, ties if case == "ties_k11" else u, 11, 2e-5


@pytest.mark.parametrize("case", ["dyadic_ties_k1", "random_k11", "ties_k11"])
def test_curves_ause_aurg_match_jax(case):
    """The three curves and AUSE/AURG of them; AUSE and AURG at 1e-6 in
    every case, the curves as ``_curve_inputs`` says."""
    e, u, k, atol = _curve_inputs(case)
    noise = np.random.default_rng(8).uniform(size=e.shape).astype(np.float32)
    te, tu, tn = map(torch.from_numpy, (e, u, noise))
    je, ju, jn = map(jnp.asarray, (e, u, noise))
    got = [spars.curve(te, te, k), spars.curve(te, tu, k),
           spars.curve(te, tn, k)]
    want = [jspars.curve(je, je, k), jspars.curve(je, ju, k),
            jspars.curve(je, jn, k)]
    for g, w in zip(got, want):
        assert g.shape == (100,)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=atol)
    np.testing.assert_allclose(spars.ause(got[0], got[1]).item(),
                               float(jspars.ause(want[0], want[1])), atol=1e-6)
    np.testing.assert_allclose(spars.aurg(got[1], got[2]).item(),
                               float(jspars.aurg(want[1], want[2])), atol=1e-6)


def test_curve_sort_is_stable():
    """All-tied uncertainties keep the pixels' order, as ``jnp.argsort``
    does: the same curve as a strictly decreasing ramp in that order."""
    e = torch.from_numpy(np.random.default_rng(9).uniform(
        size=(2, 20, 24, 2)).astype(np.float32))
    tied = torch.full_like(e, 0.25)
    ramp = -torch.arange(20 * 24, dtype=torch.float32).reshape(1, 20, 24, 1)
    torch.testing.assert_close(spars.curve(e, tied),
                               spars.curve(e, ramp.expand_as(e)), rtol=0,
                               atol=0)


def test_random_curve_draws_from_the_generator():
    e = torch.from_numpy(np.random.default_rng(10).uniform(
        size=(2, 16, 16, 2)).astype(np.float32))
    got = spars.random_curve(e, torch.Generator().manual_seed(3))
    noise = torch.rand(e.shape, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(got, spars.curve(e, noise), rtol=0, atol=0)
    with pytest.raises(ValueError):
        spars.ause(got, got[:50])


def test_eval_step_matches_jax(tiny):
    """One eval step against the JAX package's jitted ``_eval_step`` with
    the same weights, images and uniform draw: the summed SSIM of each view
    within ``SSIM_RTOL``, AUSE and AURG within ``SPARS_ATOL`` (see their
    definition), two ``warp_rows`` calls and no launch on the CPU."""
    jmodel, variables, model = tiny
    for seed in (5, 6):
        batch = _stereo(seed)
        key = jax.random.PRNGKey(seed)
        want, want_viz = _eval_step(
            jmodel, variables, {k: jnp.asarray(v) for k, v in batch.items()},
            jnp.float32(SCALE), key)
        noise = np.array(jax.random.uniform(key, want_viz["error"].shape,
                                            jnp.float32))
        before = warp_rows_fwd.launches
        got, got_viz = eval_step(model, batch, SCALE, torch.from_numpy(noise))
        assert warp_rows_fwd.launches == before
        for key_ in ("left_ssim", "right_ssim"):
            np.testing.assert_allclose(got[key_].item(), float(want[key_]),
                                       rtol=SSIM_RTOL)
        for key_ in ("ause", "aurg"):
            np.testing.assert_allclose(got[key_].item(), float(want[key_]),
                                       rtol=0, atol=SPARS_ATOL)
        for key_, value in want_viz.items():
            assert got_viz[key_].shape == value.shape, key_
        np.testing.assert_allclose(got_viz["disparity"].numpy(),
                                   np.asarray(want_viz["disparity"]),
                                   rtol=1e-5, atol=1e-6)


def test_evaluate_model_matches_jax(tiny, tmp_path):
    """Two batches: the per-image SSIM and per-batch AUSE averages against
    the JAX ``evaluate_model`` (AURG draws other noise and is only finite);
    the first batch's three comparison PNGs are written."""
    jmodel, variables, model = tiny
    loader = [_stereo(20), _stereo(21)]
    state = types.SimpleNamespace(params=variables["params"],
                                  batch_stats=variables["batch_stats"])
    (jl, jr), (ja, _) = jax_evaluate(jmodel, state, loader, scale=SCALE,
                                     no_pbar=True)
    (left, right), (ause, aurg) = evaluate_model(
        model, loader, save_evaluation_to=str(tmp_path), scale=SCALE,
        no_pbar=True)
    np.testing.assert_allclose([left, right], [jl, jr], rtol=SSIM_RTOL)
    np.testing.assert_allclose(ause, ja, rtol=0, atol=SPARS_ATOL)
    assert np.isfinite(aurg)
    assert sorted(os.listdir(tmp_path / "final")) == [
        "disparity.png", "prediction.png", "uncertainty.png"]


def test_to_heatmap_equals_matplotlib_inferno():
    """The port's table and index rule against matplotlib's colour map, in
    f32 and f64, with 0, 1, the last value under 1, out-of-range and NaN
    inputs; ``inverse`` too."""
    plt = pytest.importorskip("matplotlib.pyplot")
    cmap = plt.get_cmap("inferno")
    rng = np.random.default_rng(11)
    for dtype in (np.float32, np.float64):
        x = rng.uniform(-0.2, 1.2, size=(13, 17)).astype(dtype)
        x[0, :6] = [0.0, 1.0, np.nan, np.nextafter(dtype(1), dtype(0)),
                    1 / 256, -1e-9]
        np.testing.assert_array_equal(viz.to_heatmap(x),
                                      cmap(x)[..., :3].astype(np.float32))
        np.testing.assert_array_equal(
            viz.to_heatmap(x[..., None], inverse=True),
            cmap(1 - x)[..., :3].astype(np.float32))


def test_save_image_decodes_to_the_jax_package_pixels(tmp_path):
    """The port's PNG writer against the JAX package's PIL writer: the
    decoded pixels are equal (values outside [0, 1] clipped in both)."""
    image_mod = pytest.importorskip("PIL.Image")
    img = np.random.default_rng(12).uniform(-0.1, 1.1, (9, 14, 3)).astype(
        np.float32)
    viz.save_image(img, str(tmp_path / "port.png"))
    jviz.save_image(img, str(tmp_path / "jax.png"))
    got = image_mod.open(tmp_path / "port.png")
    assert got.mode == "RGB" and got.size == (14, 9)
    np.testing.assert_array_equal(
        np.asarray(got), np.asarray(image_mod.open(tmp_path / "jax.png")))


def test_comparison_grid_equals_jax():
    """``get_comparison`` (heatmaps, scaled panels, image panels, grid
    tiling) and ``combine_disparity`` equal the JAX package's."""
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(13)
    image = rng.uniform(size=(8, 12, 6)).astype(np.float32)
    pred = rng.uniform(size=(8, 12, 2)).astype(np.float32)
    for extra, scaled in ((None, False), (pred * 0.5, True), (image, True)):
        np.testing.assert_array_equal(
            viz.get_comparison(image, pred, extra, add_scaled=scaled),
            jviz.get_comparison(image, pred, extra, add_scaled=scaled))
    np.testing.assert_array_equal(
        viz.combine_disparity(pred[..., 0], pred[..., 1]),
        jviz.combine_disparity(pred[..., 0], pred[..., 1]))


def test_default_calls_run_without_tqdm(tiny, monkeypatch, capsys):
    """Where ``tqdm`` cannot be imported, ``train_model`` and
    ``evaluate_model`` with their default progress bars print their lines
    instead of raising ``ImportError``."""
    _, variables, model = tiny
    monkeypatch.setitem(sys.modules, "tqdm", None)
    with pytest.raises(ImportError):
        import tqdm  # noqa: F401
    trainer = Trainer(port_model(PORT_MODEL, variables).train(), TINY_LOSS,
                      device="cpu")
    batches = [_stereo(30)] * 10
    losses, _ = trainer.train_model(batches, 1, 1e-4)
    assert len(losses) == 1
    evaluate_model(model, [_stereo(31)])
    out = capsys.readouterr().out
    assert "Epoch #1 [10/10]" in out and "Evaluation:" in out


@pytest.mark.parametrize("k", [3, 11])
def test_avg_pool_equals_jax_bit_for_bit(k):
    """The port's pool sums the window separably, rows then columns, as the
    JAX package's does, so the pooled values that the curves sort are the
    same floats (an order that differs in the last bit reorders near
    ties)."""
    from uncertainty_model_tpu.ops import avg_pool2d as jax_pool
    from uncertainty_model_tpu_torch.ops import avg_pool2d

    x = np.random.default_rng(k).uniform(size=(2, 24, 40, 6)).astype(
        np.float32)
    np.testing.assert_array_equal(avg_pool2d(torch.from_numpy(x), k).numpy(),
                                  np.asarray(jax_pool(jnp.asarray(x), k)))
