"""The port's training losses against the JAX package's, on the tiny
config's 4-scale pyramid (32x64 down to 4x8) at batch 2, inputs from numpy
seeds.  Values within rtol 1e-5; gradients in the inputs within rtol 1e-4,
atol 1e-6 (the two frameworks sum the means and pools in other orders)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tiny_config import TINY_LOSS
from torch_port_helpers import discriminators, jax_disc_apply, port_disc

from uncertainty_model_tpu import losses as jl
from uncertainty_model_tpu.ops import reconstruct_pyramid_with_lr as jax_recon_lr

from uncertainty_model_tpu_torch import losses as tl
from uncertainty_model_tpu_torch.config import FLAGSHIP_LOSS
from uncertainty_model_tpu_torch.ops import reconstruct_pyramid_with_lr

VALUE_TOL = dict(rtol=1e-5, atol=0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
SCALES = [(32, 64), (16, 32), (8, 16), (4, 8)]


def _level(seed, h, w, b=2):
    """(images (6 ch), predictions (4 ch: disparity, positive uncertainty),
    reconstructions (6 ch)) of one pyramid level."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(b, h, w, 6)).astype(np.float32)
    pred = np.concatenate([
        rng.uniform(0.0, 0.3, size=(b, h, w, 2)),
        rng.uniform(0.05, 0.9, size=(b, h, w, 2))], axis=-1).astype(np.float32)
    recon = np.clip(images + rng.normal(0, 0.1, size=images.shape), 0, 1)
    return images, pred, recon.astype(np.float32)


def _pyramid(seed):
    levels = [_level(seed + i, h, w) for i, (h, w) in enumerate(SCALES)]
    return [list(group) for group in zip(*levels)]


def _check(jax_fn, torch_fn, args, diff=None):
    """``jax_fn(*args)`` against ``torch_fn(*args)`` (numpy in; a scalar or
    a tuple of scalars out): each value, and the gradient of their sum in
    the arguments numbered ``diff`` (a gradient is a numpy array or a list
    of them, like its argument; an argument the value does not depend on
    has a zero gradient in JAX and none in torch)."""
    diff = tuple(range(len(args))) if diff is None else diff
    j_args = jax.tree.map(jnp.asarray, args)

    def summed(*a):
        out = jax_fn(*a)
        return sum(jax.tree.leaves(out)), out

    (_, want), want_grads = jax.jit(jax.value_and_grad(
        summed, argnums=diff, has_aux=True))(*j_args)

    def leaf(a, grad):
        t = torch.from_numpy(np.array(a))
        return t.requires_grad_() if grad else t

    t_args = [jax.tree.map(lambda a, g=(i in diff): leaf(a, g), arg)
              for i, arg in enumerate(args)]
    got = torch_fn(*t_args)
    got = got if isinstance(got, tuple) else (got,)
    sum(got).backward()
    for g, w in zip(got, jax.tree.leaves(want), strict=True):
        np.testing.assert_allclose(g.item(), float(w), **VALUE_TOL)
    for i, wg in zip(diff, want_grads):
        tg = jax.tree.map(lambda t: np.zeros(t.shape, np.float32)
                          if t.grad is None else t.grad.numpy(), t_args[i])
        for g, w in zip(jax.tree.leaves(tg), jax.tree.leaves(wg)):
            np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL)


def test_l1_loss():
    images, pred, recon = _level(0, 32, 64)
    _check(jl.l1_loss, tl.l1_loss, [images, recon])


@pytest.mark.parametrize("h,w", [(32, 64), (4, 8)])
def test_consistency_loss(h, w):
    """The uncertainty-consistency form, as the uncertainty loss calls it:
    the uncertainty map is the warp field over the disparity."""
    _, pred, _ = _level(1, h, w)
    _check(jl.consistency_loss, tl.consistency_loss,
           [pred[..., 2:], pred[..., :2]])


@pytest.mark.parametrize("channels", [6, 2])
def test_smoothness_loss(channels):
    images, pred, _ = _level(2, 16, 32)
    _check(jl.smoothness_loss, tl.smoothness_loss,
           [pred[..., :2], images[..., :channels]])


@pytest.mark.parametrize("h,w", [(32, 64), (4, 8)])
def test_wssim_loss_and_error_map(h, w):
    """The scalar loss and gradients, and the error map (resized from
    (H-2, W-2), not a 2x resize) within atol 1e-6."""
    images, _, recon = _level(3, h, w)
    _check(lambda a, b: jl.wssim_loss(a, b)[0],
           lambda a, b: tl.wssim_loss(a, b)[0], [images, recon], diff=(1,))
    want = np.asarray(jl.wssim_loss(jnp.asarray(images), jnp.asarray(recon))[1])
    got = tl.wssim_loss(torch.from_numpy(images), torch.from_numpy(recon))[1]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


LOSS_CASES = [(t, p) for t in ("l1", "bayesian", "log_bayesian")
              for p in (False, True)]


@pytest.mark.parametrize("loss_type,pooling", LOSS_CASES)
def test_reprojection_error_loss(loss_type, pooling):
    images, pred, recon = _level(4, 32, 64)
    error = np.asarray(jl.wssim_loss(jnp.asarray(images),
                                     jnp.asarray(recon))[1])
    cfg = dict(loss_type=loss_type, smoothness_weight=0.3,
               consistency_weight=0.5, pooling=pooling)
    _check(lambda p, i, e: jl.reprojection_error_loss(p, i, e, **cfg),
           lambda p, i, e: tl.reprojection_error_loss(p, i, e, **cfg),
           [pred, images, error], diff=(0, 1))


def test_reprojection_error_loss_rejects_unknown_type():
    _, pred, _ = _level(5, 8, 16)
    with pytest.raises(ValueError):
        tl.reprojection_error_loss(torch.from_numpy(pred),
                                   torch.zeros(2, 8, 16, 6),
                                   torch.zeros(2, 8, 16, 2), loss_type="l2")


def _loss_config(loss_type, pooling):
    return dict(wssim_weight=1.0, consistency_weight=0.9,
                smoothness_weight=0.8, predictive_error_weight=0.7,
                wssim_alpha=0.85, error_loss_config=dict(
                    loss_type=loss_type, smoothness_weight=0.3,
                    consistency_weight=0.5, pooling=pooling))


TOTAL_LOSS_CONFIGS = (
    [pytest.param(_loss_config(t, p), id=f"{t}-{p}")
     for t, p in LOSS_CASES]
    # the flagship's loss: section, which the training path runs
    + [pytest.param(FLAGSHIP_LOSS, id="flagship")])


@pytest.mark.parametrize("cfg", TOTAL_LOSS_CONFIGS)
def test_total_loss_with_fused_lr(cfg):
    """As the trainer calls it: the LR-consistency warps come from the
    fused reconstruction, inside the differentiated function; the disparity
    and the error loss are each checked."""
    images, preds, recons = _pyramid(10)
    jloss, tloss = jl.TukraUncertaintyLoss(**cfg), tl.TukraUncertaintyLoss(**cfg)

    def jax_fn(preds, recons):
        ims = jax.tree.map(jnp.asarray, images)
        _, lr = jax_recon_lr(preds, ims)
        return jloss(ims, preds, recons, step=jnp.int32(0), lr_pyramid=lr)

    def torch_fn(preds, recons):
        ims = [torch.from_numpy(i) for i in images]
        _, lr = reconstruct_pyramid_with_lr(preds, ims)
        return tloss(ims, preds, recons, lr, step=0)

    _check(jax_fn, torch_fn, [preds, recons])


@pytest.mark.parametrize("hook", ["disc_apply", "disc_features"])
def test_total_loss_adversarial_terms_match_jax(hook):
    """The adversarial terms against the JAX package's, with the tiny
    discriminator in train mode on both sides (``TINY_LOSS``,
    ``perceptual_start`` 2): ``disc_apply`` at step 1 adds the generator
    term alone; ``disc_features`` is the perceptual term's hook, live at
    step 2 where the gate opens.  Values and input gradients within the
    module's limits."""
    jdisc, variables = discriminators()
    disc = port_disc(variables)
    step = {"disc_apply": 1, "disc_features": 2}[hook]
    images, preds, recons = _pyramid(30)
    jloss, tloss = (jl.TukraUncertaintyLoss(**TINY_LOSS),
                    tl.TukraUncertaintyLoss(**TINY_LOSS))

    def jax_fn(preds, recons):
        ims = jax.tree.map(jnp.asarray, images)
        _, lr = jax_recon_lr(preds, ims)
        return jloss(ims, preds, recons, step=jnp.int32(step),
                     disc_apply=jax_disc_apply(jdisc, variables),
                     disc_features=jax_disc_apply(jdisc, variables,
                                                  "features"),
                     lr_pyramid=lr)

    def torch_fn(preds, recons):
        ims = [torch.from_numpy(i) for i in images]
        _, lr = reconstruct_pyramid_with_lr(preds, ims)
        return tloss(ims, preds, recons, lr, step=step, disc_apply=disc,
                     disc_features=disc.features)

    _check(jax_fn, torch_fn, [preds, recons])
