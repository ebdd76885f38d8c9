"""The port's adversarial branch against the JAX package's, on the tiny
config (``torch_port_helpers.PORT_MODEL`` and ``TINY_DISCRIMINATOR``,
32x64, batch 2, ``TINY_LOSS`` with ``perceptual_start`` 2) from the same
converted weights and numpy-seeded inputs:

- the adversarial losses (``losses/adversarial.py``) against the JAX
  functions, values and input gradients, and their types in bf16;
- the composite loss's perceptual gate, decided on the host;
- 4 steps of ``Trainer.train_step`` with ``perceptual_update_freq`` 2
  against the JAX ``Trainer._train_step`` (the gate opens at step 2, the
  lagged clone is refreshed at steps 0 and 2): the first step's losses and
  its model and discriminator gradients, then the trajectory's losses,
  parameters and the live discriminator's BatchNorm statistics;
- the clone (no gradient, its own BatchNorm buffers, refreshed after the
  update), the live discriminator's statistics moving once a step, the
  epoch's ``disc`` average, and the refusal of bf16.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tiny_config import TINY_DISCRIMINATOR, TINY_INPUT, TINY_LOSS
from torch_port_helpers import (
    DISC_FEATURE_HW, PORT_MODEL, discriminators, models as build_models,
    port_disc, port_model)

from uncertainty_model_tpu.losses import adversarial as jadv
from uncertainty_model_tpu.parallel import create_mesh, shard_batch
from uncertainty_model_tpu.train import Trainer as JaxTrainer
from uncertainty_model_tpu.train.convert import (
    convert_discriminator_state_dict, convert_model_state_dict)

from uncertainty_model_tpu_torch import losses as tl
from uncertainty_model_tpu_torch.models import RandomDiscriminator
from uncertainty_model_tpu_torch.ops import reconstruct_pyramid_with_lr
from uncertainty_model_tpu_torch.train import Trainer
from uncertainty_model_tpu_torch.utils.schedules import adjust_disparity

DISP_SCALE = adjust_disparity(0)
LR = 1e-4
N_STEPS = 4
UPDATE_FREQ = 2
VALUE_TOL = dict(rtol=1e-5, atol=0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _batch(seed, b=2):
    rng = np.random.default_rng(seed)
    return {side: rng.uniform(size=(b, *TINY_INPUT, 3)).astype(np.float32)
            for side in ("left", "right")}


def _levels(seed, b=2):
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=(b, TINY_INPUT[0] >> i, TINY_INPUT[1] >> i, 6))
            .astype(np.float32) for i in range(4)]


# stand-ins for the discriminator, the same function in both frameworks:
# predictions from each level's mean, features a pointwise map per level
_MIX = np.array([0.9, -1.3, 2.1, -0.4], np.float32)


def _jax_apply(pyr):
    z = sum(w * jnp.mean(p - 0.5, axis=(1, 2, 3)) for w, p in zip(_MIX, pyr))
    return jax.nn.sigmoid(4 * z)[:, None]


def _jax_features(pyr):
    return [jnp.tanh(w * p) for w, p in zip(_MIX, pyr)]


def _torch_apply(pyr):
    z = sum(float(w) * torch.mean(p - 0.5, dim=(1, 2, 3))
            for w, p in zip(_MIX, pyr))
    return torch.sigmoid(4 * z)[:, None]


def _torch_features(pyr):
    return [torch.tanh(float(w) * p) for w, p in zip(_MIX, pyr)]


def _check(jax_fn, torch_fn, args):
    """``jax_fn(*args)`` against ``torch_fn(*args)`` (lists of numpy
    arrays in, a scalar out): the value within ``VALUE_TOL``, its gradient
    in every argument within ``GRAD_TOL``."""
    want, want_grads = jax.value_and_grad(
        jax_fn, argnums=tuple(range(len(args))))(
        *jax.tree.map(jnp.asarray, args))
    t_args = [[torch.from_numpy(a).requires_grad_() for a in arg]
              for arg in args]
    got = torch_fn(*t_args)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **VALUE_TOL)
    for t_arg, w_arg in zip(t_args, want_grads):
        for t, w in zip(t_arg, w_arg):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                       **GRAD_TOL)


def test_bce_loss_with_predictions_of_0_and_1():
    """torch's ``BCELoss`` rule, as the JAX package's: each log clamped at
    -100, so certain mistakes cost 100 and certain hits 0; the values
    equal, the gradient equal where the prediction is inside (0, 1)."""
    p = np.array([[0.0], [1.0], [0.0], [1.0], [0.3], [0.8]], np.float32)
    labels = np.array([[1.0], [0.0], [0.0], [1.0], [1.0], [0.0]], np.float32)
    got = tl.bce_loss(torch.from_numpy(p), torch.from_numpy(labels))
    want = jadv.bce_loss(jnp.asarray(p), jnp.asarray(labels))
    np.testing.assert_allclose(got.item(), float(want), **VALUE_TOL)
    np.testing.assert_allclose(
        got.item(), (100 + 100 + 0 + 0 - np.log(0.3) - np.log(0.2)) / 6,
        rtol=1e-6)
    inner = [p[4:], labels[4:]]
    _check(lambda a, b: jadv.bce_loss(a[0], b[0]),
           lambda a, b: tl.bce_loss(a[0], b[0]), [[inner[0]], [inner[1]]])


@pytest.mark.parametrize("loss_type", ["mse", "bce"])
def test_generator_loss(loss_type):
    _check(lambda r: jadv.generator_loss(r, _jax_apply, loss_type),
           lambda r: tl.generator_loss(r, _torch_apply, loss_type),
           [_levels(1)])


def test_perceptual_loss():
    _check(lambda i, r: jadv.perceptual_loss(i, r, _jax_features),
           lambda i, r: tl.perceptual_loss(i, r, _torch_features),
           [_levels(2), _levels(3)])


def test_discriminator_loss_detaches_the_fakes():
    """Real and fake concatenated on the batch (2 + 2), labels 1 then 0,
    halved; the reconstructions get no gradient (JAX's stop_gradient: a
    zero gradient there, none in torch)."""
    images, recons = _levels(4), _levels(5)
    want, (gi, gr) = jax.value_and_grad(
        lambda i, r: jadv.discriminator_loss(i, r, _jax_apply, 2),
        argnums=(0, 1))(*jax.tree.map(jnp.asarray, [images, recons]))
    ti = [torch.from_numpy(a).requires_grad_() for a in images]
    tr = [torch.from_numpy(a).requires_grad_() for a in recons]
    got = tl.discriminator_loss(ti, tr, _torch_apply, 2)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **VALUE_TOL)
    for t, w in zip(ti, gi):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **GRAD_TOL)
    assert all(t.grad is None for t in tr)
    assert all(not np.asarray(w).any() for w in gr)


def test_bf16_predictions_follow_the_jax_types():
    """bf16 predictions: the generator's MSE (and BCE, its labels
    ``ones_like``) in bf16; the discriminator's BCE in f32, its labels
    being f32; the values as the JAX package's (one bf16 ulp)."""
    images, recons = _levels(6), _levels(7)

    def jax_bf16(pyr):
        return _jax_apply(pyr).astype(jnp.bfloat16)

    def torch_bf16(pyr):
        return _torch_apply(pyr).to(torch.bfloat16)

    t_images = [torch.from_numpy(a) for a in images]
    t_recons = [torch.from_numpy(a) for a in recons]
    for loss_type in ("mse", "bce"):
        got = tl.generator_loss(t_recons, torch_bf16, loss_type)
        want = jadv.generator_loss(recons, jax_bf16, loss_type)
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        np.testing.assert_allclose(got.float().item(), float(want),
                                   rtol=2 ** -8)
    got = tl.discriminator_loss(t_images, t_recons, torch_bf16, 2)
    want = jadv.discriminator_loss(images, recons, jax_bf16, 2)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("step", [1, 2])
def test_perceptual_gate_is_decided_on_the_host(step):
    """Below ``perceptual_start`` the discriminator's features are never
    asked for; from it on, the total carries the weighted perceptual term
    (the difference of the totals with and without it)."""
    rng = np.random.default_rng(8)
    images = [torch.from_numpy(a) for a in _levels(8)]
    preds = [torch.from_numpy(np.concatenate([
        rng.uniform(0, 0.3, (2, *a.shape[1:3], 2)),
        rng.uniform(0.05, 0.9, (2, *a.shape[1:3], 2))], -1)
        .astype(np.float32)) for a in images]
    recons = [torch.from_numpy(a) for a in _levels(9)]
    _, lr = reconstruct_pyramid_with_lr(preds, images)
    calls = []

    def features(pyr):
        calls.append(len(pyr))
        return _torch_features(pyr)

    loss = tl.TukraUncertaintyLoss(**TINY_LOSS)
    plain, _ = loss(images, preds, recons, lr, step=step)
    total, _ = loss(images, preds, recons, lr, step=step,
                    disc_apply=_torch_apply, disc_features=features)
    generator = tl.generator_loss(recons, _torch_apply)
    perceptual = tl.perceptual_loss(images, recons, _torch_features)
    want = plain + generator * TINY_LOSS["adversarial_weight"]
    if step >= TINY_LOSS["perceptual_start"]:
        assert calls == [4, 4]
        want = want + perceptual * TINY_LOSS["perceptual_weight"]
    else:
        assert calls == []
    np.testing.assert_allclose(total.item(), want.item(), rtol=1e-6)


# ---------------------------------------------------------------------------
# the step and the trajectory against the JAX trainer
# ---------------------------------------------------------------------------


def _port_trainer(variables, disc_variables, **kw):
    return Trainer(port_model(PORT_MODEL, variables).train(), TINY_LOSS,
                   disc=port_disc(disc_variables), device="cpu",
                   perceptual_update_freq=UPDATE_FREQ, **kw)


def _model_tree(model, grads=False):
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    if grads:
        sd.update({k: p.grad.numpy() for k, p in model.named_parameters()})
    return convert_model_state_dict(sd, PORT_MODEL["decoder"]["layers"])


def _disc_tree(disc, grads=False):
    sd = {k: v.detach().numpy() for k, v in disc.state_dict().items()}
    if grads:
        sd.update({k: p.grad.numpy() for k, p in disc.named_parameters()})
    return convert_discriminator_state_dict(sd,
                                            final_feature_hw=DISC_FEATURE_HW)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float64)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def run():
    """``N_STEPS`` steps of both trainers from the same weights and
    batches.  The JAX step's gradients of the first step are read from its
    Adam first moments, ``mu = (1 - b1) g`` after one step (optax
    ``scale_by_adam``), which hold the jitted step's own ``jax.grad`` of
    the model and ``jax.value_and_grad`` of the discriminator."""
    jmodel, variables, _ = build_models("fc")
    jdisc, disc_variables = discriminators()
    mesh = create_mesh(jax.devices()[:1])
    jtrainer = JaxTrainer(jmodel, TINY_LOSS, disc=jdisc, mesh=mesh,
                          perceptual_update_freq=UPDATE_FREQ)
    # copies: the jitted step donates the state's buffers
    state = jtrainer.load_state(jax.tree.map(np.array, variables),
                                jax.tree.map(np.array, disc_variables))
    trainer = _port_trainer(variables, disc_variables)
    out = {"jax": [], "port": [], "lag_equal": [], "lag_grads": [],
           "tracked": []}
    for i in range(N_STEPS):
        batch = _batch(10 + i)
        state, want = jtrainer._train_step(
            state, shard_batch(batch, mesh), jnp.float32(DISP_SCALE),
            jnp.float32(LR), jnp.int32(i))
        got = trainer.train_step(batch, DISP_SCALE, LR, i)
        out["jax"].append({k: float(v) for k, v in want.items()})
        out["port"].append({k: v.item() for k, v in got.items()})
        if i == 0:
            b1 = 1 - 0.9
            out["jax_grads"] = jax.tree.map(
                lambda m: np.asarray(m) / b1, state.opt_state.mu)
            out["jax_disc_grads"] = jax.tree.map(
                lambda m: np.asarray(m) / b1, state.disc_opt_state.mu)
            out["port_grads"] = _model_tree(trainer.model, grads=True)
            out["port_disc_grads"] = _disc_tree(trainer.disc, grads=True)
        out["lag_equal"].append(all(
            torch.equal(a, b) for a, b in zip(trainer.disc_lag.parameters(),
                                              trainer.disc.parameters())))
        out["lag_grads"].append([p.grad for p in
                                 trainer.disc_lag.parameters()])
        out["tracked"].append(
            trainer.disc.layers[0].layers[0].node_blocks[0].convolution
            .layers[1].num_batches_tracked.item())
    out["jax_state"] = jax.device_get(state)
    out["trainer"] = trainer

    # the JAX trajectory from weights moved by 1e-7 relative (f32 rounding)
    rng = np.random.default_rng(0)

    def nudged(tree):
        return jax.tree.map(lambda a: np.asarray(a) * (1 + 1e-7 * (
            rng.standard_normal(np.shape(a)))).astype(np.float32), tree)

    state = jtrainer.load_state(
        {"params": nudged(variables["params"]),
         "batch_stats": jax.tree.map(np.array, variables["batch_stats"])},
        {"params": nudged(disc_variables["params"]),
         "batch_stats": jax.tree.map(np.array,
                                     disc_variables["batch_stats"])})
    out["jax_nudged"] = []
    for i in range(N_STEPS):
        state, want = jtrainer._train_step(
            state, shard_batch(_batch(10 + i), mesh), jnp.float32(DISP_SCALE),
            jnp.float32(LR), jnp.int32(i))
        out["jax_nudged"].append({k: float(v) for k, v in want.items()})
    return out


def _check_grads(ours, ref):
    """Each parameter's gradient within max(5e-3 |g|, 5e-3)
    (``test_torch_train``'s one-step limit)."""
    ours, ref = _flat(ours), _flat(ref)
    assert ours.keys() == ref.keys()
    for key in ours:
        diff = np.linalg.norm(ours[key] - ref[key])
        scale = np.linalg.norm(ref[key])
        assert diff < max(5e-3 * scale, 5e-3), (key, diff, scale)


def test_one_step_losses_and_grads_match_jax(run):
    """Step 0 (the generator term live, the perceptual one not yet): the
    three losses within 3e-5 relative, the model's and the
    discriminator's gradients per parameter within max(5e-3 |g|, 5e-3)."""
    for key in ("disp_loss", "error_loss", "disc_loss"):
        np.testing.assert_allclose(run["port"][0][key], run["jax"][0][key],
                                   rtol=3e-5, err_msg=key)
    _check_grads(run["port_grads"]["params"], run["jax_grads"])
    _check_grads(run["port_disc_grads"]["params"], run["jax_disc_grads"])
    assert len(_flat(run["jax_disc_grads"])) > 100


def test_four_steps_match_jax_trainer(run):
    """The losses of every step (the perceptual term from step 2) within
    1e-2 relative; after 4 steps the model's and the discriminator's
    parameters (the clone's too) within max(2e-2 |p|, 2e-3 sqrt(n)), and
    the BatchNorm running statistics, the live discriminator's against
    JAX's ``disc_batch_stats``, within 3e-2 of their scale
    (``test_torch_train``'s three-step limits).

    The losses' limit is the trajectory's own: Adam's first updates move
    every parameter by about lr whatever its gradient's size, so the
    parameters whose gradient is noise (the gates ahead of BatchNorm, the
    conv biases) step in directions set by rounding, and the
    discriminator's BatchNorm over maps of 2-16 elements a channel
    magnifies that.  The JAX step against itself from weights moved by
    1e-7 relative drifts by more than 5e-4 (read: 1.5e-3, disp_loss at
    step 3); the port reads 2.1e-3 there."""
    def rel(a, b):
        return abs(a - b) / abs(b)

    nudged = max(rel(n[k], w[k]) for n, w in zip(run["jax_nudged"],
                                                 run["jax"]) for k in w)
    assert nudged > 5e-4
    for i, (got, want) in enumerate(zip(run["port"], run["jax"])):
        assert got.keys() == want.keys() == {"disp_loss", "error_loss",
                                             "disc_loss"}
        for key in want:
            assert rel(got[key], want[key]) < 1e-2, (i, key)
    state, trainer = run["jax_state"], run["trainer"]
    for ours, ref in ((_model_tree(trainer.model),
                       {"params": state.params,
                        "batch_stats": state.batch_stats}),
                      (_disc_tree(trainer.disc),
                       {"params": state.disc_params,
                        "batch_stats": state.disc_batch_stats})):
        p_ours, p_ref = _flat(ours["params"]), _flat(ref["params"])
        assert p_ours.keys() == p_ref.keys()
        for key in p_ours:
            diff = np.linalg.norm(p_ours[key] - p_ref[key])
            assert diff < max(2e-2 * np.linalg.norm(p_ref[key]),
                              2e-3 * np.sqrt(p_ref[key].size)), (key, diff)
        s_ours, s_ref = _flat(ours["batch_stats"]), _flat(ref["batch_stats"])
        assert s_ours.keys() == s_ref.keys()
        for key in s_ours:
            scale = np.abs(s_ref[key]).max() + 1e-6
            assert np.abs(s_ours[key] - s_ref[key]).max() < 3e-2 * scale, key
    lag = _flat(jax.tree.map(np.asarray, state.disc_lag_params))
    ours = _flat(_disc_tree(trainer.disc_lag)["params"])
    assert all(np.linalg.norm(ours[k] - lag[k]) < max(
        2e-2 * np.linalg.norm(lag[k]), 2e-3 * np.sqrt(lag[k].size))
        for k in lag)


def test_lag_is_refreshed_after_the_update_and_holds_no_grad(run):
    """Refreshed at steps 0 and 2 (``step % 2 == 0``), after the
    discriminator's update, so equal to the live one there and behind it
    at steps 1 and 3; its parameters never hold a gradient."""
    assert run["lag_equal"] == [True, False, True, False]
    assert all(g is None for grads in run["lag_grads"] for g in grads)
    assert all(not p.requires_grad
               for p in run["trainer"].disc_lag.parameters())


def test_live_statistics_move_once_a_step(run):
    """One live forward a step (the real and fake pyramids in one batch),
    so each BatchNorm's step count reads the number of steps."""
    assert run["tracked"] == [1, 2, 3, 4]


def test_clone_forwards_leave_the_live_discriminator_alone():
    """The loss's three clone forwards (generator, and the perceptual
    term's two) move the clone's buffers, not the live discriminator's: a
    step from the same start gives the same live statistics whether the
    perceptual term runs (step 2) or not (step 1)."""
    _, variables, _ = build_models("fc")
    _, disc_variables = discriminators()
    live = {}
    for step in (1, 2):
        trainer = _port_trainer(variables, disc_variables)
        before = copy.deepcopy(trainer.disc_lag.state_dict())
        trainer.train_step(_batch(30), DISP_SCALE, 0.0, step)
        live[step] = trainer.disc.state_dict()
        lag_after = trainer.disc_lag.state_dict()
        moved = [k for k in before if k.endswith("num_batches_tracked")
                 and lag_after[k] != before[k]]
        assert moved and all(lag_after[k] - before[k] in (1, 2, 3)
                             for k in moved)
    for key, value in live[1].items():
        if "running" in key or "num_batches" in key:
            assert torch.equal(value, live[2][key]), key


def test_model_grads_hold_nothing_from_the_discriminator_step():
    """The discriminator's loss reaches no model parameter (the fakes are
    detached): the model's gradients after the step equal those it held
    when the discriminator's step began, and the discriminator's own are
    set."""
    _, variables, _ = build_models("fc")
    _, disc_variables = discriminators()
    trainer = _port_trainer(variables, disc_variables)
    seen = {}
    disc_step = trainer._disc_step

    def recorded(*args):
        seen.update({k: p.grad.clone()
                     for k, p in trainer.model.named_parameters()})
        return disc_step(*args)

    trainer._disc_step = recorded
    trainer.train_step(_batch(31), DISP_SCALE, 0.0, 1)
    assert seen.keys() == dict(trainer.model.named_parameters()).keys()
    for k, p in trainer.model.named_parameters():
        assert torch.equal(p.grad, seen[k]), k
    assert all(p.grad is not None for p in trainer.disc.parameters())
    assert trainer.disc.linear.weight.grad.abs().sum() > 0


def test_train_one_epoch_averages_disc(run):
    """``train_one_epoch`` returns the per-image average of the
    discriminator's loss beside the other two, read every 2 batches."""
    _, variables, _ = build_models("fc")
    _, disc_variables = discriminators()
    batches = [_batch(40 + i) for i in range(3)]
    stepped = _port_trainer(variables, disc_variables)
    losses = [stepped.train_step(b, DISP_SCALE, LR, i)
              for i, b in enumerate(batches)]
    averages = _port_trainer(variables, disc_variables).train_one_epoch(
        batches, DISP_SCALE, LR, metrics_every=2)
    n = sum(len(b["left"]) for b in batches)
    for name, key in (("disp", "disp_loss"), ("unc", "error_loss"),
                      ("disc", "disc_loss")):
        assert averages[name] == pytest.approx(
            sum(m[key].item() for m in losses) / n, rel=1e-6)


@pytest.mark.parametrize("which", ["model", "disc"])
def test_bf16_with_a_discriminator_is_refused(which):
    """A bf16 model or discriminator with a discriminator: the JAX
    package's bf16 adversarial step fails in its ``lax.cond``, so there is
    no reference to hold it to."""
    _, variables, _ = build_models("fc")
    model = port_model(PORT_MODEL, variables,
                       torch.bfloat16 if which == "model" else None)
    disc = RandomDiscriminator.from_config(
        **TINY_DISCRIMINATOR, device="cpu",
        dtype=torch.bfloat16 if which == "disc" else None)
    with pytest.raises(NotImplementedError, match="losses/total.py:97-101"):
        Trainer(model, TINY_LOSS, disc=disc, device="cpu")
