"""One bf16 and one adversarial data-parallel step on 2 CPU processes
(gloo), against one process on the global batch and against the JAX
package's data-parallel step (the JAX ``Trainer`` on the conftest's
8-device CPU mesh):

- bf16 (``dtype=torch.bfloat16``, f32 state): the losses, the BatchNorm
  running statistics and the gradients on both ranks, held as
  ``test_torch_bf16`` holds one process's step (bf16 gradients are
  noise-dominated: the whole step by its median against the reference's
  own distance from the f32 step);
- adversarial (f32), at the step where the perceptual term runs and the
  lagged clone is refreshed: the three losses, the model's and the live
  discriminator's gradients, the live discriminator's and the clone's
  parameters and BatchNorm statistics on both ranks.  The clone's
  statistics (which the JAX package drops) against one process's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tiny_config import TINY_DISCRIMINATOR, TINY_LOSS
from torch_parallel_helpers import (
    build_trainer, ddp_step_job, spawn, step_result)
from torch_parallel_oracle import (
    DISP_SCALE, JAX_LOSS_RTOL, LR, STATS_REL, check_against_one_process,
    check_grads_against_jax, check_ranks_agree, check_stats, flat,
    global_batch, jax_step, port_disc_state, port_state, rel,
    to_jax_disc_tree, to_jax_tree)
from torch_port_helpers import (
    PORT_MODEL, discriminators, models as build_models)

from uncertainty_model_tpu.models import RandomlyConnectedModel as JaxModel
from uncertainty_model_tpu.parallel import create_mesh
from uncertainty_model_tpu.train import Trainer as JaxTrainer

# the bf16 step: test_torch_bf16's pins (the losses within 1e-3 relative,
# the running statistics within 2e-2 of each one's largest magnitude, the
# whole step's gradient by its median within 1.5 times the reference's own
# median distance from the f32 step)
BF16_LOSS_RTOL = 1e-3
BF16_STATS_REL = 2e-2
BF16_NOISE_FACTOR = 1.5
# the adversarial step: the perceptual term from TINY_LOSS's
# perceptual_start on, the clone refreshed every UPDATE_FREQ batches
UPDATE_FREQ = 2
ADV_STEP = 2


def median_rel(got, want):
    return float(np.median([rel(got[k], want[k]) for k in want]))


# ---------------------------------------------------------------------------
# bf16
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bf16_step():
    """The bf16 step of 2 ranks, of one process (bf16 and f32, the exact
    gradients' stand-in) and of the JAX package's bf16 ``Trainer``, from
    the same weights and global batch."""
    _, variables, _ = build_models("fc")
    batch = global_batch(31)
    build = dict(model_config=PORT_MODEL, model_state=port_state(variables),
                 loss_config=TINY_LOSS)
    ranks = spawn(ddp_step_job, batch=batch, disp_scale=DISP_SCALE, lr=LR,
                  step_idx=0, dtype=torch.bfloat16, **build)
    one = step_result(build_trainer(dtype=torch.bfloat16, **build), batch,
                      DISP_SCALE, LR, 0)
    f32 = step_result(build_trainer(**build), batch, DISP_SCALE, LR, 0)
    jtrainer = JaxTrainer(JaxModel.from_config(**PORT_MODEL,
                                               dtype=jnp.bfloat16),
                          TINY_LOSS, mesh=create_mesh())
    return {"ranks": ranks, "one": one, "f32": f32,
            "jax": jax_step(jtrainer, variables, batch, 0)}


def _grads(result):
    return flat(to_jax_tree(result["state"], result["grads"])["params"])


def test_bf16_step_ranks_agree(bf16_step):
    check_ranks_agree(bf16_step["ranks"], ("grads", "state"))
    for r in bf16_step["ranks"]:
        assert all(v.dtype == np.float32 for v in r["grads"].values())
        assert all(v.dtype == np.float32 for k, v in r["state"].items()
                   if not k.endswith("num_batches_tracked"))


@pytest.mark.parametrize("reference", ["one process", "jax"])
def test_bf16_step(bf16_step, reference):
    """Both ranks against one process's bf16 step on the global batch and
    against the JAX bf16 step: the losses, the running statistics, and
    the gradients' median against the reference's own distance from the
    f32 step."""
    exact = _grads(bf16_step["f32"])
    if reference == "jax":
        losses, state, grads, _ = bf16_step["jax"]
        want_grads = flat(grads)
        want_stats = state.batch_stats
    else:
        one = bf16_step["one"]
        losses, want_grads = one["losses"], _grads(one)
        want_stats = to_jax_tree(one["state"])["batch_stats"]
    noise = median_rel(want_grads, exact)
    for got in bf16_step["ranks"]:
        for key, w in losses.items():
            np.testing.assert_allclose(got["losses"][key], w,
                                       rtol=BF16_LOSS_RTOL, err_msg=key)
        check_stats(to_jax_tree(got["state"])["batch_stats"], want_stats,
                    BF16_STATS_REL)
        assert median_rel(_grads(got), want_grads) <= (
            BF16_NOISE_FACTOR * noise), (median_rel(_grads(got), want_grads),
                                         noise)


# ---------------------------------------------------------------------------
# adversarial
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def adversarial_step():
    """The adversarial step ``ADV_STEP`` (the perceptual term live, the
    clone refreshed after the update) of 2 ranks, of one process and of
    the JAX ``Trainer`` with the discriminator, from the same weights and
    global batch."""
    jmodel, variables, _ = build_models("fc")
    jdisc, disc_variables = discriminators()
    batch = global_batch(32)
    build = dict(model_config=PORT_MODEL, model_state=port_state(variables),
                 loss_config=TINY_LOSS, disc_config=TINY_DISCRIMINATOR,
                 disc_state=port_disc_state(disc_variables),
                 perceptual_update_freq=UPDATE_FREQ)
    ranks = spawn(ddp_step_job, batch=batch, disp_scale=DISP_SCALE, lr=LR,
                  step_idx=ADV_STEP, **build)
    one = step_result(build_trainer(**build), batch, DISP_SCALE, LR,
                      ADV_STEP)
    jtrainer = JaxTrainer(jmodel, TINY_LOSS, disc=jdisc, mesh=create_mesh(),
                          perceptual_update_freq=UPDATE_FREQ)
    return {"ranks": ranks, "one": one,
            "jax": jax_step(jtrainer, variables, batch, ADV_STEP,
                            disc_variables)}


def test_adversarial_step_ranks_agree(adversarial_step):
    """Both ranks hold the same gradients, model, live discriminator and
    clone, and the clone is the live discriminator after the refresh
    (its statistics its own)."""
    check_ranks_agree(adversarial_step["ranks"],
                      ("grads", "state", "disc_grads", "disc_state",
                       "lag_state"))
    for r in adversarial_step["ranks"]:
        assert set(r["losses"]) == {"disp_loss", "error_loss", "disc_loss"}
        for name in r["disc_grads"]:
            np.testing.assert_array_equal(r["lag_state"][name],
                                          r["disc_state"][name])


def test_adversarial_step_equals_one_process(adversarial_step):
    for got in adversarial_step["ranks"]:
        check_against_one_process(
            got, adversarial_step["one"], ("grads", "disc_grads"),
            ("state", "disc_state", "lag_state"))


def test_adversarial_step_equals_jax(adversarial_step):
    """Both ranks against the JAX step: the three losses, the model's and
    the discriminator's gradients per parameter, the live discriminator's
    parameters one step on and its statistics, and the clone's
    parameters (the JAX package's ``disc_lag_params``, refreshed)."""
    losses, state, grads, disc_grads = adversarial_step["jax"]
    for got in adversarial_step["ranks"]:
        for key, w in losses.items():
            np.testing.assert_allclose(got["losses"][key], w,
                                       rtol=JAX_LOSS_RTOL, err_msg=key)
        check_grads_against_jax(
            to_jax_tree(got["state"], got["grads"])["params"], grads)
        check_grads_against_jax(
            to_jax_disc_tree(got["disc_state"], got["disc_grads"])["params"],
            disc_grads)
        check_stats(to_jax_tree(got["state"])["batch_stats"],
                    state.batch_stats)
        disc = to_jax_disc_tree(got["disc_state"])
        check_stats(disc["batch_stats"], state.disc_batch_stats)
        for name, tree in (("live", state.disc_params),
                           ("clone", state.disc_lag_params)):
            ours = flat(disc["params"] if name == "live" else
                        to_jax_disc_tree(got["lag_state"])["params"])
            ref = flat(tree)
            assert ours.keys() == ref.keys()
            for key in ref:
                diff = np.abs(ours[key] - ref[key]).max()
                assert diff <= max(STATS_REL * np.abs(ref[key]).max(),
                                   2 * LR), (name, key, diff)
