"""The parent's side of the data-parallel tests: the references (one
process on the global batch, the JAX package's ``Trainer`` on the
conftest's 8-device CPU mesh, whose BatchNorm statistics cover the global
batch) and the checks that hold the ranks' results against them, with
their limits.  The ranks run ``torch_parallel_helpers``' jobs."""

import numpy as np

import jax
import jax.numpy as jnp

from tiny_config import TINY_INPUT
from torch_parallel_helpers import numpy_state
from torch_port_helpers import (
    DISC_FEATURE_HW, PORT_MODEL, port_disc, port_model)

from uncertainty_model_tpu.parallel import shard_batch
from uncertainty_model_tpu.train.convert import (
    convert_discriminator_state_dict, convert_model_state_dict)

from uncertainty_model_tpu_torch.utils.schedules import adjust_disparity

DISP_SCALE = adjust_disparity(0)
LR = 1e-4
GLOBAL_BATCH = 8    # one image per device of the JAX mesh, 4 per rank
ADAM_B1 = 0.9

# The f32 step against the JAX step: test_torch_train's one-step limits
# (losses 3e-5 relative; each parameter's gradient within max(5e-3 |g|,
# 5e-3), deep f32 accumulation); the running statistics after one step
# within STATS_REL of each one's largest magnitude.
JAX_LOSS_RTOL = 3e-5
JAX_GRAD_REL = JAX_GRAD_FLOOR = 5e-3
STATS_REL = 1e-5
# 2 ranks against one process on the global batch: the losses equal but
# for the order of the statistics' f32 sums (read: bit for bit); each
# parameter's gradient within max(PORT_GRAD_REL |g|, PORT_GRAD_FLOOR times
# the largest gradient's norm): one process's f32 BatchNorm is
# ``F.batch_norm``, whose fused backward rounds apart from autograd's
# through the synced layer's explicit form (the JAX package's), and the
# deep layers' statistics over 16 rows cancel much of it (read: 4.4e-4
# relative at most where |g| is above 1e-3 of the largest, 5.2e-7 of the
# largest elsewhere: the conv biases ahead of BatchNorm, whose gradient is
# 0 but for rounding)
PORT_LOSS_RTOL = 1e-6
PORT_GRAD_REL, PORT_GRAD_FLOOR = 2e-3, 1e-5
# BatchNorm alone, against one process and the JAX layer: f32 as
# test_torch_train's BatchNorm test (rtol 1e-5, atol 1e-6); bf16 as
# test_torch_bf16's BatchNorm test (the output one ulp on 1% of the
# elements, the statistics STATS_REL, the input gradient 2e-2 and the
# parameters' 1e-1 relative: XLA sums a bf16 broadcast's gradient in
# bf16, autograd in f32)
BN_F32 = dict(rtol=1e-5, atol=1e-6)
BN_BF16_DX_REL, BN_BF16_PARAM_REL = 2e-2, 1e-1


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def ulps(got, want):
    """(max distance in bf16 ulps, share of elements that differ)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    big = np.maximum(np.abs(got), np.abs(want))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(big, 2.0 ** -126))) - 7)
    return float((np.abs(got - want) / ulp).max()), float((got != want).mean())


def global_batch(seed, b=GLOBAL_BATCH):
    rng = np.random.default_rng(seed)
    return {side: rng.uniform(size=(b, *TINY_INPUT, 3)).astype(np.float32)
            for side in ("left", "right")}


def port_state(variables):
    return numpy_state(port_model(PORT_MODEL, variables))


def to_jax_tree(state, grads=None):
    """A port model's ``state_dict`` (numpy; the parameters replaced by
    ``grads`` where given) as JAX variables, by the JAX package's
    converter."""
    sd = dict(state)
    if grads is not None:
        sd.update(grads)
    return convert_model_state_dict(sd, PORT_MODEL["decoder"]["layers"])


def to_jax_disc_tree(state, grads=None):
    """The same for a port discriminator of ``TINY_DISCRIMINATOR``."""
    sd = dict(state)
    if grads is not None:
        sd.update(grads)
    return convert_discriminator_state_dict(sd,
                                            final_feature_hw=DISC_FEATURE_HW)


def port_disc_state(disc_variables):
    return numpy_state(port_disc(disc_variables))


def flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float64)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def jax_step(jtrainer, variables, batch, step_idx, disc_variables=None):
    """The JAX ``Trainer``'s step on the 8-device mesh: (losses, state
    after it, gradients read from Adam's first moments: ``mu = (1 - b1)
    g`` after one step, optax ``scale_by_adam``)."""
    copy = jax.tree.map(np.array, variables)
    state = (jtrainer.load_state(copy) if disc_variables is None else
             jtrainer.load_state(copy, jax.tree.map(np.array,
                                                    disc_variables)))
    state, metrics = jtrainer._train_step(
        state, shard_batch(batch, jtrainer.mesh), jnp.float32(DISP_SCALE),
        jnp.float32(LR), jnp.int32(step_idx))
    state = jax.device_get(state)
    grads = jax.tree.map(lambda m: np.asarray(m) / (1 - ADAM_B1),
                         state.opt_state.mu)
    disc_grads = (None if disc_variables is None else jax.tree.map(
        lambda m: np.asarray(m) / (1 - ADAM_B1), state.disc_opt_state.mu))
    return ({k: float(v) for k, v in metrics.items()}, state, grads,
            disc_grads)


def check_grads_against_jax(got, want):
    """Each parameter's gradient within max(JAX_GRAD_REL |g|,
    JAX_GRAD_FLOOR) of the JAX step's."""
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys() and len(want) > 100
    for key in want:
        diff = np.linalg.norm(got[key] - want[key])
        assert diff < max(JAX_GRAD_REL * np.linalg.norm(want[key]),
                          JAX_GRAD_FLOOR), (key, diff)


def check_stats(got, want, rtol=STATS_REL):
    """Each running statistic within ``rtol`` of its largest magnitude."""
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys() and len(want) > 20
    for key in want:
        scale = np.abs(want[key]).max() + 1e-12
        assert np.abs(got[key] - want[key]).max() <= rtol * scale, key


def check_ranks_agree(ranks, keys):
    """Both ranks hold the same losses and, for each of ``keys``, the
    same tensors bit for bit (DDP's all-reduce gives every rank the same
    sums; the statistics move alike)."""
    r0, r1 = ranks
    assert r0["losses"] == r1["losses"]
    for key in keys:
        assert r0[key].keys() == r1[key].keys()
        for name in r0[key]:
            np.testing.assert_array_equal(r0[key][name], r1[key][name],
                                          err_msg=f"{key} {name}")


def check_against_one_process(got, want, grad_keys=("grads",),
                              state_keys=("state",)):
    """A rank's step against one process's on the global batch: the
    losses within PORT_LOSS_RTOL, each gradient within max(PORT_GRAD_REL
    |g|, PORT_GRAD_FLOOR times the largest |g|), the state (parameters one
    Adam step on, running statistics) within STATS_REL of each tensor's
    largest magnitude, or 2 lr where Adam's first step took a gradient of
    0 but for rounding the other way."""
    for key, w in want["losses"].items():
        np.testing.assert_allclose(got["losses"][key], w,
                                   rtol=PORT_LOSS_RTOL, err_msg=key)
    for gk in grad_keys:
        top = max(np.linalg.norm(g) for g in want[gk].values())
        for name, w in want[gk].items():
            diff = np.linalg.norm(got[gk][name] - w)
            assert diff <= max(PORT_GRAD_REL * np.linalg.norm(w),
                               PORT_GRAD_FLOOR * top), (gk, name, diff)
    for sk in state_keys:
        for name, w in want[sk].items():
            diff = np.abs(got[sk][name].astype(np.float64) - w).max()
            assert diff <= max(STATS_REL * np.abs(w).max(), 2 * LR), (
                sk, name, diff)


