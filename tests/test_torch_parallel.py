"""The port's data parallelism on 2 CPU processes (gloo) against one
process on the global batch and against the JAX package's data-parallel
step (the JAX ``Trainer`` on the conftest's 8-device CPU mesh, whose
BatchNorm statistics cover the global batch):

- ``TorchBatchNorm`` given the process group, in f32 and bf16, train mode,
  each rank on its half of the batch: the outputs, the input gradients,
  the parameters' gradients and the running statistics over two steps
  equal one process's on the whole batch and the JAX ``TorchBatchNorm``'s;
  an all-reduce that carried no gradient (each rank's input gradient
  without the other rank's terms) is refused by the same limits;
- one f32 ``Trainer`` step with ``distributed=True``: the losses (the
  global batch's means), each parameter's gradient, the parameters and
  the BatchNorm running statistics on both ranks, against one process's
  step on the global batch and the JAX step;
- training shards that give the ranks different batches raise on every
  rank, within the timeout, before any step.

The global batch is rank 0's rows, then rank 1's.  Every multi-process
job runs under ``torch_parallel_helpers.spawn``'s timeout.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tiny_config import TINY_LOSS
from torch_parallel_helpers import (
    WORLD, batchnorm_job, build_trainer, ddp_step_job, rows, spawn,
    step_result)
from torch_parallel_oracle import (
    BN_BF16_DX_REL, BN_BF16_PARAM_REL, BN_F32, DISP_SCALE, JAX_LOSS_RTOL, LR,
    STATS_REL, check_against_one_process, check_grads_against_jax,
    check_ranks_agree, check_stats, global_batch, jax_step, port_state, rel,
    to_jax_tree, ulps)
from torch_port_helpers import PORT_MODEL, models as build_models

from uncertainty_model_tpu.models import layers as jl
from uncertainty_model_tpu.parallel import create_mesh
from uncertainty_model_tpu.train import Trainer as JaxTrainer


# ---------------------------------------------------------------------------
# BatchNorm on the global batch
# ---------------------------------------------------------------------------


BN_STEPS = 2


def _bn_inputs(dtype):
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(BN_STEPS, 4, 6, 5, 7)) * 2.0 + 1.5).astype(
        np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    if dtype is not None:  # values bf16 holds exactly
        x = torch.from_numpy(x).bfloat16().float().numpy()
        cot = torch.from_numpy(cot).bfloat16().float().numpy()
    weight = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    bias = rng.normal(size=6).astype(np.float32)
    return x, cot, weight, bias


def _bn_one_process(x, cot, weight, bias, dtype, loss_rows=None):
    """The same layer in one process on the whole batch.  With
    ``loss_rows`` the loss covers only those rows: the input gradient a
    rank would get if the statistics' all-reduce carried no gradient."""
    from uncertainty_model_tpu_torch.models.layers import TorchBatchNorm

    bn = TorchBatchNorm(x.shape[2], dtype).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    out = {"out": [], "dx": []}
    for s in range(BN_STEPS):
        xs = torch.from_numpy(x[s]).to(dtype or torch.float32)
        xs.requires_grad_()
        y = bn(xs)
        sel = slice(None) if loss_rows is None else loss_rows
        (y.float()[sel] * torch.from_numpy(cot[s])[sel]).sum().backward()
        out["out"].append(y.detach().float().numpy())
        out["dx"].append(xs.grad.float().numpy())
    out.update(dweight=bn.weight.grad.numpy(), dbias=bn.bias.grad.numpy(),
               running_mean=bn.running_mean.numpy(),
               running_var=bn.running_var.numpy())
    return out


def _bn_jax(x, cot, weight, bias, dtype):
    """The JAX package's ``TorchBatchNorm`` in train mode on the global
    batch (NHWC), its statistics carried over the steps."""
    jdt = None if dtype is None else jnp.bfloat16
    jbn = jl.TorchBatchNorm(use_running_average=False, dtype=jdt)
    params = {"scale": jnp.asarray(weight), "bias": jnp.asarray(bias)}
    stats = {"mean": jnp.zeros(6, jnp.float32),
             "var": jnp.ones(6, jnp.float32)}
    out = {"out": [], "dx": [], "dweight": 0.0, "dbias": 0.0}
    for s in range(BN_STEPS):
        xh = jnp.asarray(x[s].transpose(0, 2, 3, 1))
        if jdt is not None:
            xh = xh.astype(jdt)

        def fwd(p, xh, stats=stats):
            y, mut = jbn.apply({"params": p, "batch_stats": stats}, xh,
                               mutable=["batch_stats"])
            return y, mut["batch_stats"]

        y, vjp, stats = jax.vjp(fwd, params, xh, has_aux=True)
        cot_h = jnp.asarray(cot[s].transpose(0, 2, 3, 1)).astype(y.dtype)
        dp, dx = vjp(cot_h)
        out["out"].append(np.asarray(y.astype(jnp.float32)).transpose(
            0, 3, 1, 2))
        out["dx"].append(np.asarray(dx.astype(jnp.float32)).transpose(
            0, 3, 1, 2))
        out["dweight"] += np.asarray(dp["scale"], np.float32)
        out["dbias"] += np.asarray(dp["bias"], np.float32)
    out.update(running_mean=np.asarray(stats["mean"]),
               running_var=np.asarray(stats["var"]))
    return out


def _bn_gathered(ranks):
    """The ranks' results as one process's: rows concatenated in rank
    order, the parameters' gradients summed (each rank's loss is the sum
    over its rows)."""
    return {"out": [np.concatenate([r["out"][s] for r in ranks])
                    for s in range(BN_STEPS)],
            "dx": [np.concatenate([r["dx"][s] for r in ranks])
                   for s in range(BN_STEPS)],
            "dweight": sum(r["dweight"] for r in ranks),
            "dbias": sum(r["dbias"] for r in ranks),
            "running_mean": ranks[0]["running_mean"],
            "running_var": ranks[0]["running_var"]}


def _assert_bn_close(got, want, dtype, what):
    for key in ("running_mean", "running_var"):
        scale = np.abs(want[key]).max()
        assert np.abs(got[key] - want[key]).max() <= STATS_REL * scale, (
            what, key)
    if dtype is None:
        for key in ("out", "dx"):
            for s in range(BN_STEPS):
                np.testing.assert_allclose(got[key][s], want[key][s],
                                           err_msg=f"{what} {key} {s}",
                                           **BN_F32)
        for key in ("dweight", "dbias"):
            np.testing.assert_allclose(got[key], want[key], err_msg=key,
                                       rtol=BN_F32["rtol"], atol=1e-4)
        return
    for s in range(BN_STEPS):
        n, share = ulps(got["out"][s], want["out"][s])
        assert n <= 1 and share <= 0.01, (what, "out", s, n, share)
        assert rel(got["dx"][s], want["dx"][s]) <= BN_BF16_DX_REL, (what, s)
    for key in ("dweight", "dbias"):
        assert rel(got[key], want[key]) <= BN_BF16_PARAM_REL, (what, key)


@pytest.fixture(scope="module", params=[None, torch.bfloat16],
                ids=["f32", "bf16"])
def bn_run(request):
    dtype = request.param
    x, cot, weight, bias = _bn_inputs(dtype)
    ranks = spawn(batchnorm_job, x=x, cot=cot, weight=weight, bias=bias,
                  dtype=dtype, steps=BN_STEPS)
    return {"dtype": dtype, "inputs": (x, cot, weight, bias),
            "ranks": ranks, "gathered": _bn_gathered(ranks)}


def test_batchnorm_two_ranks_equal_one_process(bn_run):
    """Two ranks on halves of the batch equal one process on the whole:
    outputs, input gradients, parameters' gradients (summed over the
    ranks) and the running statistics (the same on both ranks: moved
    once a step by the global statistics, with Bessel's factor of the
    global count)."""
    dtype = bn_run["dtype"]
    want = _bn_one_process(*bn_run["inputs"], dtype)
    _assert_bn_close(bn_run["gathered"], want, dtype, "one process")
    r0, r1 = bn_run["ranks"]
    for key in ("running_mean", "running_var"):
        np.testing.assert_array_equal(r0[key], r1[key])


def test_batchnorm_two_ranks_equal_jax(bn_run):
    """The same against the JAX package's ``TorchBatchNorm`` on the global
    batch (its statistics over the whole batch, as GSPMD computes them)."""
    dtype = bn_run["dtype"]
    want = _bn_jax(*bn_run["inputs"], dtype)
    _assert_bn_close(bn_run["gathered"], want, dtype, "jax")


def test_batchnorm_refuses_a_forward_only_all_reduce(bn_run):
    """Each rank's input gradient, were the statistics' all-reduce to
    carry no gradient, would hold its own loss's terms alone (one process
    on the whole batch with the loss over that rank's rows): the limits
    above refuse it, so the test above shows the backward is summed over
    the ranks."""
    dtype = bn_run["dtype"]
    x, cot, weight, bias = bn_run["inputs"]
    b = len(x[0]) // WORLD
    want = _bn_one_process(x, cot, weight, bias, dtype)
    for r, got in enumerate(bn_run["ranks"]):
        local = _bn_one_process(x, cot, weight, bias, dtype,
                                loss_rows=slice(r * b, (r + 1) * b))
        wrong = local["dx"][0][r * b:(r + 1) * b]
        right = want["dx"][0][r * b:(r + 1) * b]
        if dtype is None:
            assert not np.allclose(wrong, right, **BN_F32)
        else:
            assert rel(wrong, right) > BN_BF16_DX_REL
        # and the rank's own gradient is the right one, by far
        assert rel(got["dx"][0], right) < rel(wrong, right) / 10


# ---------------------------------------------------------------------------
# one f32 training step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def f32_step():
    jmodel, variables, _ = build_models("fc")
    state = port_state(variables)
    batch = global_batch(21)
    build = dict(model_config=PORT_MODEL, model_state=state,
                 loss_config=TINY_LOSS)
    ranks = spawn(ddp_step_job, batch=batch, disp_scale=DISP_SCALE, lr=LR,
                  step_idx=0, **build)
    one = step_result(build_trainer(**build), batch, DISP_SCALE, LR, 0)
    jtrainer = JaxTrainer(jmodel, TINY_LOSS, mesh=create_mesh())
    assert jtrainer.mesh.size == 8
    return {"ranks": ranks, "one": one,
            "jax": jax_step(jtrainer, variables, batch, 0)}


def test_f32_step_ranks_agree(f32_step):
    check_ranks_agree(f32_step["ranks"], ("grads", "state"))


def test_f32_step_equals_one_process(f32_step):
    for got in f32_step["ranks"]:
        check_against_one_process(got, f32_step["one"])


def test_f32_step_equals_jax(f32_step):
    """Both ranks against the JAX step on the global batch: the losses,
    each parameter's gradient, and the BatchNorm running statistics."""
    losses, state, grads, _ = f32_step["jax"]
    for got in f32_step["ranks"]:
        for key, w in losses.items():
            np.testing.assert_allclose(got["losses"][key], w,
                                       rtol=JAX_LOSS_RTOL, err_msg=key)
        check_grads_against_jax(
            to_jax_tree(got["state"], got["grads"])["params"], grads)
        check_stats(to_jax_tree(got["state"])["batch_stats"],
                    state.batch_stats)


# ---------------------------------------------------------------------------
# shards that would hang
# ---------------------------------------------------------------------------


def unequal_epoch_job(rank, world, batch, **build):
    """``train_one_epoch`` over a shard one batch longer on rank 0."""
    trainer = build_trainer(distributed=True, **build)
    mine = rows(batch, rank, world)
    loader = [mine] * (2 if rank == 0 else 1)
    trainer.train_one_epoch(loader, DISP_SCALE, LR)
    return "trained"


def test_unequal_training_shards_raise_on_every_rank():
    """Rank 0's shard gives one batch more than rank 1's (a dataset size
    the world does not divide, with drop_last): both ranks raise before
    the first step, within the timeout, and neither hangs."""
    _, variables, _ = build_models("fc")
    errors = spawn(unequal_epoch_job, expect_errors=True, timeout=60,
                   batch=global_batch(22, b=4), model_config=PORT_MODEL,
                   model_state=port_state(variables), loss_config=TINY_LOSS)
    for text in errors:
        assert text.startswith("ValueError: the training shards' batch "
                               "sizes differ across the ranks ([[2, 2], "
                               "[2]]"), text


def test_sync_batchnorm_reaches_every_flagship_layer():
    """``parallel.sync_batchnorm`` gives the group to each of the
    flagship's 40 BatchNorm layers and the discriminator's 25 (built on
    the CPU from ``from_config``), and nothing else holds one; without it
    a layer keeps its own statistics (no group)."""
    from uncertainty_model_tpu_torch import parallel
    from uncertainty_model_tpu_torch.config import (
        FLAGSHIP_DISCRIMINATOR, FLAGSHIP_MODEL)
    from uncertainty_model_tpu_torch.models import (
        RandomDiscriminator, RandomlyConnectedModel)

    group = object()   # a stand-in: the layers only hold it
    for module, want in (
            (RandomlyConnectedModel.from_config(**FLAGSHIP_MODEL,
                                                device="cpu"), 40),
            (RandomDiscriminator.from_config(**FLAGSHIP_DISCRIMINATOR,
                                             device="cpu"), 25)):
        held = [m for m in module.modules()
                if getattr(m, "process_group", None) is not None]
        assert not held
        assert parallel.sync_batchnorm(module, group) == want
        held = [m for m in module.modules()
                if getattr(m, "process_group", None) is group]
        assert len(held) == want
