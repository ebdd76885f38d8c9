"""Multi-process jobs of the port's data parallelism on the CPU: ``spawn``
runs a function in ``world`` fresh processes joined in a gloo process
group (``parallel.init_distributed`` on a free localhost port) and returns
what each rank returned, in rank order.  Every wait has a timeout: a
rank that hangs in a collective fails the test instead of holding the
suite.

The jobs below run in those processes.  They import torch, numpy and the
port only (never JAX: the parent holds the JAX references), and take
their weights, configs and batches as arguments (numpy, pickled by
``multiprocessing``)."""

from __future__ import annotations

import queue
import traceback

import torch
import torch.multiprocessing as mp

from uncertainty_model_tpu_torch.cli.parallel_main import free_address

WORLD = 2
TIMEOUT_S = 150


def _worker(fn, rank, world, address, results, kwargs):
    from uncertainty_model_tpu_torch import parallel

    torch.set_num_threads(2)
    try:
        parallel.init_distributed(address, world, rank, torch.device("cpu"))
        try:
            out = ("ok", fn(rank, world, **kwargs))
        finally:
            parallel.destroy()
    except Exception as e:  # reported to the parent, which fails the test
        out = ("error", f"{type(e).__name__}: {e}\n{traceback.format_exc()}")
    results.put((rank, *out))


def spawn(fn, world: int = WORLD, timeout: float = TIMEOUT_S,
          expect_errors: bool = False, **kwargs) -> list:
    """``fn(rank, world, **kwargs)`` in ``world`` processes of one gloo
    group; returns each rank's result in rank order.  Raises if a rank
    raised (with ``expect_errors``, returns the ranks' error texts
    instead, and raises if any rank did not), or if any rank has not
    answered within ``timeout`` seconds."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    address = free_address()
    procs = [ctx.Process(target=_worker,
                         args=(fn, rank, world, address, results, kwargs))
             for rank in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(world):
            rank, status, value = results.get(timeout=timeout)
            got[rank] = (status, value)
    except queue.Empty:
        raise AssertionError(
            f"{world - len(got)} of {world} ranks did not answer within "
            f"{timeout} s (a hang in a collective?); answered: "
            f"{sorted(got)}") from None
    finally:
        for p in procs:
            p.join(timeout=30)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert all(not p.is_alive() for p in procs)
    statuses = [got[r][0] for r in range(world)]
    if expect_errors:
        assert statuses == ["error"] * world, got
        return [got[r][1] for r in range(world)]
    errors = [got[r][1] for r in range(world) if got[r][0] != "ok"]
    assert not errors, "\n".join(errors)
    return [got[r][1] for r in range(world)]


def rows(a, rank: int, world: int):
    """Rank ``rank``'s rows of a global batch (numpy, or a dict of them):
    the ``rank``-th of ``world`` equal slices."""
    if isinstance(a, dict):
        return {k: rows(v, rank, world) for k, v in a.items()}
    b = len(a) // world
    return a[rank * b:(rank + 1) * b]


def numpy_state(module) -> dict:
    return {k: v.detach().numpy().copy()
            for k, v in module.state_dict().items()}


def numpy_grads(module) -> dict:
    return {k: p.grad.detach().numpy().copy()
            for k, p in module.named_parameters()}


def _load(module, state: dict):
    module.load_state_dict(
        {k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return module.to(memory_format=torch.channels_last)


def build_trainer(model_config, model_state, loss_config, dtype=None,
                  disc_config=None, disc_state=None, distributed=False,
                  perceptual_update_freq=10):
    """A port ``Trainer`` on the CPU from numpy weights."""
    from uncertainty_model_tpu_torch.models import (
        RandomDiscriminator, RandomlyConnectedModel)
    from uncertainty_model_tpu_torch.train import Trainer

    model = _load(RandomlyConnectedModel(**model_config, dtype=dtype),
                  model_state).train()
    disc = None
    if disc_config is not None:
        disc = _load(RandomDiscriminator(**disc_config), disc_state).train()
    return Trainer(model, loss_config, disc=disc, device="cpu",
                   distributed=distributed,
                   perceptual_update_freq=perceptual_update_freq)


def step_result(trainer, batch, disp_scale, lr, step_idx) -> dict:
    """One ``train_step``: its losses, each parameter's gradient and the
    state after it (the model's, and with a discriminator the live one's
    and the clone's), as numpy."""
    losses = trainer.train_step(batch, disp_scale, lr, step_idx)
    out = {"losses": {k: v.item() for k, v in losses.items()},
           "grads": numpy_grads(trainer.model),
           "state": numpy_state(trainer.model)}
    if trainer.disc is not None:
        out.update(disc_grads=numpy_grads(trainer.disc),
                   disc_state=numpy_state(trainer.disc),
                   lag_state=numpy_state(trainer.disc_lag))
    return out


def ddp_step_job(rank, world, batch, disp_scale, lr, step_idx, **build):
    """One data-parallel step of rank ``rank`` on its rows of ``batch``."""
    trainer = build_trainer(distributed=True, **build)
    return step_result(trainer, rows(batch, rank, world), disp_scale, lr,
                       step_idx)


def batchnorm_job(rank, world, x, cot, weight, bias, dtype, steps):
    """A ``TorchBatchNorm`` given the process group, ``steps`` train-mode
    forwards and backwards on rank ``rank``'s rows of ``x`` (NCHW) with
    cotangent ``cot``: each step's output and input gradient, and the
    parameters' gradients and running statistics at the end."""
    from uncertainty_model_tpu_torch import parallel
    from uncertainty_model_tpu_torch.models.layers import TorchBatchNorm

    bn = TorchBatchNorm(x.shape[2], dtype).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    assert parallel.sync_batchnorm(bn, parallel.world_group()) == 1
    outs, dxs = [], []
    for s in range(steps):
        xs = torch.from_numpy(rows(x[s], rank, world)).to(
            dtype or torch.float32).requires_grad_()
        y = bn(xs)
        (y.float() * torch.from_numpy(rows(cot[s], rank, world))).sum(
            ).backward()
        outs.append(y.detach().float().numpy())
        dxs.append(xs.grad.float().numpy())
    return {"out": outs, "dx": dxs, "dweight": bn.weight.grad.numpy(),
            "dbias": bn.bias.grad.numpy(),
            "running_mean": bn.running_mean.numpy(),
            "running_var": bn.running_var.numpy()}


def evaluate_job(rank, world, model_config, model_state, batches, scale,
                 out):
    """``evaluate_model`` of rank ``rank`` on its rows of each global
    batch, its grids saved under ``out`` (rank 0 alone writes)."""
    from uncertainty_model_tpu_torch.models import RandomlyConnectedModel
    from uncertainty_model_tpu_torch.train import evaluate_model

    model = _load(RandomlyConnectedModel(**model_config), model_state).eval()
    loader = [rows(b, rank, world) for b in batches]
    return evaluate_model(model, loader, save_evaluation_to=out, scale=scale,
                          no_pbar=True)


def unequal_evaluate_job(rank, world, model_config, model_state, batch,
                         scale, out):
    """``evaluate_model`` over shards that differ: rank 0 has one batch
    more."""
    return evaluate_job(rank, world, model_config, model_state,
                        [batch] * (2 if rank == 0 else 1), scale, out)
