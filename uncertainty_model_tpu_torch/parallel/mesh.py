"""Process groups for data parallelism (the port of the JAX package's
``parallel/mesh.py``), and the only module of the port that calls
``torch.distributed``.

The reference's parallelism is single-node DDP over NCCL
(parallel_main.py:86-170).  The JAX package runs one global program over a
device mesh, and GSPMD inserts the gradient all-reduce and the global
BatchNorm statistics.  Here it is one process per GPU (NCCL), or per CPU
process (gloo, for tests), each loading its own shard of every global
batch:

=====================================  ====================================
JAX package                            here
=====================================  ====================================
``jax.distributed.initialize``         ``init_distributed``
``jax.process_index()``                ``rank()``
``jax.process_count()``                ``world_size()``
``broadcast_one_to_all`` (run folder)  ``broadcast_str``
``process_allgather(tiled=True)``      ``all_gather_rows``
metrics summed over the global batch   ``all_reduce_sum``, ``all_reduce_mean``
GSPMD's gradient all-reduce            ``DistributedDataParallel`` (the
                                       ``Trainer``'s ``distributed=True``)
GSPMD's global BatchNorm statistics    ``sync_batchnorm`` (``TorchBatchNorm``
                                       with a process group)
``sync_global_devices``                ``barrier``
=====================================  ====================================

``create_mesh``, ``shard_batch`` and ``replicate_tree`` have no
one-to-one counterpart: each process loads its own shard (the loader's
``shard_index``/``num_shards``), and DDP broadcasts rank 0's parameters
when it wraps a module.

Every collective here must run on every rank under the same condition:
code that runs on rank 0 alone never calls one.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

# the backend of each device type: NCCL between GPUs, gloo between CPU
# processes (tests); any other device has none
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def local_device(process_id: int, platform: Optional[str] = None
                 ) -> torch.device:
    """The device of process ``process_id``: ``cuda:{process_id % the
    card count}``, or the CPU where ``platform`` is ``"cpu"``.  Raises
    where CUDA is asked for and there is none."""
    if platform is not None and torch.device(platform).type != "cuda":
        return resolve_device(platform)
    resolve_device("cuda")
    return torch.device("cuda", process_id % torch.cuda.device_count())


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int, device: torch.device) -> None:
    """Join the process group of ``num_processes`` processes as rank
    ``process_id``, meeting at ``tcp://{coordinator_address}``
    (``host:port``, the reference's MASTER_ADDR/PORT).  The backend
    follows ``device``: NCCL for a CUDA device (which becomes the
    process's current device), gloo for the CPU."""
    device = torch.device(device)
    if device.type not in BACKENDS:
        raise ValueError(f"no process-group backend for {device}: "
                         f"one of {sorted(BACKENDS)}")
    kwargs = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group(BACKENDS[device.type],
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            **kwargs)


def debug_logging() -> None:
    """Verbose process-group diagnostics: ``TORCH_DISTRIBUTED_DEBUG=DETAIL``
    (collective checks and DDP's unused-parameter report) and the
    ``torch.distributed`` loggers at DEBUG."""
    os.environ["TORCH_DISTRIBUTED_DEBUG"] = "DETAIL"
    dist.set_debug_level_from_env()
    logging.basicConfig(level=logging.INFO)
    logging.getLogger("torch.distributed").setLevel(logging.DEBUG)


def is_distributed() -> bool:
    """Whether this process belongs to a process group."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def world_group():
    """The process group of every rank (raises outside one)."""
    if not is_distributed():
        raise RuntimeError("no process group: call init_distributed first")
    return dist.group.WORLD


def barrier() -> None:
    if is_distributed():
        dist.barrier()


def destroy() -> None:
    if is_distributed():
        dist.destroy_process_group()


def broadcast_str(value: str, src: int = 0) -> str:
    """Rank ``src``'s ``value`` on every rank."""
    box = [value]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def broadcast_(tensors) -> None:
    """Overwrite each of ``tensors`` with rank 0's, in place."""
    for t in tensors:
        dist.broadcast(t, src=0)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks (a new tensor; ``t`` is kept)."""
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the ranks (gloo has no AVG: a sum, divided)."""
    return all_reduce_sum(t) / world_size()


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks of ``group``, whose backward is the sum of
    the gradients over them."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


def all_reduce_sum_autograd(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group`` whose backward sums the
    gradient over them too: each rank's input then gets every rank's
    loss's gradient, as one program over the global batch does."""
    return _AllReduceSum.apply(t, group)


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated on dim 0, in rank
    order, on every rank."""
    parts = [torch.empty_like(t) for _ in range(world_size())]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts)


def require_equal(value, what: str) -> None:
    """Raise on every rank unless every rank holds the same ``value``
    (a picklable value, gathered from each)."""
    gathered = [None] * world_size()
    dist.all_gather_object(gathered, value)
    if any(v != gathered[0] for v in gathered):
        raise ValueError(
            f"{what} differ across the ranks ({gathered}, in rank order): "
            f"every rank must run the same collectives, so the shards must "
            f"give each rank the same batches (a dataset whose size the "
            f"world size divides)")


def batch_sizes(loader) -> list[int]:
    """The batch sizes that iterating ``loader`` gives, without iterating
    it: ``DataLoader.batch_sizes()``, or each batch's of a list of
    batches."""
    if hasattr(loader, "batch_sizes"):
        return list(loader.batch_sizes())
    if isinstance(loader, (list, tuple)):
        return [len(b["left"]) for b in loader]
    raise TypeError(f"cannot tell the batch sizes of a {type(loader)} "
                    "before iterating it: give a DataLoader or a list")


def require_equal_shards(loader, what: str) -> None:
    """Raise on every rank unless every rank's ``loader`` gives as many
    batches of the same sizes: otherwise one rank would wait in a
    collective that the others never join."""
    require_equal(batch_sizes(loader), f"the {what} shards' batch sizes")


def sync_batchnorm(module: torch.nn.Module, group) -> int:
    """Give every ``TorchBatchNorm`` of ``module`` the process group
    ``group``: in train mode their statistics then cover every rank's
    rows.  Returns how many layers took it."""
    from ..models.layers import TorchBatchNorm

    layers = [m for m in module.modules() if isinstance(m, TorchBatchNorm)]
    for m in layers:
        m.process_group = group
    return len(layers)
