"""Data parallelism over processes (``torch.distributed``): see
``mesh.py``; ``launch.py`` starts one process per device."""

from .launch import free_address, spawn
from .mesh import (
    all_gather_rows,
    all_reduce_mean,
    all_reduce_sum,
    barrier,
    broadcast_,
    broadcast_str,
    debug_logging,
    destroy,
    init_distributed,
    is_distributed,
    local_device,
    rank,
    require_equal_shards,
    sync_batchnorm,
    world_group,
    world_size,
)

__all__ = ["all_gather_rows", "all_reduce_mean", "all_reduce_sum",
           "barrier", "broadcast_", "broadcast_str", "debug_logging",
           "destroy", "free_address", "init_distributed", "is_distributed",
           "local_device", "rank", "require_equal_shards", "spawn",
           "sync_batchnorm", "world_group", "world_size"]
