"""Data parallelism over processes (``torch.distributed``): see
``mesh.py``."""

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
           "destroy", "init_distributed", "is_distributed", "local_device",
           "rank", "require_equal_shards", "sync_batchnorm", "world_group",
           "world_size"]
