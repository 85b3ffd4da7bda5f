"""Data parallelism: one process per rank, DDP over a process group (the
port's counterpart of the JAX package's mesh and ``shard_map`` layer)."""

from .data_parallel import (
    agree_max,
    agree_min,
    all_reduce_mean,
    gather_objects,
    LossStep,
    mean_over_ranks,
    no_sync,
    step_module,
    wrap_model,
)
from .mesh import (
    backend,
    device,
    host_store,
    init_distributed,
    is_multiprocess,
    rank,
    shutdown,
    world_size,
)

__all__ = [
    "agree_max",
    "agree_min",
    "all_reduce_mean",
    "gather_objects",
    "LossStep",
    "mean_over_ranks",
    "no_sync",
    "step_module",
    "wrap_model",
    "backend",
    "device",
    "host_store",
    "init_distributed",
    "is_multiprocess",
    "rank",
    "shutdown",
    "world_size",
]
