"""Data parallelism: one process per rank, the gradients' mean over a
process group (the port's counterpart of the JAX package's mesh and
``shard_map`` layer)."""

from .data_parallel import (
    agree_max,
    agree_min,
    all_reduce_mean,
    gather_objects,
    GradReducer,
    mean_over_ranks,
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
    "GradReducer",
    "mean_over_ranks",
    "backend",
    "device",
    "host_store",
    "init_distributed",
    "is_multiprocess",
    "rank",
    "shutdown",
    "world_size",
]
