"""Data parallelism over `torch.distributed` (port of `laplace_jax/parallel/`)."""

from laplace_jax_torch.parallel.sharding import (
    DataParallel,
    data_mesh,
    multihost_mesh,
    shard_closure,
    shard_map_closure,
)

__all__ = [
    "DataParallel",
    "data_mesh",
    "multihost_mesh",
    "shard_closure",
    "shard_map_closure",
]
