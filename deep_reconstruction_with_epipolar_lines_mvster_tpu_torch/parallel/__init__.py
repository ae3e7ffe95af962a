"""Multi-process training and the sharded eval forward of the port
(counterpart of the JAX package's ``parallel/``)."""

from .distributed import (
    HostMesh,
    host_mesh,
    init_distributed,
    is_host0,
    reduce_scalars_across_hosts,
    sync_hosts,
)
from .mesh import data_parallel, pad_batch_to_multiple, sharded_eval_forward, split_batch

__all__ = [
    "HostMesh",
    "data_parallel",
    "host_mesh",
    "init_distributed",
    "is_host0",
    "pad_batch_to_multiple",
    "reduce_scalars_across_hosts",
    "sharded_eval_forward",
    "split_batch",
    "sync_hosts",
]
