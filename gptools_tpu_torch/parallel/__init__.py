"""Parallel layer: device meshes, chains and particles sharded over cards.

Counterpart of `gptools_tpu.parallel`, on `torch.distributed`: one process
per card, a `DeviceMesh` with the reference's axis names, and the batched
density sharded over it (`mesh.ShardedDensity`) while the samplers' state
stays replicated; see `mesh` for the design and `distributed` for
starting the processes.
"""

from gptools_tpu_torch.parallel import distributed
from gptools_tpu_torch.parallel.mesh import (
    chain_sharding,
    make_mesh,
    shard_chains,
    sharded_sample,
    sharded_smc,
)

__all__ = [
    "distributed",
    "make_mesh",
    "chain_sharding",
    "shard_chains",
    "sharded_sample",
    "sharded_smc",
]
