"""Multi-process initialization and the 2-D (nodes x local cards) mesh.

Counterpart of `gptools_tpu.parallel.distributed`. One process drives one
card (SPMD); ``torchrun --nproc-per-node=N`` starts them and names the
cluster in the environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``). On each process:

    from gptools_tpu_torch.parallel import distributed, make_mesh
    distributed.initialize()          # a no-op in a single-process run
    mesh = make_mesh()                # or distributed.pod_mesh()

then pass ``mesh=`` to `infer.pipeline`, `infer.smc` or the batch
densities of `models.gp.GPModel`, with the same generator seed on every
rank (`parallel.mesh`).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from gptools_tpu_torch.parallel.mesh import ChainSharding, chain_sharding, init_world

__all__ = ["initialize", "pod_mesh", "chain_sharding_2d", "is_multiprocess"]

_CLUSTER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join this process to the cluster's default process group.

    A no-op when a group exists already, or when neither the caller
    (``coordinator_address`` "host:port", ``num_processes``) nor the
    environment (``torchrun``'s ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``)
    names a cluster, so library code can call it unconditionally. What the
    caller leaves out comes from the environment; ``process_id`` defaults
    to ``RANK``. With a card, the process takes card ``LOCAL_RANK`` (else
    its rank modulo the cards) before the group exists. ``backend``:
    ``nccl`` with a card, else ``gloo``, unless given. A coordinator the
    caller named that cannot be reached raises (after the group's
    timeout)."""
    if dist.is_initialized():
        return
    env = os.environ
    explicit = coordinator_address is not None or num_processes is not None
    if not explicit and not all(k in env for k in _CLUSTER_ENV):
        return
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    world = int(num_processes if num_processes is not None else env["WORLD_SIZE"])
    address = coordinator_address or f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    kw = {}
    if torch.cuda.is_available():
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank % torch.cuda.device_count())))
        backend = backend or "nccl"
        if backend == "nccl":
            kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend or "gloo", init_method=f"tcp://{address}", rank=rank,
                            world_size=world, **kw)


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def pod_mesh(axis_names=("dcn", "ici"), device_type: str = "cuda") -> DeviceMesh:
    """2-D mesh: nodes x the processes (cards) of a node, from
    ``LOCAL_WORLD_SIZE`` (a single node when it is unset); (1, 1) in a
    single-process run, where a world of one is made as `make_mesh` makes
    it. Chains shard over both dimensions, flattened
    (`chain_sharding_2d`)."""
    init_world(device_type)
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % local:
        raise ValueError(f"LOCAL_WORLD_SIZE {local} does not divide the world size {world}")
    return init_device_mesh(device_type, (world // local, local),
                            mesh_dim_names=tuple(axis_names))


def chain_sharding_2d(mesh: DeviceMesh) -> ChainSharding:
    """A leading chains axis sharded over every device of the mesh."""
    return chain_sharding(mesh, tuple(mesh.mesh_dim_names))
