"""Device meshes and chains sharded over them, on `torch.distributed`.

Counterpart of `gptools_tpu.parallel.mesh`. JAX runs one controller over
global arrays and GSPMD turns a mean over chains into an all-reduce; here
each card has its own process (SPMD, as ``torchrun`` starts them) in one
`torch.distributed` process group, and a mesh is a `DeviceMesh` with the
reference's axis names. The design:

- Only the density is sharded. Every rank holds the sampler's whole state,
  (C, P) positions and all, and makes the same draws at the global shape
  from a generator seeded alike on every rank (`check_generators`, at the
  start of each sharded call: a rank that drew differently would compute
  other chains, or hang at the next collective).
- A `ShardedDensity` computes the rank's block of C / W rows on the rank's
  card (where the model has an evidence kernel, one launch on C / W
  chains) and all-gathers the blocks' values, with their gradients packed
  beside them, into the global (C,) and (C, P): one collective per density
  call, through `torch.distributed` even at world size 1.
- The samplers' pooled statistics (dual averaging, ChEES's trajectory
  rule, Welford moments, SMC's weights, ESS bisection and resampling,
  NUTS's loop decisions) are computed on those replicated tensors. They
  need no collective of their own, come out the same on every rank, in the
  unsharded run's order, so a sharded run repeats the unsharded run's
  draws. The reference's all-reduce of each pooled statistic becomes the
  density's all-gather; every rank repeats the sampler's O(C P)
  arithmetic, small at P <= 6 beside the density.

That last step holds only while each chain's log density and gradient
are the same bits whatever the batch it is computed in: its width and
the chain's place in it. The sites that hold it, on the CPU and on the
card, in float64 and float32 (`tests/test_torch_width.py`;
`chip_smoke.py` phase 9d):

- the evidence kernel, one warp per chain (`ops.evidence_cuda`);
- `ops.fused._ExpandRow` (through `_expand_rows`), which expands a
  chain's factors to the pairs or points it meets and sums the
  cotangents back in an order fixed by the row count: the symmetric
  chains-minor builders (`_pairs_sym`, `gibbs_tanh_cov_fused_soa_sym`),
  the warped builder `coords_cov_soa_sym` and the BetaWarp rows of
  `warp_coords`, so also the kernel's plain version;
- `models.mean.mean_vector`, which expands each mean parameter to the
  points before the (elementwise) mean, and the noise channel of
  `models.gp.GPModel._evidence_inputs`;
- `ops.assemble.delta_matrix`, which expands a theta batch's noise
  values to the matrix entries (the noise kernel of the routes);
- `ops.evidence._mean_diag` (the relative jitter), which sums each
  matrix's diagonal as a row of its own: over the strided diagonal of a
  chains-minor batch the CPU grouped the matrices by the batch's width;
- `models.gp._pad_rows`: on the card both routes
  (`GPModel._chains_minor_batch`, the chunks of `_per_chain_batch`)
  compute at least `_ROUTE_MIN_CHAINS` chains, since the batched
  Cholesky, solves, index gathers' backward and ``T K T^T`` product take
  other algorithms for a few matrices or columns than for many.

The rule for new code on the density's path: a per-chain value (C,)
that meets a per-point or per-pair axis is expanded by `_expand_rows`
(after the arithmetic that involves the chain alone), never broadcast,
since autograd's sum over a broadcast axis, and any reduction of the
card's, splits its work by the tensor's shape; and on the card no
library call sees fewer chains than `_ROUTE_MIN_CHAINS`.

Public functions that take a mesh take and return the global batch, as
the reference's global-view arrays do. `COLLECTIVE_CALLS` counts the
collectives, by purpose.
"""

from __future__ import annotations

import socket
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from gptools_tpu_torch.infer import hmc as _hmc

__all__ = [
    "CHAIN_AXIS",
    "COLLECTIVE_CALLS",
    "ChainSharding",
    "ShardedDensity",
    "init_world",
    "reset_counts",
    "make_mesh",
    "chain_sharding",
    "shard_chains",
    "check_generators",
    "sharded_sample",
    "sharded_smc",
    "training_step_sharded",
    "pt_step_sharded",
]

CHAIN_AXIS = "chains"

# collectives made: "density" (a ShardedDensity's gather), "check" (the
# generators' states)
COLLECTIVE_CALLS = {"density": 0, "check": 0}


def reset_counts() -> None:
    for k in COLLECTIVE_CALLS:
        COLLECTIVE_CALLS[k] = 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_world(device_type: str = "cuda", backend: Optional[str] = None) -> None:
    """Make sure a default process group exists: where none is
    initialized, a world of one through a TCP store on 127.0.0.1 at a free
    port (``nccl`` for ``cuda``, ``gloo`` for ``cpu``, unless ``backend``
    says otherwise). ``cuda`` needs a card."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: meshes are built on the cards by default; pass "
            "device_type='cpu' for the CPU"
        )
    if dist.is_initialized():
        return
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    store = dist.TCPStore("127.0.0.1", _free_port(), 1, is_master=True)
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, store=store, rank=0, world_size=1, **kw)


def make_mesh(
    num_devices: Optional[int] = None,
    axis_name: str = CHAIN_AXIS,
    device_type: str = "cuda",
    backend: Optional[str] = None,
) -> DeviceMesh:
    """1-D mesh named ``axis_name`` over every rank of the default process
    group (one made by `init_world` where none is initialized).
    ``num_devices``, when given, must be the group's size."""
    init_world(device_type, backend)
    world = dist.get_world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(
            f"num_devices {num_devices}: the mesh spans the process group's "
            f"{world} ranks (start that many processes)"
        )
    return init_device_mesh(device_type, (world,), mesh_dim_names=(axis_name,))


class ChainSharding(NamedTuple):
    """This rank's share of a leading (chains) axis: one of ``count``
    contiguous blocks, the ``index``-th (its rank in ``group``, the order
    of the gather), computed on ``device``."""

    group: object
    count: int
    index: int
    device: torch.device

    def block(self, n: int, what: str = "num_chains") -> slice:
        """The rows of this rank's block of ``n``; ValueError unless the
        blocks divide ``n``."""
        if n % self.count:
            raise ValueError(f"{what} {n} must be a multiple of mesh size {self.count}")
        b = n // self.count
        return slice(self.index * b, (self.index + 1) * b)


def chain_sharding(mesh: DeviceMesh, axis_name=CHAIN_AXIS) -> ChainSharding:
    """The leading-axis sharding over ``axis_name``, a dimension of the
    mesh (None: its first), or a tuple of all its dimensions, which shards
    over their flattened product (`distributed.chain_sharding_2d`). Ranks
    that differ only in other dimensions hold the same block."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis_name is None:
        axis_name = names[0]
    if isinstance(axis_name, str):
        if axis_name not in names:
            raise ValueError(f"mesh has no dimension {axis_name!r} (it has {names})")
        group = mesh.get_group(axis_name)
    elif tuple(axis_name) == names:
        if mesh.size() != dist.get_world_size():
            raise ValueError("sharding over every mesh dimension needs a mesh of every rank")
        group = dist.group.WORLD
    else:
        raise ValueError(
            f"shard over one mesh dimension or all of them {names}, not {tuple(axis_name)}"
        )
    if mesh.device_type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device(mesh.device_type)
    return ChainSharding(group, dist.get_world_size(group), dist.get_rank(group), device)


def _tree_map(fn, tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_chains(tree, mesh: DeviceMesh, axis_name=CHAIN_AXIS):
    """This rank's block of the leading axis of every tensor in ``tree``
    (dicts, lists, tuples, NamedTuples), on the rank's device; a 0-d
    tensor (a pooled statistic) is moved there whole."""
    sh = chain_sharding(mesh, axis_name)

    def take(x):
        if not torch.is_tensor(x):
            return x
        return (x[sh.block(x.shape[0])] if x.dim() else x).to(sh.device)

    return _tree_map(take, tree)


def _gather(block: torch.Tensor, sh: ChainSharding, purpose: str) -> list:
    block = block.contiguous()
    parts = [torch.empty_like(block) for _ in range(sh.count)]
    dist.all_gather(parts, block, group=sh.group)
    COLLECTIVE_CALLS[purpose] += 1
    return parts


def check_generators(generator: torch.Generator, sharding: ChainSharding) -> None:
    """Raise unless every rank's generator is in the same state."""
    parts = _gather(generator.get_state().to(sharding.device), sharding, "check")
    if any(not torch.equal(p, parts[0]) for p in parts[1:]):
        raise RuntimeError(
            "the ranks' generators differ: a sharded run needs the same seed "
            "and the same draws on every rank"
        )


class ShardedDensity:
    """A batched density (C, P) -> (C,) with its rows sharded over a mesh
    dimension (`chain_sharding`): each call computes the rank's block,
    ``logp(q_block, *row_blocks)`` with ``row_args`` (tensors with a row
    per chain, as per-lane inverse temperatures) cut alike, and
    all-gathers the blocks, so every rank returns the global (C,). Under
    autograd the block's gradient is taken on the rank and gathered with
    its value (`value_and_grad`, which `infer.hmc.value_and_grad` returns
    for this density): nothing is differentiated through a collective."""

    def __init__(self, logp: Callable, mesh: DeviceMesh, mesh_axis=None, row_args=()):
        self.logp = logp
        self.sharding = chain_sharding(mesh, mesh_axis)
        self.row_args = tuple(row_args)

    def _block(self, qs: torch.Tensor):
        if qs.device.type != self.sharding.device.type:
            raise ValueError(f"chains on {qs.device}, the mesh on {self.sharding.device.type}")
        rows = self.sharding.block(qs.shape[0])
        return qs[rows], [a[rows] for a in self.row_args]

    def value_and_grad(self, qs: torch.Tensor):
        """The global values (C,) and gradients (C, P): the rank's block
        by `infer.hmc.value_and_grad`, gathered in one collective."""
        q, args = self._block(qs)
        v, g = _hmc.value_and_grad(lambda x: self.logp(x, *args))(q)
        out = torch.cat(_gather(torch.cat([v[:, None].to(g.dtype), g], 1), self.sharding,
                                "density"))
        return out[:, 0].contiguous(), out[:, 1:].contiguous()

    def __call__(self, qs: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and qs.requires_grad:
            return _hmc.ValueWithGrad.apply(self.value_and_grad, qs)
        q, args = self._block(qs)
        with torch.no_grad():
            v = self.logp(q, *args)
        return torch.cat(_gather(v, self.sharding, "density"))


def sharded_sample(
    logp: Callable,
    u0: torch.Tensor,
    generator: torch.Generator,
    mesh: Optional[DeviceMesh] = None,
    sampler: str = "nuts",
    **kwargs,
):
    """NUTS (``sampler="nuts"``) or windowed HMC with the chains of ``u0``
    (num_chains, P) sharded over the mesh's first dimension (default:
    `make_mesh`); every rank returns the global `SampleResult`."""
    from gptools_tpu_torch.infer import nuts as _nuts

    if mesh is None:
        mesh = make_mesh()
    density = logp if isinstance(logp, ShardedDensity) else ShardedDensity(logp, mesh)
    density.sharding.block(u0.shape[0])
    check_generators(generator, density.sharding)
    mod = _nuts if sampler == "nuts" else _hmc
    return mod.sample(density, u0, generator, **kwargs)


def sharded_smc(model, data, generator: torch.Generator, mesh: Optional[DeviceMesh] = None,
                **kwargs):
    """Tempered SMC with the particles' likelihood sweeps sharded over the
    mesh (default: `make_mesh`); the weights, ESS bisection and resampling
    run on the replicated ensemble (`infer.smc.sample`)."""
    from gptools_tpu_torch.infer import smc as _smc

    if mesh is None:
        mesh = make_mesh()
    return _smc.sample(model, data, generator, mesh=mesh, **kwargs)


def training_step_sharded(model, data, mesh: DeviceMesh, num_chains: int):
    """One sampling step over sharded chains, the "training step" of this
    engine: a NUTS transition of every chain (`nuts.nuts_transition_builder`,
    max_depth 8) on the sharded density, then the pooled dual-averaging
    update. Returns ``(step_fn, (u0, da0, inv_mass0))`` with
    ``step_fn(qs, generator, da, inv_mass) -> (qs, logp, da, stats)``."""
    from gptools_tpu_torch.infer import model_logp
    from gptools_tpu_torch.infer import nuts as _nuts

    density = ShardedDensity(model_logp(model, data), mesh)
    density.sharding.block(num_chains)
    transition = _nuts.nuts_transition_builder(max_depth=8)(_hmc.value_and_grad(density))

    @torch.no_grad()
    def step(qs, generator, da, inv_mass):
        check_generators(generator, density.sharding)
        q, logp, _, stats = transition(qs, None, None, generator, torch.exp(da.log_eps),
                                       inv_mass)
        return q, logp, _hmc.da_update(da, stats["accept_prob"].mean()), stats

    nf, dtype, dev = model.num_free_params, data.dtype, data.device
    u0 = torch.zeros((num_chains, nf), dtype=dtype, device=dev)
    da0 = _hmc.da_init(torch.tensor(0.1, dtype=dtype, device=dev))
    inv_mass0 = torch.ones((nf,), dtype=dtype, device=dev)
    return step, (u0, da0, inv_mass0)


def pt_step_sharded(
    model,
    data,
    mesh: DeviceMesh,
    num_temps: int,
    num_chains: int,
    num_steps: int = 8,
    beta_min: float = 0.1,
):
    """One parallel-tempering sweep with the T * C (rung, chain) lanes
    sharded over the whole mesh (its dimensions flattened): each lane's
    fixed-length HMC transition on the sharded tempered density, then the
    even/odd swaps on the replicated (T, C, P) state. Returns ``(step_fn,
    (u0, eps0, inv_mass0))`` with ``step_fn(u, generator, eps, inv_mass,
    step_idx) -> (u, ll, swap_frac, accept)``."""
    from gptools_tpu_torch.infer import pt as _pt

    dtype, dev = data.dtype, data.device
    betas = _pt.geometric_ladder(num_temps, beta_min, dtype, dev)
    T = betas.shape[0]
    log_like_fn, log_prior_fn = _pt.model_splits(model, data)
    density = ShardedDensity(_pt.tempered_logp(log_like_fn, log_prior_fn), mesh,
                             tuple(mesh.mesh_dim_names), row_args=(betas.repeat_interleave(num_chains),))
    density.sharding.block(T * num_chains, "num_temps * num_chains")
    lg = _hmc.value_and_grad(density)

    @torch.no_grad()
    def step(u, generator, eps, inv_mass, step_idx):
        check_generators(generator, density.sharding)
        u, ll, _, stats, swap_frac = _pt._sweep(lg, log_prior_fn, u, betas, eps, inv_mass,
                                                generator, int(step_idx) % 2, num_steps, 0.2)
        return u, ll, swap_frac, stats["accept_prob"]

    nf = model.num_free_params
    u0 = torch.zeros((T, num_chains, nf), dtype=dtype, device=dev)
    eps0 = torch.full((T,), 0.1, dtype=dtype, device=dev)
    inv_mass0 = torch.ones((T, nf), dtype=dtype, device=dev)
    return step, (u0, eps0, inv_mass0)
