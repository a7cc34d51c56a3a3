"""SMC-initialized NUTS and ChEES-HMC: the flagship inference pipelines.

Counterpart of `gptools_tpu.infer.pipeline`: tempered SMC to beta = 1
gives a posterior particle ensemble and its moments; many chains start
from a resample of it. With ``whiten=True`` they run in the whitened
coordinates ``v = C^{-1} (u - mu)`` (C C^T the ensemble covariance; the
affine map has a constant Jacobian, so the density needs no correction);
with ``whiten=False`` they run in u with the ensemble variance as a frozen
diagonal inverse mass. The reference's per-(model, data) closure cache and
warm-compile threads exist only for XLA's compile cache and have no
counterpart here. With ``mesh`` (a `DeviceMesh`) the SMC particles' and
the chains' densities are sharded over ``mesh_axis`` (default: the mesh's
first dimension; `parallel.mesh.ShardedDensity`, the whitening's affine
map computed on each rank's block) and every rank returns the same global
result. A pipeline's phases are spans of its solve (`utils.metrics`):
``solve.warm_start``, ``solve.whitening``, the sampler's ``solve.warmup``
and ``solve.sampling``, and ``solve.finish``.
"""

from __future__ import annotations

from typing import Optional

import torch

from gptools_tpu_torch.infer import chees as _chees
from gptools_tpu_torch.infer import model_logp
from gptools_tpu_torch.infer import nuts as _nuts
from gptools_tpu_torch.infer import smc as _smc
from gptools_tpu_torch.infer.hmc import SampleResult
from gptools_tpu_torch.parallel.mesh import ShardedDensity, chain_sharding
from gptools_tpu_torch.utils import metrics

__all__ = ["smc_then_nuts", "smc_then_chees"]


def _whiten_init(C: torch.Tensor, mu: torch.Tensor, u0: torch.Tensor) -> torch.Tensor:
    """v0 = C^{-1} (u0 - mu), rowwise."""
    return torch.linalg.solve_triangular(C, (u0 - mu).T, upper=False).T


def _unwhiten_samples(C: torch.Tensor, mu: torch.Tensor, vs: torch.Tensor) -> torch.Tensor:
    """u = mu + C v over a (chains, samples, P) stack."""
    return mu + torch.einsum("ij,csj->csi", C, vs)


def _sharded(logp, mesh, mesh_axis):
    """``logp`` with its chains sharded over the mesh, or as is without
    one."""
    return logp if mesh is None else ShardedDensity(logp, mesh, mesh_axis)


def _check_chains(mesh, mesh_axis, num_chains):
    """ValueError unless the mesh dimension divides the chains (as the
    reference's ``_chain_sharding``), before any work."""
    if mesh is not None:
        chain_sharding(mesh, mesh_axis).block(num_chains)


def _warm_start(model, data, generator, num_chains, num_particles, smc_kwargs, mesh,
                mesh_axis):
    """SMC to beta = 1, then ``num_chains`` starts resampled from its
    particles. Returns (SMC result, particles (N, P), starts (C, P))."""
    with metrics.span("solve.warm_start"):
        smc_res = _smc.sample(
            model, data, generator, num_particles=num_particles, mesh=mesh,
            mesh_axis=mesh_axis, **(smc_kwargs or {})
        )
        particles = smc_res.u[0]
        idx = torch.randint(
            0, particles.shape[0], (num_chains,), generator=generator, device=particles.device
        )
        return smc_res, particles, particles[idx]


def _whitening(model, data, particles: torch.Tensor):
    """(mu, C, logp_w): the particles' mean, the Cholesky factor of their
    covariance (+1e-8 I) and the batched density in v = C^{-1} (u - mu)."""
    P = particles.shape[1]
    cov = torch.cov(particles.T) + 1e-8 * torch.eye(
        P, dtype=particles.dtype, device=particles.device
    )
    mu = particles.mean(0)
    with metrics.host_sync("whitening.cholesky"):  # its info check
        C = torch.linalg.cholesky(cov)

    def logp_w(vs):
        return model.log_posterior_u_batch(vs @ C.T + mu, data)

    return mu, C, logp_w


def _finish(model, res: SampleResult, smc_res) -> SampleResult:
    # the bijector is batched, so theta_of_u takes the whole stack (the
    # reference's double-vmapped `_embed2`)
    res = res._replace(thetas=model.theta_of_u(res.u))
    res.diagnostics["smc_log_evidence"] = smc_res.diagnostics["log_evidence"]
    res.diagnostics["smc_rounds"] = smc_res.diagnostics["num_rounds"]
    return res


@metrics.solve_entry
@torch.no_grad()
def smc_then_nuts(
    model,
    data,
    generator: torch.Generator,
    num_chains: int = 1024,
    num_warmup: int = 150,
    num_samples: int = 350,
    num_particles: int = 1024,
    max_depth: int = 8,
    target_accept: float = 0.85,
    whiten: bool = True,
    smc_kwargs: Optional[dict] = None,
    mesh=None,
    mesh_axis: Optional[str] = None,
) -> SampleResult:
    """SMC warm start + NUTS chains on ``data``'s device and dtype.
    ``whiten=True`` runs NUTS in the SMC-whitened coordinates (step size
    adapted from 0.3, no mass adaptation); ``whiten=False`` in u with the
    SMC variance as a frozen diagonal inverse mass."""
    _check_chains(mesh, mesh_axis, num_chains)
    smc_res, particles, u0 = _warm_start(
        model, data, generator, num_chains, num_particles, smc_kwargs, mesh, mesh_axis
    )
    kw = dict(num_warmup=num_warmup, num_samples=num_samples, max_depth=max_depth,
              target_accept=target_accept, adapt_mass=False)
    if whiten:
        with metrics.span("solve.whitening"):
            mu, C, logp_w = _whitening(model, data, particles)
            v0 = _whiten_init(C, mu, u0)
        res = _nuts.sample(_sharded(logp_w, mesh, mesh_axis), v0, generator, eps0=0.3, **kw)
    else:
        var = particles.var(0, unbiased=False) + 1e-10
        res = _nuts.sample(_sharded(model_logp(model, data), mesh, mesh_axis), u0, generator,
                           inv_mass0=var, **kw)
    with metrics.span("solve.finish"):
        if whiten:
            res = res._replace(u=_unwhiten_samples(C, mu, res.u))
        return _finish(model, res, smc_res)


@metrics.solve_entry
@torch.no_grad()
def smc_then_chees(
    model,
    data,
    generator: torch.Generator,
    num_chains: int = 2048,
    num_warmup: int = 150,
    num_samples: int = 350,
    num_particles: int = 1024,
    target_accept: float = 0.75,
    max_steps: int = 256,
    whiten: bool = True,
    smc_kwargs: Optional[dict] = None,
    chees_kwargs: Optional[dict] = None,
    cost_normalize: bool = True,
    cost_elasticity: float = 0.6,
    mesh=None,
    mesh_axis: Optional[str] = None,
) -> SampleResult:
    """SMC warm start + ChEES-HMC chains on ``data``'s device and dtype,
    whitened (``whiten=True``, step size from 0.3) or in u with the SMC
    variance as the inverse mass (``whiten=False``, step size from 0.1).
    ``cost_normalize`` / ``cost_elasticity``: the trajectory-time rule and
    its calibrated equilibrium, as in the reference; both, and ``eps0`` and
    ``inv_mass0``, may be overridden via ``chees_kwargs``."""
    _check_chains(mesh, mesh_axis, num_chains)
    ck = {"cost_normalize": cost_normalize, "cost_elasticity": cost_elasticity}
    ck.update(chees_kwargs or {})
    target_accept = ck.pop("target_accept", target_accept)
    max_steps = ck.pop("max_steps", max_steps)

    smc_res, particles, u0 = _warm_start(
        model, data, generator, num_chains, num_particles, smc_kwargs, mesh, mesh_axis
    )
    kw = dict(num_warmup=num_warmup, num_samples=num_samples, target_accept=target_accept,
              max_steps=max_steps)
    if whiten:
        with metrics.span("solve.whitening"):
            mu, C, logp_w = _whitening(model, data, particles)
            v0 = _whiten_init(C, mu, u0)
        res = _chees.sample(_sharded(logp_w, mesh, mesh_axis), v0, generator,
                            eps0=ck.pop("eps0", 0.3), **kw, **ck)
    else:
        var = particles.var(0, unbiased=False) + 1e-10
        res = _chees.sample(_sharded(model_logp(model, data), mesh, mesh_axis), u0, generator,
                            eps0=ck.pop("eps0", 0.1), inv_mass0=ck.pop("inv_mass0", var),
                            **kw, **ck)
    with metrics.span("solve.finish"):
        if whiten:
            res = res._replace(u=_unwhiten_samples(C, mu, res.u))
        return _finish(model, res, smc_res)
