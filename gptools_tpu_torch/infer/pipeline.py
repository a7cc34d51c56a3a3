"""SMC-initialized ChEES-HMC: the flagship inference pipeline.

Counterpart of `gptools_tpu.infer.pipeline.smc_then_chees`: tempered SMC to
beta = 1 gives a posterior particle ensemble and its moments; many ChEES
chains start from a resample of it and run in the whitened coordinates
``v = C^{-1} (u - mu)`` (C C^T the ensemble covariance). The affine map has
a constant Jacobian, so the density needs no correction. The reference's
per-(model, data) closure cache and warm-compile threads exist only for
XLA's compile cache and have no counterpart here. Not ported yet: the
unwhitened variant (``whiten=False``), `smc_then_nuts` and the mesh path
(ROADMAP Queue 1 items 13 and 14).
"""

from __future__ import annotations

from typing import Optional

import torch

from gptools_tpu_torch.infer import chees as _chees
from gptools_tpu_torch.infer import smc as _smc
from gptools_tpu_torch.infer.hmc import SampleResult

__all__ = ["smc_then_chees"]


def _whiten_init(C: torch.Tensor, mu: torch.Tensor, u0: torch.Tensor) -> torch.Tensor:
    """v0 = C^{-1} (u0 - mu), rowwise."""
    return torch.linalg.solve_triangular(C, (u0 - mu).T, upper=False).T


def _unwhiten_samples(C: torch.Tensor, mu: torch.Tensor, vs: torch.Tensor) -> torch.Tensor:
    """u = mu + C v over a (chains, samples, P) stack."""
    return mu + torch.einsum("ij,csj->csi", C, vs)


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
    smc_kwargs: Optional[dict] = None,
    chees_kwargs: Optional[dict] = None,
    cost_normalize: bool = True,
    cost_elasticity: float = 0.6,
) -> SampleResult:
    """SMC warm start + whitened ChEES-HMC chains on ``data``'s device and
    dtype. ``cost_normalize`` / ``cost_elasticity``: the trajectory-time
    rule and its calibrated equilibrium, as in the reference; both may be
    overridden via ``chees_kwargs``."""
    ck = {"cost_normalize": cost_normalize, "cost_elasticity": cost_elasticity}
    ck.update(chees_kwargs or {})
    target_accept = ck.pop("target_accept", target_accept)
    max_steps = ck.pop("max_steps", max_steps)
    eps0 = ck.pop("eps0", 0.3)

    smc_res = _smc.sample(
        model, data, generator, num_particles=num_particles, **(smc_kwargs or {})
    )
    particles = smc_res.u[0]
    n = particles.shape[0]
    idx = torch.randint(
        0, n, (num_chains,), generator=generator, device=particles.device
    )
    u0 = particles[idx]

    mu = particles.mean(0)
    P = particles.shape[1]
    cov = torch.cov(particles.T) + 1e-8 * torch.eye(
        P, dtype=particles.dtype, device=particles.device
    )
    C = torch.linalg.cholesky(cov)
    v0 = _whiten_init(C, mu, u0)

    def logp_w(vs):
        return model.log_posterior_u_batch(vs @ C.T + mu, data)

    res = _chees.sample(
        logp_w,
        v0,
        generator,
        num_warmup=num_warmup,
        num_samples=num_samples,
        target_accept=target_accept,
        eps0=eps0,
        max_steps=max_steps,
        **ck,
    )
    u = _unwhiten_samples(C, mu, res.u)
    # the bijector is batched, so theta_of_u takes the whole stack (the
    # reference's double-vmapped `_embed2`)
    res = res._replace(u=u, thetas=model.theta_of_u(u))
    res.diagnostics["smc_log_evidence"] = smc_res.diagnostics["log_evidence"]
    res.diagnostics["smc_rounds"] = smc_res.diagnostics["num_rounds"]
    return res
