"""Adaptive tempered Sequential Monte Carlo over GP hyperparameters.

Counterpart of `gptools_tpu.infer.smc`. Particles live in the unconstrained
space; the path ``prior(u) * likelihood(u)^beta`` runs from beta = 0 to 1,
each next beta chosen by bisection on the ESS of the incremental weights;
systematic resampling; random-walk Metropolis mutations preconditioned by
the particle covariance, each one batched likelihood sweep over all
particles (`pt.model_splits_batched`: the CUDA evidence kernel on a card).
The host drives the beta loop, as in the reference. Randomness comes from
one explicit `torch.Generator`. With a mesh only the likelihood sweeps are
sharded (`parallel.mesh`): every rank holds the whole ensemble, so the
weights, the ESS bisection, the resampling and the beta loop's decisions
are every rank's alike. Each round is an ``smc.round`` span of the solve
(`utils.metrics`); the loop's reads of beta and the proposal factor's info
check are its host syncs (`metrics.HOST_SYNCS`).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from gptools_tpu_torch.infer.hmc import SampleResult
from gptools_tpu_torch.parallel.mesh import check_generators
from gptools_tpu_torch.utils import metrics

__all__ = ["sample", "smc_round", "SMCState"]


class SMCState(NamedTuple):
    u: torch.Tensor           # (N, P) particles (unconstrained)
    log_like: torch.Tensor    # (N,) cached log-likelihood terms
    log_prior: torch.Tensor   # (N,) cached prior (incl. log|det J|) terms
    beta: torch.Tensor        # 0-d inverse temperature
    log_z: torch.Tensor       # 0-d accumulated log evidence
    acc_rate: torch.Tensor    # 0-d last mutation acceptance rate


def _ess_fraction(log_w: torch.Tensor) -> torch.Tensor:
    lw = log_w - torch.logsumexp(log_w, 0)
    return torch.exp(-torch.logsumexp(2.0 * lw, 0)) / log_w.shape[0]


def _systematic_resample(generator: torch.Generator, log_w: torch.Tensor, n: int):
    lw = log_w - torch.logsumexp(log_w, 0)
    cum = torch.cumsum(torch.exp(lw), 0)
    u0 = torch.rand((), generator=generator, dtype=log_w.dtype, device=log_w.device)
    pts = (u0 + torch.arange(n, dtype=log_w.dtype, device=log_w.device)) / n
    idx = torch.searchsorted(cum, pts)
    return torch.clamp(idx, 0, n - 1)


def _next_beta(log_like: torch.Tensor, beta: torch.Tensor, ess_target: float,
               n_bisect: int = 30) -> torch.Tensor:
    """Largest beta' in (beta, 1] whose incremental weights keep
    ESS >= ess_target * N, by bisection (monotone in beta')."""
    one = torch.ones((), dtype=log_like.dtype, device=log_like.device)

    def ess_at(b):
        return _ess_fraction((b - beta) * log_like)

    full = ess_at(one)
    lo, hi = beta, one
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        ok = ess_at(mid) >= ess_target
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return torch.where(full >= ess_target, one, lo)


def smc_round(
    log_like_batched: Callable,
    log_prior_batched: Callable,
    state: SMCState,
    generator: torch.Generator,
    ess_target: float = 0.5,
    num_mutations: int = 5,
    proposal_scale: float = 1.0,
) -> SMCState:
    """One reweight -> resample -> mutate round."""
    n, p = state.u.shape
    dtype, dev = state.u.dtype, state.u.device

    beta_new = _next_beta(state.log_like, state.beta, ess_target)
    log_w = (beta_new - state.beta) * state.log_like
    # evidence increment: log mean of incremental weights
    log_z = state.log_z + torch.logsumexp(log_w, 0) - math.log(n)

    idx = _systematic_resample(generator, log_w, n)
    u = state.u[idx]
    log_like = state.log_like[idx]
    log_prior = state.log_prior[idx]

    # preconditioner from the (resampled, hence equal-weight) ensemble
    centered = u - u.mean(0)
    cov = centered.T @ centered / n + 1e-8 * torch.eye(p, dtype=dtype, device=dev)
    with metrics.host_sync("smc.cholesky"):  # its info check
        chol = torch.linalg.cholesky(cov)
    step = proposal_scale * 2.38 / math.sqrt(p)

    n_acc = torch.zeros((), dtype=dtype, device=dev)
    for _ in range(num_mutations):
        z = torch.randn((n, p), generator=generator, dtype=dtype, device=dev)
        prop = u + step * z @ chol.T
        ll_p = log_like_batched(prop)
        lp_p = log_prior_batched(prop)
        log_alpha = beta_new * ll_p + lp_p - (beta_new * log_like + log_prior)
        log_alpha = torch.where(torch.isnan(log_alpha), -math.inf, log_alpha)
        unif = torch.rand((n,), generator=generator, dtype=dtype, device=dev)
        accept = torch.log(unif) < log_alpha
        u = torch.where(accept[:, None], prop, u)
        log_like = torch.where(accept, ll_p, log_like)
        log_prior = torch.where(accept, lp_p, log_prior)
        n_acc = n_acc + accept.to(dtype).mean()

    return SMCState(
        u=u, log_like=log_like, log_prior=log_prior, beta=beta_new,
        log_z=log_z, acc_rate=n_acc / num_mutations,
    )


def _beta(state: SMCState) -> float:
    """The state's beta on the host (a counted host sync)."""
    with metrics.host_sync("smc.beta"):
        return float(state.beta)


@metrics.solve_entry
@torch.no_grad()
def sample(
    model,
    data,
    generator: torch.Generator,
    num_particles: int = 1024,
    ess_target: float = 0.5,
    num_mutations: int = 5,
    max_rounds: int = 100,
    verbose: bool = False,
    mesh=None,
    mesh_axis: Optional[str] = None,
) -> SampleResult:
    """Full adaptive-tempering SMC run on ``data``'s device and dtype.
    Returns equally-weighted posterior particles as a `SampleResult` (chains
    axis = 1) plus ``log_evidence`` in the diagnostics. ``mesh``: a
    `DeviceMesh` whose ``mesh_axis`` (default: its first dimension) shards
    the particles' likelihood sweeps; the particles are drawn at the global
    count on every rank, and every rank returns the same result."""
    from gptools_tpu_torch.infer.pt import log_prior_u_batched, model_splits_batched

    log_like_b = model_splits_batched(model, data, mesh, mesh_axis)
    log_prior_b = log_prior_u_batched(model)
    dtype, dev = data.dtype, data.device
    if mesh is not None:
        log_like_b.sharding.block(num_particles, "num_particles")
        check_generators(generator, log_like_b.sharding)

    thetas0 = model.hyperprior.sample(generator, (num_particles,), dtype).to(dev)
    u0 = model.u_of_theta(thetas0)
    # the initial sweep uses the batched likelihood (the reference's scalar
    # per-particle path gives the same values)
    state = SMCState(
        u=u0,
        log_like=log_like_b(u0),
        log_prior=log_prior_b(u0),
        beta=torch.zeros((), dtype=dtype, device=dev),
        log_z=torch.zeros((), dtype=dtype, device=dev),
        acc_rate=torch.ones((), dtype=dtype, device=dev),
    )

    n_rounds = 0
    betas = [0.0]
    while _beta(state) < 1.0 and n_rounds < max_rounds:
        with metrics.span("smc.round"):
            state = smc_round(
                log_like_b, log_prior_b, state, generator,
                ess_target=ess_target, num_mutations=num_mutations,
            )
            n_rounds += 1
            betas.append(_beta(state))
        if verbose:
            print(
                f"SMC round {n_rounds}: beta={float(state.beta):.4f} "
                f"acc={float(state.acc_rate):.2f} logZ={float(state.log_z):.2f}"
            )

    thetas = model.theta_of_u(state.u)
    diagnostics = {
        "log_evidence": state.log_z,
        "num_rounds": n_rounds,
        "beta_schedule": betas,
        "final_accept_rate": state.acc_rate,
    }
    return SampleResult(
        u=state.u[None],
        thetas=thetas[None],
        log_prob=(state.log_like + state.log_prior)[None],
        diagnostics=diagnostics,
    )
