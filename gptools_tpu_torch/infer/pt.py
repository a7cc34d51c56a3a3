"""Parallel tempering (replica-exchange HMC) over GP hyperparameters, and
the likelihood / prior split of the unconstrained density it needs.

Counterpart of `gptools_tpu.infer.pt`. The ladder is a leading axis:
positions are (T, C, P), T temperatures by C chains per rung, and each rung
targets ``beta_t * log_like(u) + log_prior_u(u)`` (likelihood-only
tempering; the prior, with the bijector's log-Jacobian, stays cold). One
sweep advances every (rung, chain) lane by a fixed-length HMC transition
whose every leapfrog is one batched density call over all T * C lanes
(each lane's beta applied to its log-likelihood), then adjacent rungs
propose even/odd alternating swaps, pair (t, t+1) accepting with
probability ``min(1, exp((beta_t - beta_{t+1}) (ll_{t+1} - ll_t)))``. Step
sizes adapt per rung by dual averaging pooled over the rung's chains, and
the diagonal mass per rung from pooled Welford moments at the slow windows'
ends. The reference's compiled chunk programs (``_pt_chunk_program``,
``_make_chunk_runner``) serve XLA's compilation and have no counterpart.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from gptools_tpu_torch.infer import _attach_thetas, _initial_positions, _per_data, hmc
from gptools_tpu_torch.infer.hmc import SampleResult

__all__ = [
    "model_splits",
    "model_splits_batched",
    "log_prior_u_batched",
    "tempered_logp_and_grad",
    "geometric_ladder",
    "sample",
]


def model_splits_batched(model, data):
    """Batched u-space log-likelihood ``us (N, Pf) -> (N,)``."""

    def log_like_batched(us):
        return model.log_marginal_batch(model.theta_of_u(us), data)

    return log_like_batched


def log_prior_u_batched(model):
    """Batched u-space log prior plus log|det J|: ``us (N, Pf) -> (N,)``."""

    def log_prior_batched(us):
        u_full = model._u_full(us)
        theta = model.bijector.forward(u_full)
        return model.log_prior(theta) + model.bijector.log_det_jac(u_full)

    return log_prior_batched


def model_splits(model, data):
    """``(log_like, log_prior)`` of the model's u-space density, both
    batched (`model_splits_batched`, `log_prior_u_batched`), with one
    identity per (model, data), as the reference's cache gives them."""
    return _per_data(model, "_model_splits_cache", data,
                     lambda: (model_splits_batched(model, data), log_prior_u_batched(model)))


def tempered_logp_and_grad(log_like_fn: Callable, log_prior_fn: Callable, beta):
    """Batched value and gradient of ``beta * log_like(u) + log_prior_u(u)``
    (``beta`` 0-d or one per row), with the reference's guard: where the
    prior is out of support the likelihood is taken as 0."""

    def f(q):
        lp = log_prior_fn(q)
        ll = torch.where(torch.isfinite(lp), log_like_fn(q), 0.0)
        return beta * ll + lp

    return hmc.value_and_grad(f)


def geometric_ladder(num_temps: int, beta_min: float = 0.1, dtype=torch.float64,
                     device=None) -> torch.Tensor:
    """Geometric inverse-temperature ladder ``beta_0 = 1 > ... >
    beta_{T-1} = beta_min``."""
    if num_temps < 2:
        return torch.ones((max(num_temps, 1),), dtype=dtype, device=device)
    t = torch.arange(num_temps, dtype=dtype, device=device) / (num_temps - 1)
    return torch.exp(t * torch.log(torch.tensor(beta_min, dtype=dtype, device=device)))


def _swap_step(arrays: Sequence[torch.Tensor], ll, betas, unif, parity: int):
    """One even/odd replica-exchange sweep, branchless. ``arrays`` are
    per-(rung, chain) states (T, C, ...) permuted together with the (T, C)
    log-likelihood table ``ll``; ``unif`` (T-1, C) are the acceptance
    uniforms. Returns (permuted arrays, permuted ll, accepted fraction per
    pair (T-1,))."""
    T, C = ll.shape
    pair = torch.arange(T - 1, device=ll.device)
    active = (pair % 2) == parity
    log_acc = (betas[:-1] - betas[1:])[:, None] * (ll[1:] - ll[:-1])
    accept = (torch.log(unif) < log_acc) & active[:, None]
    zero = torch.zeros((1, C), dtype=torch.bool, device=ll.device)
    take_next = torch.cat([accept, zero], 0)   # rung t <- t+1
    take_prev = torch.cat([zero, accept], 0)   # rung t <- t-1

    def permute(x):
        shape = take_next.shape + (1,) * (x.dim() - 2)
        up = torch.roll(x, -1, 0)   # x[t+1] at slot t
        dn = torch.roll(x, 1, 0)    # x[t-1] at slot t
        return torch.where(take_next.reshape(shape), up,
                           torch.where(take_prev.reshape(shape), dn, x))

    swap_frac = accept.sum(1).to(ll.dtype) / C
    return [permute(x) for x in arrays], permute(ll), swap_frac


def _sweep(log_like_fn, log_prior_fn, u, betas, eps, inv_mass, generator, parity: int,
           num_steps: int, jitter: float):
    """One HMC sweep of every lane, then one swap sweep. ``u`` (T, C, P),
    ``eps`` (T,), ``inv_mass`` (T, P). Returns (u, ll, lp, stats, swap
    fraction), the tables (T, C)."""
    T, C, P = u.shape
    lane_beta = betas.repeat_interleave(C)
    lg = tempered_logp_and_grad(log_like_fn, log_prior_fn, lane_beta)
    q = u.reshape(T * C, P)
    q_new, logp_beta, _, stats = hmc._hmc_transition(
        lg, q, *lg(q), generator, eps.repeat_interleave(C),
        inv_mass.repeat_interleave(C, 0), num_steps, jitter)
    lp = log_prior_fn(q_new)
    ll = ((logp_beta - lp) / lane_beta).reshape(T, C)
    unif = torch.rand((T - 1, C), generator=generator, dtype=u.dtype, device=u.device)
    (u_new, lp), ll, swap_frac = _swap_step(
        [q_new.reshape(T, C, P), lp.reshape(T, C)], ll, betas, unif, parity)
    stats = {k: v.reshape(T, C) for k, v in stats.items()}
    return u_new, ll, lp, stats, swap_frac


def sample_tempered(log_like_fn: Callable, log_prior_fn: Callable, u0: torch.Tensor,
                    generator: torch.Generator, betas: torch.Tensor, num_samples: int = 1000,
                    num_warmup: int = 500, num_steps: int = 32, target_accept: float = 0.8,
                    eps0: float = 0.1, jitter: float = 0.2,
                    adapt_mass: bool = True) -> SampleResult:
    """Replica-exchange HMC from ``u0`` (T, C, P) on the ladder ``betas``
    (T,), the densities batched (N, P) -> (N,). Returns the cold rung
    (chains, samples, P) with the reference's diagnostics and
    ``divergences_by_rung`` (the sampling phase's, per rung); ``thetas``
    None."""
    T, C, P = u0.shape
    dtype, dev = u0.dtype, u0.device
    da = hmc.da_init(torch.full((T,), eps0, dtype=dtype, device=dev))
    inv_mass = torch.ones((T, P), dtype=dtype, device=dev)
    u, step = u0, 0
    div_warmup = torch.zeros((), dtype=torch.int64, device=dev)
    swap_fracs = []

    def run(length, adapt, welford, keep):
        nonlocal u, step, da
        outs = {"u": [], "log_prob": [], "accept_prob": []}
        div = torch.zeros((T,), dtype=torch.int64, device=dev)
        for _ in range(length):
            eps = torch.exp(da.log_eps if adapt else da.log_eps_avg)
            u, ll, lp, stats, frac = _sweep(log_like_fn, log_prior_fn, u, betas, eps,
                                            inv_mass, generator, step % 2, num_steps, jitter)
            step += 1
            if adapt:
                da = hmc.da_update(da, stats["accept_prob"].mean(1), target=target_accept)
            if welford is not None:
                welford = hmc.welford_update_batch(welford, u)
            div = div + stats["diverged"].sum(1)
            swap_fracs.append(frac)
            if keep:
                outs["u"].append(u[0])
                outs["log_prob"].append(ll[0] + lp[0])  # beta_0 = 1: the posterior
                outs["accept_prob"].append(stats["accept_prob"])
        return welford, div, outs

    for phase, length in hmc.warmup_schedule(num_warmup):
        collect = phase == "slow" and adapt_mass
        welford = hmc.welford_init(P, dtype, dev, lead=(T,)) if collect else None
        welford, div, _ = run(length, True, welford, False)
        div_warmup = div_warmup + div.sum()
        if collect:
            # close the slow window: the pooled variance becomes each rung's
            # mass, and dual averaging restarts (Stan's recipe)
            inv_mass = hmc.welford_variance(welford)
            da = hmc.da_init(torch.exp(da.log_eps_avg))

    # frozen adaptation; collect the cold rung
    eps_final = torch.exp(da.log_eps_avg)
    da = da._replace(log_eps=torch.log(eps_final))
    _, divergences, outs = run(num_samples, False, None, True)
    acc = torch.stack(outs["accept_prob"], 0)  # (S, T, C)
    diagnostics = {
        "step_size": eps_final,
        "betas": betas,
        # each pair is active every other sweep: twice the raw mean
        "swap_accept": torch.stack(swap_fracs, 0).mean(0) * 2.0,
        "accept_prob": acc[:, 0, :].T,
        "divergences": divergences.sum(),
        "divergences_warmup": div_warmup,
        "mean_accept": acc.mean(),
        "divergences_by_rung": divergences,  # sampling, per rung (T,)
    }
    return SampleResult(u=torch.stack(outs["u"], 1), thetas=None,
                        log_prob=torch.stack(outs["log_prob"], 1), diagnostics=diagnostics)


@torch.no_grad()
def sample(
    model,
    data,
    generator: torch.Generator,
    num_chains: int = 8,
    num_samples: int = 1000,
    num_warmup: int = 500,
    num_temps: int = 8,
    beta_min: float = 0.1,
    num_steps: int = 32,
    target_accept: float = 0.8,
    eps0: float = 0.1,
    jitter: float = 0.2,
    adapt_mass: bool = True,
    init: str = "prior",
    metrics=None,
) -> SampleResult:
    """Replica-exchange HMC posterior sampling on ``data``'s device and
    dtype (``num_temps`` plays the reference's ``ntemps``). Returns the cold
    (beta = 1) rung as a `SampleResult`; a sweep costs ``num_steps + 1``
    batched density calls over ``num_temps * num_chains`` lanes."""
    if metrics is not None:
        raise NotImplementedError("metrics= needs utils/metrics.py: ROADMAP Queue 1 item 15")
    dtype, dev = data.dtype, data.device
    betas = geometric_ladder(num_temps, beta_min, dtype, dev)
    T, P = betas.shape[0], model.num_free_params
    log_like_fn, log_prior_fn = model_splits(model, data)
    u0 = _initial_positions(model, generator, T * num_chains, init, dtype, dev)
    res = sample_tempered(
        log_like_fn, log_prior_fn, u0.reshape(T, num_chains, P), generator, betas,
        num_samples=num_samples, num_warmup=num_warmup, num_steps=num_steps,
        target_accept=target_accept, eps0=eps0, jitter=jitter, adapt_mass=adapt_mass,
    )
    return _attach_thetas(model, res)
