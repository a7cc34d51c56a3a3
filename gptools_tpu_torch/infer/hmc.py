"""HMC building blocks shared by the samplers.

Counterpart of `gptools_tpu.infer.hmc` (the pieces ChEES uses): the sample
container, pooled dual averaging for the step size, and the leapfrog step.
Welford mass adaptation, the windowed warmup and `hmc.sample` itself are
ROADMAP Queue 1 item 13.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

__all__ = [
    "SampleResult",
    "DualAveragingState",
    "da_init",
    "da_update",
    "leapfrog",
]


class SampleResult(NamedTuple):
    """Posterior sample container (all samplers return this)."""

    u: torch.Tensor                    # (chains, samples, P) unconstrained
    thetas: Optional[torch.Tensor]     # (chains, samples, P) constrained
    log_prob: torch.Tensor             # (chains, samples)
    diagnostics: dict                  # step size, divergences, accept, ...

    @property
    def num_chains(self):
        return self.u.shape[0]

    @property
    def num_samples(self):
        return self.u.shape[1]


class DualAveragingState(NamedTuple):
    """Nesterov dual averaging for log step size (Hoffman & Gelman 2014);
    every field a 0-d tensor."""

    log_eps: torch.Tensor
    log_eps_avg: torch.Tensor
    h_sum: torch.Tensor
    mu: torch.Tensor
    t: torch.Tensor


def da_init(eps0: torch.Tensor) -> DualAveragingState:
    log_eps = torch.log(eps0)
    return DualAveragingState(
        log_eps=log_eps,
        # seed the average at eps0 so a zero-warmup run samples at eps0
        log_eps_avg=log_eps,
        h_sum=torch.zeros_like(log_eps),
        mu=math.log(10.0) + log_eps,
        t=torch.zeros_like(log_eps),
    )


def da_update(
    state: DualAveragingState,
    accept_prob: torch.Tensor,
    target: float = 0.8,
    gamma: float = 0.05,
    t0: float = 10.0,
    kappa: float = 0.75,
) -> DualAveragingState:
    t = state.t + 1.0
    h_sum = state.h_sum + (target - accept_prob)
    log_eps = state.mu - torch.sqrt(t) / gamma * h_sum / (t + t0)
    w = t ** (-kappa)
    log_eps_avg = w * log_eps + (1.0 - w) * state.log_eps_avg
    return DualAveragingState(log_eps, log_eps_avg, h_sum, state.mu, t)


def leapfrog(value_and_grad_fn: Callable, q, p, eps, inv_mass, grad=None):
    """One leapfrog step of H = -logp(q) + 1/2 p^T M^-1 p. Returns
    (q', p', logp', grad'). Pass the cached ``grad`` at ``q`` to spend
    exactly one gradient evaluation per step."""
    if grad is None:
        _, grad = value_and_grad_fn(q)
    p_half = p + 0.5 * eps * grad
    q_new = q + eps * inv_mass * p_half
    v_new, g_new = value_and_grad_fn(q_new)
    p_new = p_half + 0.5 * eps * g_new
    return q_new, p_new, v_new, g_new
