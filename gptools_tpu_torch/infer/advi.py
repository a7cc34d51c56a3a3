"""Automatic differentiation variational inference over GP hyperparameters.

Counterpart of `gptools_tpu.infer.advi` (Kucukelbir et al. 2017): a
Gaussian in the unconstrained bijector space, mean-field (diagonal) or
full-rank (a dense Cholesky factor), reparameterized ELBO gradients and
Adam with optax's defaults (`torch.optim.Adam`: betas 0.9 / 0.999, eps
1e-8). Each step's ``num_elbo_samples`` draws are one batched density call,
(S, P) -> (S,). The reference's compiled fit program (``_fit_program``)
serves XLA's compilation and has no counterpart.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from gptools_tpu_torch.infer import model_logp
from gptools_tpu_torch.infer.hmc import SampleResult

__all__ = ["ADVIResult", "neg_elbo", "fit", "fit_logp", "sample"]


class ADVIResult(NamedTuple):
    mu: torch.Tensor
    log_sigma: torch.Tensor          # diagonal log-scales
    elbo_trace: torch.Tensor
    chol_offdiag: Optional[torch.Tensor] = None  # strictly-lower factor entries (full-rank)


def _factor(log_sigma, off):
    """The Cholesky factor of q's covariance: diag(exp(log_sigma)) with
    ``off`` in the strictly lower triangle (row-major, as
    ``jnp.tril_indices(P, k=-1)``)."""
    L = torch.diag(torch.exp(log_sigma))
    if off is None:
        return L
    P = log_sigma.shape[0]
    rows, cols = torch.tril_indices(P, P, offset=-1, device=log_sigma.device)
    return L.index_put((rows, cols), off)


def neg_elbo(logp_batched: Callable, mu, log_sigma, off, z):
    """The negative ELBO of N(mu, L L^T) at the standard normal draws ``z``
    (S, P): ``-(mean log p(mu + z L^T) + sum log_sigma + P/2 (1 +
    log 2 pi))``, non-finite densities taken as -1e30; ``off`` None for
    mean-field."""
    P = mu.shape[0]
    if off is None:
        us = mu + torch.exp(log_sigma) * z
    else:
        us = mu + z @ _factor(log_sigma, off).T
    lps = logp_batched(us)
    lps = torch.where(torch.isfinite(lps), lps, -1e30)
    entropy = log_sigma.sum() + 0.5 * P * (1.0 + math.log(2.0 * math.pi))
    return -(lps.mean() + entropy)


def fit_logp(logp_batched: Callable, u0: torch.Tensor, generator: torch.Generator,
             num_steps: int = 1500, num_elbo_samples: int = 16, learning_rate: float = 0.05,
             full_rank: bool = False) -> ADVIResult:
    """Maximize the ELBO of the batched density from mean ``u0``, log-scales
    -2 and a zero off-diagonal, by Adam; non-finite gradient entries are
    zeroed, as in the reference."""
    P = u0.shape[0]
    dtype, dev = u0.dtype, u0.device
    params = [u0.detach().clone(), torch.full((P,), -2.0, dtype=dtype, device=dev)]
    if full_rank:
        params.append(torch.zeros((P * (P - 1) // 2,), dtype=dtype, device=dev))
    for t in params:
        t.requires_grad_(True)
    opt = torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    elbos = []
    for _ in range(num_steps):
        z = torch.randn((num_elbo_samples, P), generator=generator, dtype=dtype, device=dev)
        with torch.enable_grad():
            loss = neg_elbo(logp_batched, params[0], params[1],
                            params[2] if full_rank else None, z)
            grads = torch.autograd.grad(loss, params)
        for t, g in zip(params, grads):
            t.grad = torch.where(torch.isfinite(g), g, 0.0)
        opt.step()
        elbos.append(-loss.detach())
    return ADVIResult(
        mu=params[0].detach(), log_sigma=params[1].detach(), elbo_trace=torch.stack(elbos),
        chol_offdiag=params[2].detach() if full_rank else None,
    )


def fit(model, data, generator: torch.Generator, num_steps: int = 1500,
        num_elbo_samples: int = 16, learning_rate: float = 0.05,
        full_rank: bool = False) -> ADVIResult:
    """Fit q(u) = N(mu, Sigma) to the model's posterior on ``data``, from the
    model's initial parameters; ``full_rank=False`` uses Sigma =
    diag(sigma^2), ``True`` a dense Cholesky factor."""
    u0 = model.u_of_theta(torch.tensor(model.initial_params, dtype=data.dtype, device=data.device))
    return fit_logp(model_logp(model, data), u0, generator, num_steps=num_steps,
                    num_elbo_samples=num_elbo_samples, learning_rate=learning_rate,
                    full_rank=full_rank)


@torch.no_grad()
def sample(model, data, generator: torch.Generator, num_samples: int = 1000,
           num_steps: int = 1500, num_elbo_samples: int = 16, learning_rate: float = 0.05,
           full_rank: bool = False, **_) -> SampleResult:
    """Fit ADVI, then draw ``num_samples`` samples of q (one chain); their
    log posterior is one batched call."""
    res = fit(model, data, generator, num_steps=num_steps,
              num_elbo_samples=num_elbo_samples, learning_rate=learning_rate,
              full_rank=full_rank)
    P = res.mu.shape[0]
    sigma = torch.exp(res.log_sigma)
    z = torch.randn((num_samples, P), generator=generator, dtype=res.mu.dtype,
                    device=res.mu.device)
    if full_rank and res.chol_offdiag is not None:
        us = res.mu + z @ _factor(res.log_sigma, res.chol_offdiag).T
    else:
        us = res.mu + sigma * z
    diagnostics = {
        "elbo_trace": res.elbo_trace,
        "mu": res.mu,
        "sigma": sigma,
        "final_elbo": res.elbo_trace[-1],
    }
    return SampleResult(u=us[None], thetas=model.theta_of_u(us)[None],
                        log_prob=model_logp(model, data)(us)[None], diagnostics=diagnostics)
