"""Plain float64 reference of a GP hyperparameter posterior.

Written from the model's mathematics, in plain PyTorch, with no kernel,
cache or batching trick of the program under test, which it never imports:

- the covariance of values and slopes: ``cov(f(x), f(x')) = k``,
  ``cov(f'(x), f(x')) = dk/dx``, ``cov(f(x), f'(x')) = dk/dx'`` and
  ``cov(f'(x), f'(x')) = d2k/dx dx'``, each partial taken by autograd on one
  pair at a time (every (chain, i, j) entry has inputs of its own);
- ``log N(y - m | 0, K + diag(err^2) + jitter I)`` by a Cholesky factor,
  with the jitter ``diag_factor * eps * max(mean diag, 1)`` of the stated
  precision (float64);
- the priors' log densities, the bijection from the unconstrained space
  (softplus onto (0, inf), a scaled sigmoid onto (lo, hi), the identity on
  the real line) and the log-determinant of its Jacobian.

Gradients with respect to theta come from autograd through all of it.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

_LOG_2PI = math.log(2.0 * math.pi)


def softplus(u: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(u, torch.zeros_like(u))


class Priors:
    """Independent priors, one per parameter: ``("lognormal", mu, sigma)``
    (mu and sigma of log theta), ``("uniform", lo, hi)`` or ``("normal", mu,
    sigma)``."""

    def __init__(self, spec: Sequence[Sequence]):
        self.spec = [(str(k), float(a), float(b)) for k, a, b in spec]
        for kind, _, _ in self.spec:
            if kind not in ("lognormal", "uniform", "normal"):
                raise ValueError(f"unknown prior {kind!r}")

    def theta_of_u(self, u: torch.Tensor) -> torch.Tensor:
        cols = []
        for i, (kind, a, b) in enumerate(self.spec):
            ui = u[..., i]
            if kind == "lognormal":
                cols.append(softplus(ui))
            elif kind == "uniform":
                cols.append(a + (b - a) * torch.sigmoid(ui))
            else:
                cols.append(ui)
        return torch.stack(cols, -1)

    def log_det_jac(self, u: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(u.shape[:-1], dtype=u.dtype, device=u.device)
        for i, (kind, a, b) in enumerate(self.spec):
            ui = u[..., i]
            if kind == "lognormal":
                out = out + torch.nn.functional.logsigmoid(ui)
            elif kind == "uniform":
                out = out + (math.log(b - a) + torch.nn.functional.logsigmoid(ui)
                             + torch.nn.functional.logsigmoid(-ui))
        return out

    def log_prob(self, theta: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(theta.shape[:-1], dtype=theta.dtype, device=theta.device)
        for i, (kind, a, b) in enumerate(self.spec):
            t = theta[..., i]
            if kind == "lognormal":
                pos = t > 0
                lx = torch.log(torch.where(pos, t, torch.ones_like(t)))
                z = (lx - a) / b
                lp = -0.5 * z * z - lx - math.log(b) - 0.5 * _LOG_2PI
                out = out + torch.where(pos, lp, -math.inf)
            elif kind == "uniform":
                inside = (t >= a) & (t <= b)
                lp = torch.full_like(t, -math.log(b - a))
                out = out + torch.where(inside, lp, -math.inf)
            else:
                z = (t - a) / b
                out = out + (-0.5 * z * z - math.log(b) - 0.5 * _LOG_2PI)
        return out


class GPPosterior:
    """log p(theta | y) up to its constant, for 1-D data with value rows
    (order 0) and slope rows (order 1).

    ``kernel(x1, x2, theta)``: elementwise covariance of f(x1) and f(x2),
    theta (..., P) broadcast against x (...). ``mean(x, theta)`` likewise,
    or None for a zero mean. Arrays are float64 on ``device``.
    """

    def __init__(self, priors: Priors, kernel: Callable, x, order, y, err,
                 mean: Optional[Callable] = None, diag_factor: float = 1e2,
                 device="cpu"):
        f64 = dict(dtype=torch.float64, device=device)
        self.priors = priors
        self.kernel = kernel
        self.mean = mean
        self.x = torch.as_tensor(x, **f64)
        self.order = torch.as_tensor(order, dtype=torch.int64, device=device)
        self.y = torch.as_tensor(y, **f64)
        self.err2 = torch.as_tensor(err, **f64) ** 2
        self.diag_factor = float(diag_factor)
        if self.mean is not None and bool((self.order != 0).any()):
            raise NotImplementedError("a mean with slope rows is not needed here")

    def covariance(self, theta: torch.Tensor) -> torch.Tensor:
        """(B, N, N) covariance of the observed rows, without noise."""
        B, N = theta.shape[0], self.x.shape[0]
        th = theta[:, None, None, :]
        if not bool((self.order != 0).any()):
            return self.kernel(self.x.view(1, N, 1), self.x.view(1, 1, N), th)
        x1 = self.x.view(1, N, 1).expand(B, N, N).clone().requires_grad_(True)
        x2 = self.x.view(1, 1, N).expand(B, N, N).clone().requires_grad_(True)
        with torch.enable_grad():
            k = self.kernel(x1, x2, th)
            (k10,) = torch.autograd.grad(k.sum(), x1, create_graph=True)
            (k01,) = torch.autograd.grad(k.sum(), x2, create_graph=True)
            (k11,) = torch.autograd.grad(k10.sum(), x2, create_graph=True)
        oi = self.order.view(1, N, 1)
        oj = self.order.view(1, 1, N)
        return torch.where(
            oi == 0, torch.where(oj == 0, k, k01), torch.where(oj == 0, k10, k11)
        )

    def log_marginal(self, theta: torch.Tensor) -> torch.Tensor:
        """(B,) log N(y - m | 0, K + diag(err^2) + jitter); -inf where the
        factorization fails."""
        N = self.x.shape[0]
        K = self.covariance(theta) + torch.diag(self.err2)
        scale = torch.clamp(torch.diagonal(K, dim1=-2, dim2=-1).mean(-1), min=1.0)
        jitter = self.diag_factor * torch.finfo(torch.float64).eps * scale
        eye = torch.eye(N, dtype=K.dtype, device=K.device)
        K = K + jitter[:, None, None] * eye
        L, info = torch.linalg.cholesky_ex(K)
        ok = info == 0
        L = torch.where(ok[:, None, None], L, eye)
        r = self.y.expand(theta.shape[0], N)
        if self.mean is not None:
            r = r - self.mean(self.x.view(1, N), theta[:, None, :])
        w = torch.linalg.solve_triangular(L, r[..., None], upper=False)[..., 0]
        ll = (-0.5 * (w * w).sum(-1) - torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
              - 0.5 * N * _LOG_2PI)
        return torch.where(ok, ll, -math.inf)

    def log_posterior_theta(self, theta: torch.Tensor) -> torch.Tensor:
        """(B,) log prior + log marginal likelihood."""
        lp = self.priors.log_prob(theta)
        ll = self.log_marginal(theta)
        return lp + torch.where(torch.isfinite(lp), ll, 0.0)

    def theta_of_u(self, u: torch.Tensor) -> torch.Tensor:
        return self.priors.theta_of_u(u)

    def log_posterior_u(self, u: torch.Tensor) -> torch.Tensor:
        """(B,) the sampler's target in the unconstrained space."""
        return self.log_posterior_theta(self.theta_of_u(u)) + self.priors.log_det_jac(u)

    def ll_and_grad(self, theta: torch.Tensor):
        """(log marginal (B,), d(log prior + log marginal)/dtheta (B, P))."""
        with torch.enable_grad():
            t = theta.detach().clone().requires_grad_(True)
            ll = self.log_marginal(t)
            total = self.priors.log_prob(t) + ll
            (g,) = torch.autograd.grad(total.sum(), t)
        return ll.detach(), g


def blocks(fn: Callable, x: torch.Tensor, rows: int = 4096) -> torch.Tensor:
    """fn over row blocks of x, concatenated (the reference's memory cap)."""
    return torch.cat([fn(b) for b in x.split(rows)])
