"""Gaussian evidence with the analytic gradient (plain PyTorch).

Counterpart of `gptools_tpu.ops.evidence`: the log density
``log N(r | 0, K + jitter)`` with relative jitter
``df * eps * max(mean diag K, 1)``, and a backward that reuses the factor:

    dll/dK = (alpha alpha^T - K^{-1}) / 2  (+ the jitter's trace term)
    dll/dr = -alpha

- `gaussian_loglik` returns the cached factor (`CholState`), `loglik` the
  scalar with the analytic backward. Both take K (..., N, N) and r (..., N)
  with any leading batch (the reference ``vmap``s its single-matrix
  functions; the batch is written out here).
- `loglik_b` is the reference's chains-minor twin, K (N, N, C) and
  r (N, C), on the same function.

The reference unrolls the factorization into per-element loops for the
TPU; here it is ``torch.linalg.cholesky_ex`` and ``solve_triangular``. A
failed factorization gives NaN in L, ``ok`` False and ``ll = -inf``, and
a zero cotangent.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = [
    "CholState",
    "add_jitter",
    "chol_factor",
    "gaussian_loglik",
    "loglik",
    "loglik_b",
]

_LOG_2PI = math.log(2.0 * math.pi)


class CholState(NamedTuple):
    """Cached factorization, the reference's ``(L, alpha, ll, ok)``; each
    with the leading batch of its K."""

    L: torch.Tensor      # lower Cholesky factor of K + jitter (NaN on failure)
    alpha: torch.Tensor  # K^{-1} (y - mu)
    ll: torch.Tensor     # log marginal likelihood (-inf on failure)
    ok: torch.Tensor     # bool: factorization succeeded and ll is finite


def _mean_diag(K: torch.Tensor) -> torch.Tensor:
    # a row per matrix, each summed alone: over a strided diagonal the CPU
    # would group the matrices by the batch's width and layout
    return torch.diagonal(K, dim1=-2, dim2=-1).contiguous().mean(-1)


def add_jitter(K: torch.Tensor, diag_factor: float = 1e2) -> torch.Tensor:
    """K + ``diag_factor * eps * max(mean diag K, 1)`` on the diagonal."""
    eps = torch.finfo(K.dtype).eps
    jitter = diag_factor * eps * torch.clamp(_mean_diag(K), min=1.0)
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    return K + jitter[..., None, None] * eye


def chol_factor(K: torch.Tensor, diag_factor: float = 1e2) -> torch.Tensor:
    """Lower Cholesky factor of K with relative jitter; NaN where the
    factorization fails."""
    L, info = torch.linalg.cholesky_ex(add_jitter(K, diag_factor))
    return torch.where((info == 0)[..., None, None], L, math.nan)


def gaussian_loglik(K: torch.Tensor, r: torch.Tensor, diag_factor: float = 1e2) -> CholState:
    """``log N(r | 0, K + jitter)`` with the factor: K (..., N, N), r
    (..., N) -> `CholState`; ``ll = -r^T K^-1 r / 2 - sum log diag L -
    N/2 log 2 pi``. Differentiable by autograd (the factor too)."""
    n = r.shape[-1]
    L = chol_factor(K, diag_factor)
    w = torch.linalg.solve_triangular(L, r[..., None], upper=False)
    alpha = torch.linalg.solve_triangular(L.mT, w, upper=True)[..., 0]
    quad = (w[..., 0] ** 2).sum(-1)
    logdet_half = torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    ll = -0.5 * quad - logdet_half - 0.5 * n * _LOG_2PI
    ok = torch.isfinite(ll)
    ll = torch.where(ok, ll, -math.inf)
    return CholState(L=L, alpha=alpha, ll=ll, ok=ok)


class _Loglik(torch.autograd.Function):
    @staticmethod
    def forward(ctx, K, r, diag_factor):
        state = gaussian_loglik(K, r, diag_factor)
        ctx.diag_factor = diag_factor
        ctx.save_for_backward(state.L, state.alpha, state.ok, _mean_diag(K))
        return state.ll

    @staticmethod
    def backward(ctx, g):
        L, alpha, ok, scale = ctx.saved_tensors
        n = L.shape[-1]
        eye = torch.eye(n, dtype=L.dtype, device=L.device)
        # failed factors get a zero cotangent below; give them a harmless
        # factor so the inverse never sees a zero or NaN pivot
        Kinv = torch.cholesky_inverse(torch.where(ok[..., None, None], L, eye))
        Kbar = 0.5 * (alpha[..., :, None] * alpha[..., None, :] - Kinv)
        # jitter = df * eps * max(mean diag K, 1): where it depends on K it
        # adds (df * eps / n) * trace(Kbar) to the diagonal
        eps = torch.finfo(L.dtype).eps
        tr = torch.diagonal(Kbar, dim1=-2, dim2=-1).sum(-1)
        corr = torch.where(scale > 1.0, ctx.diag_factor * eps * tr / n, 0.0)
        Kbar = Kbar + corr[..., None, None] * eye
        Kbar = torch.where(ok[..., None, None], g[..., None, None] * Kbar, 0.0)
        rbar = torch.where(ok[..., None], -g[..., None] * alpha, 0.0)
        return Kbar, rbar, None


def loglik(K: torch.Tensor, r: torch.Tensor, diag_factor: float = 1e2) -> torch.Tensor:
    """``log N(r | 0, K + jitter)``: K (..., N, N), r (..., N) -> ll (...),
    with the analytic backward (the value of `gaussian_loglik`)."""
    return _Loglik.apply(K, r, float(diag_factor))


def loglik_b(K: torch.Tensor, r: torch.Tensor, diag_factor: float = 1e2) -> torch.Tensor:
    """Chains-minor `loglik`: K (N, N, C), r (N, C) -> ll (C,)."""
    return loglik(K.permute(2, 0, 1), r.T, diag_factor)
