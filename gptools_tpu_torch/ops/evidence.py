"""Batched Gaussian evidence with the analytic gradient (plain PyTorch).

Counterpart of the chains-minor half of `gptools_tpu.ops.evidence`:
``loglik_b(K (N, N, C), r (N, C), diag_factor) -> ll (C,)``, the log density
``log N(r | 0, K + jitter)`` with relative jitter
``df * eps * max(mean diag K, 1)``, and a backward that reuses the factor:

    dll/dK = (alpha alpha^T - K^{-1}) / 2  (+ the jitter's trace term)
    dll/dr = -alpha

The reference unrolls the factorization into per-element loops for the TPU;
here the batch goes to ``torch.linalg`` on a (C, N, N) view. A failed
factorization (``info != 0``) or a non-finite ll gives ``-inf`` and a zero
cotangent. The single-matrix surface (``loglik``, ``gaussian_loglik``) is
ROADMAP Queue 1 item 12.
"""

from __future__ import annotations

import math

import torch

__all__ = ["loglik_b"]

_LOG_2PI = math.log(2.0 * math.pi)


def _add_jitter_b(K: torch.Tensor, diag_factor: float):
    """Relative diagonal jitter, chains-minor: K (N, N, C) -> (K + jitter,
    scale) with scale (C,) the mean diagonal before jitter."""
    n = K.shape[0]
    eps = torch.finfo(K.dtype).eps
    scale = torch.diagonal(K, dim1=0, dim2=1).mean(-1)  # (C,)
    jitter = diag_factor * eps * torch.clamp(scale, min=1.0)
    eye = torch.eye(n, dtype=K.dtype, device=K.device)[:, :, None]
    return K + jitter[None, None, :] * eye, scale


class _LoglikB(torch.autograd.Function):
    @staticmethod
    def forward(ctx, K, r, diag_factor):
        n = K.shape[0]
        Kj, scale = _add_jitter_b(K, diag_factor)
        L, info = torch.linalg.cholesky_ex(Kj.permute(2, 0, 1))  # (C, N, N)
        rb = r.T.unsqueeze(-1)  # (C, N, 1)
        w = torch.linalg.solve_triangular(L, rb, upper=False)
        alpha = torch.linalg.solve_triangular(L.mT, w, upper=True)[..., 0]
        quad = (w[..., 0] ** 2).sum(-1)
        logdet_half = torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
        ll = -0.5 * quad - logdet_half - 0.5 * n * _LOG_2PI
        ok = (info == 0) & torch.isfinite(ll)
        ll = torch.where(ok, ll, torch.full_like(ll, -math.inf))
        ctx.diag_factor = diag_factor
        ctx.save_for_backward(L, alpha, ok, scale)
        return ll

    @staticmethod
    def backward(ctx, g):
        L, alpha, ok, scale = ctx.saved_tensors
        n = L.shape[-1]
        eye = torch.eye(n, dtype=L.dtype, device=L.device)
        # failed chains get a zero cotangent below; give them a harmless
        # factor so the inverse never sees a zero or NaN pivot
        Kinv = torch.cholesky_inverse(torch.where(ok[:, None, None], L, eye))
        Kbar = 0.5 * (alpha[:, :, None] * alpha[:, None, :] - Kinv)
        eps = torch.finfo(L.dtype).eps
        tr = torch.diagonal(Kbar, dim1=-2, dim2=-1).sum(-1)  # (C,)
        corr = torch.where(
            scale > 1.0, ctx.diag_factor * eps * tr / n, torch.zeros_like(tr)
        )
        Kbar = Kbar + corr[:, None, None] * eye
        Kbar = torch.where(ok[:, None, None], g[:, None, None] * Kbar, 0.0)
        rbar = torch.where(ok[:, None], -g[:, None] * alpha, 0.0)
        return Kbar.permute(1, 2, 0), rbar.T, None


def loglik_b(K: torch.Tensor, r: torch.Tensor, diag_factor: float = 1e2):
    """Batched ``log N(r | 0, K + jitter)``, chains-minor: K (N, N, C),
    r (N, C) -> ll (C,), with the analytic backward."""
    return _LoglikB.apply(K, r, float(diag_factor))
