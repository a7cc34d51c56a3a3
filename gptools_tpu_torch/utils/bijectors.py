"""Bijectors from the unconstrained sampler space to constrained hyperparameters.

Counterpart of `gptools_tpu.utils.bijectors`. Every method works on a
batch directly: ``u`` and ``x`` have shape ``(..., dim)`` and
``log_det_jac`` reduces the last axis, so a ``(C, P)`` stack of chains
needs no vmap (`OrderedIntervalBijector` takes its recursion in closed
form, by a cumulative sum over the last axis).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

__all__ = [
    "Bijector",
    "IdentityBijector",
    "ExpBijector",
    "SoftplusBijector",
    "SigmoidBijector",
    "NegExpBijector",
    "OrderedIntervalBijector",
    "ConcatBijector",
    "interval_bijector",
    "bijector_from_bounds",
]

_EPS = 1e-12


class Bijector:
    """Smooth invertible map ``u (unconstrained) -> x (constrained)`` on the
    last axis, of length `dim`."""

    dim: int

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def inverse(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def log_det_jac(self, u: torch.Tensor) -> torch.Tensor:
        """log |det d forward / d u| at ``u``: shape ``u.shape[:-1]``."""
        raise NotImplementedError


class IdentityBijector(Bijector):
    """``x = u`` on the whole real line."""

    def __init__(self, dim: int = 1):
        self.dim = dim

    def forward(self, u):
        return u

    def inverse(self, x):
        return x

    def log_det_jac(self, u):
        return torch.zeros(u.shape[:-1], dtype=u.dtype, device=u.device)


class ExpBijector(Bijector):
    """``x = lo + exp(u)`` onto ``(lo, inf)``."""

    def __init__(self, lo: float = 0.0, dim: int = 1):
        self.lo = float(lo)
        self.dim = dim

    def forward(self, u):
        return self.lo + torch.exp(u)

    def inverse(self, x):
        return torch.log(torch.clamp(x - self.lo, min=_EPS))

    def log_det_jac(self, u):
        return u.sum(-1)


class SoftplusBijector(Bijector):
    """``x = lo + softplus(u)`` onto ``(lo, inf)``."""

    def __init__(self, lo: float = 0.0, dim: int = 1):
        self.lo = float(lo)
        self.dim = dim

    def forward(self, u):
        return self.lo + F.softplus(u)

    def inverse(self, x):
        y = torch.clamp(x - self.lo, min=_EPS)
        # softplus^-1(y) = y + log1p(-exp(-y)), stable for both tails
        return y + torch.log(-torch.expm1(-y))

    def log_det_jac(self, u):
        return F.logsigmoid(u).sum(-1)


class SigmoidBijector(Bijector):
    """``x = lo + (hi - lo) * sigmoid(u)`` onto ``(lo, hi)``."""

    def __init__(self, lo: float, hi: float, dim: int = 1):
        if not (hi > lo):
            raise ValueError(f"need hi > lo, got ({lo}, {hi})")
        self.lo = float(lo)
        self.hi = float(hi)
        self.dim = dim

    def forward(self, u):
        return self.lo + (self.hi - self.lo) * torch.sigmoid(u)

    def inverse(self, x):
        p = torch.clamp((x - self.lo) / (self.hi - self.lo), _EPS, 1.0 - 1e-7)
        return torch.log(p) - torch.log1p(-p)

    def log_det_jac(self, u):
        # d/du [ (hi-lo) sigmoid(u) ] = (hi-lo) sigmoid(u) sigmoid(-u)
        return (
            math.log(self.hi - self.lo) + F.logsigmoid(u) + F.logsigmoid(-u)
        ).sum(-1)


class NegExpBijector(Bijector):
    """``x = hi - exp(u)`` onto ``(-inf, hi)``."""

    def __init__(self, hi: float = 0.0, dim: int = 1):
        self.hi = float(hi)
        self.dim = dim

    def forward(self, u):
        return self.hi - torch.exp(u)

    def inverse(self, x):
        return torch.log(torch.clamp(self.hi - x, min=_EPS))

    def log_det_jac(self, u):
        return u.sum(-1)


class OrderedIntervalBijector(Bijector):
    """``u in R^k`` onto ``lo < x_1 < ... < x_k < hi`` by the reference's
    stick breaking, ``x_i = x_{i-1} + (hi - x_{i-1}) sigmoid(u_i)`` from
    ``x_0 = lo``. Since ``hi - x_i = (hi - x_{i-1}) sigmoid(-u_i)``, the
    recursion has the closed form ``x_i = hi - (hi - lo) exp(S_i)`` with
    ``S_i = sum_{j<=i} log sigmoid(-u_j)``, and the Jacobian is
    lower-triangular: ``log|det J| = sum_i [log(hi - lo) + S_{i-1} + log
    sigmoid(u_i) + log sigmoid(-u_i)]``. A cumulative sum over the last
    axis computes both for a whole batch."""

    def __init__(self, lo: float, hi: float, dim: int):
        if not (hi > lo):
            raise ValueError(f"need hi > lo, got ({lo}, {hi})")
        self.lo = float(lo)
        self.hi = float(hi)
        self.dim = dim

    def forward(self, u):
        S = torch.cumsum(F.logsigmoid(-u), -1)
        return self.hi - (self.hi - self.lo) * torch.exp(S)

    def inverse(self, x):
        lo = torch.full_like(x[..., :1], self.lo)
        prev = torch.cat([lo, x[..., :-1]], -1)
        p = torch.clamp((x - prev) / (self.hi - prev), _EPS, 1.0 - 1e-7)
        return torch.log(p) - torch.log1p(-p)

    def log_det_jac(self, u):
        ls_neg = F.logsigmoid(-u)
        S_prev = torch.cumsum(ls_neg, -1) - ls_neg  # S_{i-1}, with S_0 = 0
        return (math.log(self.hi - self.lo) + S_prev + F.logsigmoid(u) + ls_neg).sum(-1)


class ConcatBijector(Bijector):
    """Apply a sequence of bijectors to consecutive slices of the last axis."""

    def __init__(self, parts: Sequence[Bijector]):
        self.parts = tuple(parts)
        self.dim = sum(p.dim for p in self.parts)
        offs, o = [], 0
        for p in self.parts:
            offs.append(o)
            o += p.dim
        self._offsets = tuple(offs)

    def _slices(self, v):
        return [
            (p, v[..., o : o + p.dim]) for p, o in zip(self.parts, self._offsets)
        ]

    def forward(self, u):
        if not self.parts:  # an empty block (a kernel with no parameters)
            return u
        return torch.cat([p.forward(s) for p, s in self._slices(u)], dim=-1)

    def inverse(self, x):
        if not self.parts:
            return x
        return torch.cat([p.inverse(s) for p, s in self._slices(x)], dim=-1)

    def log_det_jac(self, u):
        parts = [p.log_det_jac(s) for p, s in self._slices(u)]
        if not parts:
            return torch.zeros(u.shape[:-1], dtype=u.dtype, device=u.device)
        return sum(parts[1:], parts[0])


def interval_bijector(lo: float, hi: float) -> Bijector:
    """The canonical scalar bijector for one interval (as the reference:
    sigmoid on a finite box, softplus on (lo, inf), negative exp on (-inf,
    hi), identity on the whole line)."""
    lo_f = lo if lo is not None else -math.inf
    hi_f = hi if hi is not None else math.inf
    finite_lo = math.isfinite(lo_f)
    finite_hi = math.isfinite(hi_f)
    if finite_lo and finite_hi:
        return SigmoidBijector(lo_f, hi_f)
    if finite_lo:
        return SoftplusBijector(lo_f)
    if finite_hi:
        return NegExpBijector(hi_f)
    return IdentityBijector()


def bijector_from_bounds(bounds: Sequence[tuple]) -> Bijector:
    """A `ConcatBijector` of canonical scalar bijectors from a bounds list."""
    return ConcatBijector([interval_bijector(lo, hi) for lo, hi in bounds])
