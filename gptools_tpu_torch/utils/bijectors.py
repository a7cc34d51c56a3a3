"""Bijectors from the unconstrained sampler space to constrained hyperparameters.

Counterpart of `gptools_tpu.utils.bijectors` (config-4 subset). Every method
works on a batch directly: ``u`` and ``x`` have shape ``(..., dim)`` and
``log_det_jac`` reduces the last axis, so a ``(C, P)`` stack of chains needs
no vmap. The other bijectors of the reference (`ExpBijector`,
`NegExpBijector`, `IdentityBijector`, `OrderedIntervalBijector`) are
ROADMAP Queue 1 item 11.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

__all__ = [
    "Bijector",
    "SoftplusBijector",
    "SigmoidBijector",
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
        return torch.cat([p.forward(s) for p, s in self._slices(u)], dim=-1)

    def inverse(self, x):
        return torch.cat([p.inverse(s) for p, s in self._slices(x)], dim=-1)

    def log_det_jac(self, u):
        parts = [p.log_det_jac(s) for p, s in self._slices(u)]
        return sum(parts[1:], parts[0])


def interval_bijector(lo: float, hi: float) -> Bijector:
    """The canonical scalar bijector for one interval (as the reference:
    sigmoid on a finite box, softplus on a half-line)."""
    lo_f = lo if lo is not None else -math.inf
    hi_f = hi if hi is not None else math.inf
    finite_lo = math.isfinite(lo_f)
    finite_hi = math.isfinite(hi_f)
    if finite_lo and finite_hi:
        return SigmoidBijector(lo_f, hi_f)
    if finite_lo:
        return SoftplusBijector(lo_f)
    raise NotImplementedError(
        f"interval ({lo_f}, {hi_f}) needs NegExpBijector or IdentityBijector: "
        "ROADMAP Queue 1 item 11"
    )


def bijector_from_bounds(bounds: Sequence[tuple]) -> Bijector:
    """A `ConcatBijector` of canonical scalar bijectors from a bounds list."""
    return ConcatBijector([interval_bijector(lo, hi) for lo, hi in bounds])
