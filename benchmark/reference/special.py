"""The regularized incomplete beta function in plain PyTorch.

``I_x(a, b)`` by its continued fraction (modified Lentz; Press et al.,
Numerical Recipes, 3rd ed., section 6.4), on the side of ``x < (a + 1) /
(a + b + 2)`` where it converges fast, through ``I_x(a, b) = 1 -
I_{1-x}(b, a)`` on the other. A fixed number of terms, so autograd
differentiates it in a, b and x.
"""

from __future__ import annotations

import torch

_TINY = 1e-300


def _fix(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d.abs() < _TINY, torch.full_like(d, _TINY), d)


def _betacf(a, b, x, terms: int):
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = torch.ones_like(x)
    d = 1.0 / _fix(1.0 - qab * x / qap)
    h = d
    for m in range(1, terms + 1):
        m2 = 2.0 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 / _fix(1.0 + aa * d)
        c = _fix(1.0 + aa / c)
        h = h * d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 / _fix(1.0 + aa * d)
        c = _fix(1.0 + aa / c)
        h = h * d * c
    return h


def betainc(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor, terms: int = 80) -> torch.Tensor:
    """I_x(a, b) for 0 < x < 1, broadcast over a, b and x."""
    a, b, x = torch.broadcast_tensors(a, b, x)
    swap = x > (a + 1.0) / (a + b + 2.0)
    aa = torch.where(swap, b, a)
    bb = torch.where(swap, a, b)
    xx = torch.where(swap, 1.0 - x, x)
    log_front = (aa * torch.log(xx) + bb * torch.log1p(-xx)
                 - (torch.lgamma(aa) + torch.lgamma(bb) - torch.lgamma(aa + bb)))
    val = torch.exp(log_front) * _betacf(aa, bb, xx, terms) / aa
    return torch.where(swap, 1.0 - val, val)
