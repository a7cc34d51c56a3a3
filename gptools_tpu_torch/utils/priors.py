"""Hyperpriors over (slices of) the flat hyperparameter vector.

Counterpart of `gptools_tpu.utils.priors` (the subset configs 2-4 use:
product, uniform, normal and log-normal priors). ``log_prob`` takes ``theta`` of shape
``(..., dim)`` and returns ``theta.shape[:-1]``; evaluating outside the
support gives ``-inf`` with a finite gradient. ``sample`` draws from an
explicit `torch.Generator` on that generator's device. The rest of the
prior zoo is ROADMAP Queue 1 item 11.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from gptools_tpu_torch.utils import bijectors as bij

__all__ = [
    "JointPrior",
    "ProductJointPrior",
    "UniformJointPrior",
    "NormalJointPrior",
    "LogNormalJointPrior",
]

_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


def _as_tuple(x, k: int) -> tuple:
    if np.ndim(x) == 0:
        return (float(x),) * k
    t = tuple(float(v) for v in x)
    if len(t) != k:
        raise ValueError(f"expected length {k}, got {len(t)}")
    return t


def _dim_of(a, b, dim):
    if dim is not None:
        return dim
    if np.ndim(a) > 0:
        return len(a)
    return len(b) if np.ndim(b) > 0 else 1


class JointPrior:
    """Joint prior over a length-`dim` block of hyperparameters."""

    dim: int

    def log_prob(self, theta: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def sample(
        self, generator: torch.Generator, shape: tuple, dtype: torch.dtype
    ) -> torch.Tensor:
        """Draws of shape ``shape + (dim,)`` on ``generator.device``."""
        raise NotImplementedError

    @property
    def bounds(self) -> list:
        raise NotImplementedError

    def _consts(self, names: tuple, dtype: torch.dtype, device) -> tuple:
        """The tuple fields ``names`` as tensors of ``dtype`` on ``device``,
        made once per (dtype, device): a tensor made from a list on each
        call is a host-to-device copy, which waits for the card's queue."""
        cache = self.__dict__.setdefault("_const_cache", {})
        key = (names, dtype, torch.device(device))
        if key not in cache:
            cache[key] = tuple(
                torch.tensor(getattr(self, n), dtype=dtype, device=device) for n in names
            )
        return cache[key]

    def bijector(self) -> bij.Bijector:
        return bij.bijector_from_bounds(self.bounds)

    def __mul__(self, other: "JointPrior") -> "ProductJointPrior":
        mine = self.parts if isinstance(self, ProductJointPrior) else (self,)
        theirs = other.parts if isinstance(other, ProductJointPrior) else (other,)
        return ProductJointPrior(mine + theirs)


class ProductJointPrior(JointPrior):
    """Product of independent blocks over the concatenated vector."""

    def __init__(self, parts: Sequence[JointPrior]):
        self.parts = tuple(parts)
        self.dim = sum(p.dim for p in self.parts)
        offs, o = [], 0
        for p in self.parts:
            offs.append(o)
            o += p.dim
        self._offsets = tuple(offs)

    def log_prob(self, theta):
        total = torch.zeros(theta.shape[:-1], dtype=theta.dtype, device=theta.device)
        for p, o in zip(self.parts, self._offsets):
            total = total + p.log_prob(theta[..., o : o + p.dim])
        return total

    def sample(self, generator, shape, dtype):
        return torch.cat(
            [p.sample(generator, shape, dtype) for p in self.parts], dim=-1
        )

    @property
    def bounds(self):
        out = []
        for p in self.parts:
            out.extend(p.bounds)
        return out

    def bijector(self):
        return bij.ConcatBijector([p.bijector() for p in self.parts])


class UniformJointPrior(JointPrior):
    """Independent uniforms on a box."""

    def __init__(self, lb, ub=None, dim: int | None = None):
        if ub is None:  # a list of (lb, ub) pairs
            pairs = [(float(a), float(b)) for a, b in lb]
            self.lb = tuple(p[0] for p in pairs)
            self.ub = tuple(p[1] for p in pairs)
        else:
            k = _dim_of(lb, ub, dim)
            self.lb = _as_tuple(lb, k)
            self.ub = _as_tuple(ub, k)
        if any(u <= l for l, u in zip(self.lb, self.ub)):
            raise ValueError("UniformJointPrior requires ub > lb elementwise")
        self.dim = len(self.lb)

    def log_prob(self, theta):
        lb, ub = self._consts(("lb", "ub"), theta.dtype, theta.device)
        inside = ((theta >= lb) & (theta <= ub)).all(-1)
        lp = -torch.log(ub - lb).sum()
        return torch.where(inside, lp, torch.full_like(lp, -math.inf))

    def sample(self, generator, shape, dtype):
        dev = generator.device
        lb, ub = self._consts(("lb", "ub"), dtype, dev)
        u = torch.rand(
            tuple(shape) + (self.dim,), generator=generator, dtype=dtype, device=dev
        )
        return lb + (ub - lb) * u

    @property
    def bounds(self):
        return list(zip(self.lb, self.ub))


class NormalJointPrior(JointPrior):
    """Independent normals on the whole real line."""

    def __init__(self, mu, sigma, dim: int | None = None):
        k = _dim_of(mu, sigma, dim)
        self.mu = _as_tuple(mu, k)
        self.sigma = _as_tuple(sigma, k)
        if any(s <= 0 for s in self.sigma):
            raise ValueError("sigma must be positive")
        self.dim = k

    def log_prob(self, theta):
        mu, sig = self._consts(("mu", "sigma"), theta.dtype, theta.device)
        z = (theta - mu) / sig
        return (-0.5 * z * z - torch.log(sig) - _HALF_LOG_2PI).sum(-1)

    def sample(self, generator, shape, dtype):
        dev = generator.device
        mu, sig = self._consts(("mu", "sigma"), dtype, dev)
        z = torch.randn(
            tuple(shape) + (self.dim,), generator=generator, dtype=dtype, device=dev
        )
        return mu + sig * z

    @property
    def bounds(self):
        return [(-math.inf, math.inf)] * self.dim


class LogNormalJointPrior(JointPrior):
    """Independent log-normals on (0, inf); ``mu``/``sigma`` are the mean and
    std of ``log(theta)``."""

    def __init__(self, mu, sigma, dim: int | None = None):
        k = _dim_of(mu, sigma, dim)
        self.mu = _as_tuple(mu, k)
        self.sigma = _as_tuple(sigma, k)
        if any(s <= 0 for s in self.sigma):
            raise ValueError("sigma must be positive")
        self.dim = k

    def log_prob(self, theta):
        mu, sig = self._consts(("mu", "sigma"), theta.dtype, theta.device)
        pos = theta > 0
        # double where: log never sees a non-positive value, so an
        # out-of-support draw gets -inf with a finite (zero) gradient
        x = torch.where(pos, theta, torch.ones_like(theta))
        lx = torch.log(x)
        z = (lx - mu) / sig
        lp = (-0.5 * z * z - lx - torch.log(sig) - _HALF_LOG_2PI).sum(-1)
        return torch.where(pos.all(-1), lp, torch.full_like(lp, -math.inf))

    def sample(self, generator, shape, dtype):
        dev = generator.device
        mu, sig = self._consts(("mu", "sigma"), dtype, dev)
        z = torch.randn(
            tuple(shape) + (self.dim,), generator=generator, dtype=dtype, device=dev
        )
        return torch.exp(mu + sig * z)

    @property
    def bounds(self):
        return [(0.0, math.inf)] * self.dim
