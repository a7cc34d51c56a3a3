"""Hyperpriors over (slices of) the flat hyperparameter vector.

Counterpart of `gptools_tpu.utils.priors`: product, uniform, normal,
log-normal, gamma (two parameterizations), exponential, sorted-uniform
(and its core/edge name) and independent priors over the 1-D
distributions `Uniform`, `Normal`, `LogNormal`, `Gamma` and
`Exponential`. ``log_prob`` takes ``theta`` of shape ``(..., dim)`` and
returns ``theta.shape[:-1]``; evaluating outside the support gives
``-inf`` with a finite gradient. ``sample`` draws from an explicit
`torch.Generator` on that generator's device; gamma draws come from the
generator's own normals and uniforms (`standard_gamma`), since torch's
gamma sampler takes no generator.
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
    "GammaJointPrior",
    "GammaJointPriorAlt",
    "ExponentialJointPrior",
    "SortedUniformJointPrior",
    "CoreEdgeJointPrior",
    "IndependentJointPrior",
    "Uniform",
    "Normal",
    "LogNormal",
    "Gamma",
    "Exponential",
    "standard_gamma",
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
        call is a host-to-device copy, which waits for the card's queue.
        Made outside any `torch.func` transform, whose level a cached
        tensor must not belong to."""
        cache = self.__dict__.setdefault("_const_cache", {})
        key = (names, dtype, torch.device(device))
        if key not in cache:
            with torch._C._DisableFuncTorch():
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


# Marsaglia-Tsang proposals per draw: each is accepted with probability
# above 0.95, so all 12 fail with probability below 0.05**12 = 2.4e-16
# (such a draw is NaN)
_GAMMA_ROUNDS = 12


def standard_gamma(generator: torch.Generator, a: torch.Tensor) -> torch.Tensor:
    """Gamma(a, 1) draws, one per entry of ``a`` (on the generator's
    device), by Marsaglia and Tsang's method from the generator's own
    normals and uniforms: `_GAMMA_ROUNDS` proposals per entry in one batch,
    the first accepted one kept; for a < 1 a draw at a + 1 times
    ``U^(1/a)``. Deterministic for a given generator state."""
    dev, dtype = generator.device, a.dtype
    a = a.to(dev)
    boost = a < 1.0
    d = torch.where(boost, a + 1.0, a) - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    shape = (_GAMMA_ROUNDS,) + tuple(a.shape)
    z = torch.randn(shape, generator=generator, dtype=dtype, device=dev)
    lu = torch.log(torch.rand(shape, generator=generator, dtype=dtype, device=dev))
    v = (1.0 + c * z) ** 3
    log_v = torch.log(torch.clamp(v, min=torch.finfo(dtype).tiny))
    ok = (v > 0) & (lu < 0.5 * z * z + d - d * v + d * log_v)
    first = torch.argmax(ok.to(torch.uint8), 0, keepdim=True)  # first accepted round
    g = torch.take_along_dim(d * v, first, 0)[0]
    g = torch.where(ok.any(0), g, math.nan)
    ub = torch.rand(tuple(a.shape), generator=generator, dtype=dtype, device=dev)
    return torch.where(boost, g * ub ** (1.0 / a), g)


class GammaJointPrior(JointPrior):
    """Independent gammas on (0, inf), shape ``a`` and scale ``b``:
    ``p(x) = x^(a-1) exp(-x/b) / (Gamma(a) b^a)``."""

    def __init__(self, a, b, dim: int | None = None):
        k = _dim_of(a, b, dim)
        self.a = _as_tuple(a, k)
        self.b = _as_tuple(b, k)
        if any(v <= 0 for v in self.a) or any(v <= 0 for v in self.b):
            raise ValueError("a, b must be positive")
        self.dim = k
        self.log_norm = tuple(-math.lgamma(ai) - ai * math.log(bi)
                              for ai, bi in zip(self.a, self.b))

    def log_prob(self, theta):
        a, b, norm = self._consts(("a", "b", "log_norm"), theta.dtype, theta.device)
        pos = theta > 0
        x = torch.where(pos, theta, torch.ones_like(theta))
        lp = ((a - 1.0) * torch.log(x) - x / b + norm).sum(-1)
        return torch.where(pos.all(-1), lp, torch.full_like(lp, -math.inf))

    def sample(self, generator, shape, dtype):
        a, b = self._consts(("a", "b"), dtype, generator.device)
        return standard_gamma(generator, a.expand(tuple(shape) + (self.dim,))) * b

    @property
    def bounds(self):
        return [(0.0, math.inf)] * self.dim


class GammaJointPriorAlt(GammaJointPrior):
    """Gamma by mode ``m`` and standard deviation ``s``: ``b = (-m +
    sqrt(m^2 + 4 s^2)) / 2``, ``a = 1 + m / b``."""

    def __init__(self, mode, std, dim: int | None = None):
        k = _dim_of(mode, std, dim)
        m = _as_tuple(mode, k)
        s = _as_tuple(std, k)
        b = tuple((-mi + math.sqrt(mi * mi + 4 * si * si)) / 2.0 for mi, si in zip(m, s))
        a = tuple(1.0 + mi / bi for mi, bi in zip(m, b))
        super().__init__(a, b, dim=k)
        self.mode = m
        self.std = s


class ExponentialJointPrior(GammaJointPrior):
    """Independent exponentials of rate ``rate`` (a gamma with a = 1)."""

    def __init__(self, rate, dim: int | None = None):
        k = dim if dim is not None else (len(rate) if np.ndim(rate) > 0 else 1)
        r = _as_tuple(rate, k)
        super().__init__((1.0,) * k, tuple(1.0 / ri for ri in r), dim=k)
        self.rate = r


class SortedUniformJointPrior(JointPrior):
    """Uniform over ``lb < x_1 < ... < x_k < ub``: density ``k! / (ub -
    lb)^k`` there, ``-inf`` elsewhere; its bijector is the
    `OrderedIntervalBijector`, so a sampler never proposes an unordered
    point."""

    def __init__(self, dim: int, lb: float, ub: float):
        if not (ub > lb):
            raise ValueError("need ub > lb")
        self.dim = int(dim)
        self.lb = float(lb)
        self.ub = float(ub)

    def log_prob(self, theta):
        inside = (
            (theta >= self.lb).all(-1)
            & (theta <= self.ub).all(-1)
            & (torch.diff(theta, dim=-1) > 0).all(-1)
        )
        lp = math.lgamma(self.dim + 1) - self.dim * math.log(self.ub - self.lb)
        full = torch.full(inside.shape, lp, dtype=theta.dtype, device=theta.device)
        return torch.where(inside, full, -math.inf)

    def sample(self, generator, shape, dtype):
        u = torch.rand(tuple(shape) + (self.dim,), generator=generator, dtype=dtype,
                       device=generator.device)
        return torch.sort(self.lb + (self.ub - self.lb) * u, dim=-1).values

    @property
    def bounds(self):
        return [(self.lb, self.ub)] * self.dim

    def bijector(self):
        return bij.OrderedIntervalBijector(self.lb, self.ub, self.dim)


class CoreEdgeJointPrior(SortedUniformJointPrior):
    """The reference's sorted two-block prior for (core, edge) length-scale
    pairs: a sorted uniform over the common interval."""


class _Dist1D:
    """A scalar distribution for `IndependentJointPrior`: ``log_pdf`` of
    x (...) -> (...), ``sample`` -> ``shape``."""

    bounds: tuple

    def log_pdf(self, x):
        return self._p.log_prob(x[..., None])

    def sample(self, generator, shape, dtype):
        return self._p.sample(generator, shape, dtype)[..., 0]


class Uniform(_Dist1D):
    def __init__(self, lo: float, hi: float):
        self._p = UniformJointPrior([lo], [hi])
        self.bounds = (lo, hi)


class Normal(_Dist1D):
    def __init__(self, mu: float, sigma: float):
        self._p = NormalJointPrior([mu], [sigma])
        self.bounds = (-math.inf, math.inf)


class LogNormal(_Dist1D):
    def __init__(self, mu: float, sigma: float):
        self._p = LogNormalJointPrior([mu], [sigma])
        self.bounds = (0.0, math.inf)


class Gamma(_Dist1D):
    def __init__(self, a: float, b: float):
        self._p = GammaJointPrior([a], [b])
        self.bounds = (0.0, math.inf)


class Exponential(_Dist1D):
    def __init__(self, rate: float):
        self._p = ExponentialJointPrior([rate])
        self.bounds = (0.0, math.inf)


class IndependentJointPrior(JointPrior):
    """Product of the scalar distributions ``univariates``, one per
    parameter."""

    def __init__(self, univariates: Sequence[_Dist1D]):
        self.univariates = tuple(univariates)
        self.dim = len(self.univariates)

    def log_prob(self, theta):
        lps = [d.log_pdf(theta[..., i]) for i, d in enumerate(self.univariates)]
        return sum(lps[1:], lps[0])

    def sample(self, generator, shape, dtype):
        return torch.stack([d.sample(generator, shape, dtype) for d in self.univariates], -1)

    @property
    def bounds(self):
        return [d.bounds for d in self.univariates]
