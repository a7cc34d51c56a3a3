"""Parametric prior mean functions, chains-minor.

Counterpart of `gptools_tpu.models.mean` (`MeanFunction`,
`ConstantMeanFunction`, `LinearMeanFunction`, `MtanhMeanFunction1d`,
`SumMeanFunction` through ``m1 + m2``, `ArbitraryMeanFunction`) and of
the mean half of `gptools_tpu.ops.assemble` (`mean_vector`). Metadata
(names, bounds, initial values, fixed flags, hyperprior) follows the
reference. Where the reference evaluates one parameter vector per call
under ``vmap``, here ``_scalar(X (N, D), thetaT (P, C)) -> (N, C)`` takes
the whole chain batch, and `mean_vector` takes each derivative order by
the forward-mode towers of `ops.derivs` in x (each row of the output
depends on its own row of X only). `mean_vector` hands `_scalar` each
chain's parameters already expanded to the points, (P, N, C), so that the
mean is elementwise in (point, chain) and the sum of a chain's cotangents
over the points has an order fixed for any number of chains
(`ops.fused._ExpandRow`; the rule is in `parallel.mesh`).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from gptools_tpu_torch.ops import derivs
from gptools_tpu_torch.ops.derivs import MultiIndex
from gptools_tpu_torch.ops.fused import _expand_rows
from gptools_tpu_torch.utils.priors import JointPrior, UniformJointPrior

__all__ = [
    "MeanFunction",
    "ConstantMeanFunction",
    "LinearMeanFunction",
    "MtanhMeanFunction1d",
    "SumMeanFunction",
    "ArbitraryMeanFunction",
    "mean_vector",
]


class MeanFunction:
    """Base parametric mean ``m(x, theta)``; the metadata protocol of
    `gptools_tpu_torch.ops.kernels.Kernel`."""

    def __init__(
        self,
        num_dim: int,
        param_names: Sequence[str],
        initial_params: Optional[Sequence[float]] = None,
        fixed_params: Optional[Sequence[bool]] = None,
        param_bounds: Optional[Sequence[tuple]] = None,
        hyperprior: Optional[JointPrior] = None,
        default_bounds: Optional[Sequence[tuple]] = None,
    ):
        self.num_dim = int(num_dim)
        self.param_names = tuple(param_names)
        k = len(self.param_names)
        if param_bounds is None:
            if hyperprior is not None:
                param_bounds = hyperprior.bounds
            elif default_bounds is not None:
                param_bounds = default_bounds
            else:
                param_bounds = [(-1e4, 1e4)] * k
        self.param_bounds = [
            (-math.inf if lo is None else float(lo), math.inf if hi is None else float(hi))
            for lo, hi in param_bounds
        ]
        if hyperprior is None and k:
            finite = [
                (lo if math.isfinite(lo) else -1e6, hi if math.isfinite(hi) else 1e6)
                for lo, hi in self.param_bounds
            ]
            hyperprior = UniformJointPrior(finite)
        self.hyperprior = hyperprior
        if initial_params is None:
            initial_params = [
                0.5 * (max(lo, -1e2) + min(hi, 1e2)) for lo, hi in self.param_bounds
            ]
        self.initial_params = tuple(float(v) for v in initial_params)
        if fixed_params is None:
            fixed_params = [False] * k
        self.fixed_params = tuple(bool(v) for v in fixed_params)

    @property
    def num_params(self) -> int:
        return len(self.param_names)

    def _scalar(self, X: torch.Tensor, thetaT: torch.Tensor) -> torch.Tensor:
        """Mean values at points X (N, D) for chains thetaT (P, C) or
        (P, N, C) -> (N, C): each row ``thetaT[p]`` broadcasts against a
        column ``X[:, d:d+1]``, with no sum over the points or the
        chains."""
        raise NotImplementedError

    def scalar(self, x: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
        """``m(x, theta)`` for one parameter vector theta (P,) at a point x
        (D,), or at a batch of points x (..., D) -> (...)."""
        X = x.reshape(-1, self.num_dim)
        return self._scalar(X, theta.reshape(-1, 1))[:, 0].reshape(x.shape[:-1])

    def block_fn(self, a: MultiIndex) -> Callable:
        """``(x, theta) -> d^a_x m(x, theta)``, elementwise over the points."""
        return derivs.mean_block_fn(self.scalar, a)

    def __call__(self, x, theta, n=0):
        """The mean's derivative of order ``n`` at x (D,) or (..., D);
        inputs that are not tensors become float64 tensors."""
        a = derivs.normalize_multi_index(n, self.num_dim)

        def t(v):
            return v if torch.is_tensor(v) else torch.as_tensor(v, dtype=torch.float64)

        return self.block_fn(a)(t(x), t(theta))

    def __add__(self, other):
        if isinstance(other, MeanFunction):
            return SumMeanFunction(self, other)
        return NotImplemented


class SumMeanFunction(MeanFunction):
    """``m1 + m2``: parameters ``m1.*`` then ``m2.*``, the prior the
    product of the parts' (or the one that exists)."""

    def __init__(self, m1: MeanFunction, m2: MeanFunction):
        if m1.num_dim != m2.num_dim:
            raise ValueError("summed means must share num_dim")
        self.m1, self.m2 = m1, m2
        if m1.hyperprior is not None and m2.hyperprior is not None:
            prior = m1.hyperprior * m2.hyperprior
        else:
            prior = m1.hyperprior or m2.hyperprior
        super().__init__(
            m1.num_dim,
            tuple(f"m1.{n}" for n in m1.param_names) + tuple(f"m2.{n}" for n in m2.param_names),
            initial_params=m1.initial_params + m2.initial_params,
            fixed_params=m1.fixed_params + m2.fixed_params,
            param_bounds=m1.param_bounds + m2.param_bounds,
            hyperprior=prior,
        )

    def _scalar(self, X, thetaT):
        p1 = self.m1.num_params
        return self.m1._scalar(X, thetaT[:p1]) + self.m2._scalar(X, thetaT[p1:])


class ArbitraryMeanFunction(MeanFunction):
    """A mean given as a torch callable ``fn(x, theta)`` with the kernels'
    broadcast convention: points x (..., D) against parameters (..., P)
    -> (...)."""

    def __init__(self, fn: Callable, num_dim: int, param_names, **kw):
        self.fn = fn
        super().__init__(num_dim, param_names, **kw)

    def _scalar(self, X, thetaT):
        return self.fn(X[:, None, :], thetaT.movedim(0, -1))


class ConstantMeanFunction(MeanFunction):
    """``m(x) = c``."""

    def __init__(self, num_dim: int = 1, **kw):
        super().__init__(num_dim, ("c",), **kw)

    def _scalar(self, X, thetaT):
        return thetaT[0].expand(X.shape[0], thetaT.shape[-1])


class LinearMeanFunction(MeanFunction):
    """``m(x) = sum_d a_d x_d + b``; parameters ``(a_1, ..., a_D, b)``."""

    def __init__(self, num_dim: int = 1, **kw):
        names = tuple(f"a_{d+1}" for d in range(num_dim)) + ("b",)
        super().__init__(num_dim, names, **kw)

    def _scalar(self, X, thetaT):
        D = self.num_dim
        out = X[:, :1] * thetaT[0]
        for d in range(1, D):
            out = out + X[:, d : d + 1] * thetaT[d]
        return out + thetaT[D]


class MtanhMeanFunction1d(MeanFunction):
    """mtanh pedestal profile: ``z = (x0 - x) / (2 delta)``, ``m(x) =
    (ped - off)/2 (tanh z + alpha z sigmoid(2z) + 1) + off``; parameters
    ``(x0, delta, alpha, ped, off)``."""

    def __init__(self, **kw):
        kw.setdefault(
            "default_bounds",
            [(-1e2, 1e2), (1e-4, 1e2), (-1e2, 1e2), (-1e4, 1e4), (-1e4, 1e4)],
        )
        super().__init__(1, ("x0", "delta", "alpha", "ped", "off"), **kw)

    def _scalar(self, X, thetaT):
        x0, delta, alpha, ped, off = (thetaT[p] for p in range(5))
        z = (x0 - X[:, :1]) / (2.0 * delta)
        mt = torch.tanh(z) + alpha * z * torch.sigmoid(2.0 * z)
        return 0.5 * (ped - off) * (mt + 1.0) + off


def mean_vector(mean_fn: MeanFunction, thetaT, X, nid, multi_indices) -> torch.Tensor:
    """The mean at each observation's derivative order: thetaT (P, C),
    X (N, D), nid (N,) ids into ``multi_indices`` -> (N, C), at any
    derivative multi-index. Each chain's parameters are expanded to the
    points first (`_expand_rows`)."""
    if thetaT.shape[0]:
        thetaT = torch.stack(_expand_rows(thetaT.unbind(0), X.shape[0]))  # (P, N, C)

    def scalar(x):
        return mean_fn._scalar(x, thetaT)

    out = None
    for aid, a in enumerate(tuple(tuple(m) for m in multi_indices)):
        vals = derivs.mixed_partial(scalar, (a,))(X)
        rows = (nid == aid)[:, None]
        out = torch.where(rows, vals, 0.0 if out is None else out)
    return out
