"""Covariance-function objects: parameter metadata for the config-4 kernel.

Counterpart of `gptools_tpu.ops.kernels`, reduced to what the batched
evidence path reads: names, bounds, initial values, fixed flags and the
hyperprior. The covariance itself is computed by the fused builder
(`gptools_tpu_torch.ops.fused`) and the CUDA kernel; the generic
``smooth_scalar`` / derivative-block surface is ROADMAP Queue 1 item 10 and
the other kernels and warps are items 9 and 11.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

from gptools_tpu_torch.utils.priors import JointPrior, UniformJointPrior

__all__ = [
    "Kernel",
    "LengthScaleWarp",
    "TanhWarp",
    "GibbsKernel",
    "GibbsKernel1dTanh",
]


def _norm_bounds(bounds, k):
    out = []
    for lo, hi in bounds:
        lo = -math.inf if lo is None else float(lo)
        hi = math.inf if hi is None else float(hi)
        out.append((lo, hi))
    if len(out) != k:
        raise ValueError(f"expected {k} bounds, got {len(out)}")
    return tuple(out)


class Kernel:
    """Base covariance function: parameter metadata only."""

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
        if hyperprior is not None and hyperprior.dim != k:
            raise ValueError(f"hyperprior dim {hyperprior.dim} != num params {k}")
        if param_bounds is None:
            if hyperprior is not None:
                param_bounds = hyperprior.bounds
            elif default_bounds is not None:
                param_bounds = default_bounds
            else:
                param_bounds = [(1e-4, 1e4)] * k
        self.param_bounds = list(_norm_bounds(param_bounds, k))
        if hyperprior is None:
            # reference default: uniform over the (finite-clipped) bounds
            finite = [
                (lo if math.isfinite(lo) else -1e6, hi if math.isfinite(hi) else 1e6)
                for lo, hi in self.param_bounds
            ]
            hyperprior = UniformJointPrior(finite)
        self.hyperprior = hyperprior
        if initial_params is None:
            initial_params = [
                self._default_initial(lo, hi) for lo, hi in self.param_bounds
            ]
        self.initial_params = tuple(float(v) for v in initial_params)
        if len(self.initial_params) != k:
            raise ValueError(f"expected {k} initial params")
        if fixed_params is None:
            fixed_params = [False] * k
        self.fixed_params = tuple(bool(v) for v in fixed_params)
        if len(self.fixed_params) != k:
            raise ValueError(f"expected {k} fixed flags")

    @staticmethod
    def _default_initial(lo, hi):
        if math.isfinite(lo) and math.isfinite(hi):
            return 0.5 * (lo + hi)
        if math.isfinite(lo):
            return lo + 1.0
        if math.isfinite(hi):
            return hi - 1.0
        return 0.0

    @property
    def num_params(self) -> int:
        return len(self.param_names)


class LengthScaleWarp:
    """Length-scale profile ``l(x) > 0`` for the Gibbs kernel (metadata)."""

    param_names: Tuple[str, ...]
    default_bounds: Tuple[tuple, ...]


class TanhWarp(LengthScaleWarp):
    """``l(x) = l1 + (l2 - l1)/2 * (1 + tanh((x - x0) / lw))``; the formula
    lives in `fused.gibbs_tanh_cov_fused_soa_sym` and the CUDA kernel."""

    param_names = ("l1", "l2", "lw", "x0")
    default_bounds = ((1e-4, 1e4), (1e-4, 1e4), (1e-4, 1e4), (-1e4, 1e4))


class GibbsKernel(Kernel):
    """Gibbs nonstationary covariance with input-dependent length scale;
    parameters ``(sigma_f,) + warp params``."""

    def __init__(self, warp: LengthScaleWarp, **kw):
        self.warp = warp
        names = ("sigma_f",) + tuple(warp.param_names)
        kw.setdefault("default_bounds", ((1e-4, 1e4),) + tuple(warp.default_bounds))
        super().__init__(1, names, **kw)


class GibbsKernel1dTanh(GibbsKernel):
    """The flagship kernel; parameters ``(sigma_f, l1, l2, lw, x0)``."""

    def __init__(self, **kw):
        super().__init__(TanhWarp(), **kw)
