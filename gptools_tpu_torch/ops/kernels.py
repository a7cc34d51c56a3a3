"""Covariance-function objects for configs 2-5.

Counterpart of `gptools_tpu.ops.kernels`: names, bounds, initial values,
fixed flags and the hyperprior, with the reference's parameter order and
defaults, and the covariance surface of the reference's `Kernel`
(``_scalar``, ``smooth_scalar``, ``block_fn``, ``__call__``,
``has_smooth``) for the squared exponential, the half-integer Matern
kernels, the Gibbs kernel with the tanh warp, the diagonal noise and the
`WarpedKernel` under a `LinearWarp` or `BetaWarp`. The scalars broadcast: points ``(..., D)``
and hyperparameters ``(..., P)`` (parameter axis last, so a leading theta
batch broadcasts too). Derivative blocks come from `ops.derivs`. The
batched evidence path does not use these scalars: it takes the fused
builders (`gptools_tpu_torch.ops.fused`) and the CUDA kernels.

The other kernels and warps (free-nu Matern, rational quadratic, the
kernel algebra, the other length-scale and input warps) are ROADMAP Queue 1
item 11.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Callable, Optional, Sequence, Tuple

import torch

from gptools_tpu_torch.models.dataset import MultiIndex, normalize_multi_index
from gptools_tpu_torch.ops import derivs
from gptools_tpu_torch.utils.priors import JointPrior, UniformJointPrior

__all__ = [
    "Kernel",
    "SquaredExponentialKernel",
    "MaternKernel",
    "Matern52Kernel",
    "LengthScaleWarp",
    "TanhWarp",
    "GibbsKernel",
    "GibbsKernel1dTanh",
    "DiagonalNoiseKernel",
    "InputWarp",
    "LinearWarp",
    "BetaWarp",
    "WarpedKernel",
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


_SCALARS = "the generic scalar of this kernel is ROADMAP Queue 1 item 11"


class Kernel:
    """Base covariance function: subclasses define ``_scalar(x1, x2,
    theta)``, the smooth part."""

    #: True when the kernel contributes a smooth (differentiable) part.
    has_smooth: bool = True

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

    def delta_terms(self):
        """``(param_offset, DiagonalNoiseKernel)`` white-noise terms."""
        return []

    # -- covariance ---------------------------------------------------------
    def _scalar(self, x1, x2, theta):
        raise NotImplementedError(f"{type(self).__name__}: {_SCALARS}")

    def smooth_scalar(self, x1, x2, theta):
        """Smooth covariance k(x1, x2); delta (white-noise) parts excluded."""
        return self._scalar(x1, x2, theta)

    def block_fn(self, a: MultiIndex, b: MultiIndex) -> Callable:
        """Derivative cross-covariance block ``d^a_x1 d^b_x2 k``."""
        return derivs.kernel_block_fn(self.smooth_scalar, a, b)

    def __call__(self, x1, x2, theta, ni=0, nj=0):
        """The derivative block for static orders ``ni`` / ``nj`` at points
        x1, x2 (D,) (or broadcast batches of them); inputs that are not
        tensors become float64 tensors."""
        a = normalize_multi_index(ni, self.num_dim)
        b = normalize_multi_index(nj, self.num_dim)

        def t(v):
            return v if torch.is_tensor(v) else torch.as_tensor(v, dtype=torch.float64)

        return self.block_fn(a, b)(t(x1), t(x2), t(theta))


class SquaredExponentialKernel(Kernel):
    """ARD squared exponential ``sigma_f^2 exp(-|x1 - x2|^2 / (2 l^2))``;
    parameters ``(sigma_f, l_1, ..., l_D)``."""

    def __init__(self, num_dim: int = 1, **kw):
        names = ("sigma_f",) + tuple(f"l_{d+1}" for d in range(num_dim))
        kw.setdefault("default_bounds", [(1e-4, 1e4)] * (num_dim + 1))
        super().__init__(num_dim, names, **kw)

    def _scalar(self, x1, x2, theta):
        sigma_f = theta[..., 0]
        ell = theta[..., 1 : 1 + self.num_dim]
        z = (x1 - x2) / ell
        return sigma_f * sigma_f * torch.exp(-0.5 * torch.sum(z * z, -1))


def _matern_poly(p: int):
    """Coefficients c_j of ``P_p(s) = sum_j c_j s^j`` in the half-integer
    Matern shape ``exp(-s) P_p(s)``, as exact rationals:
    c_{p-i} = p!/(2p)! (p+i)!/(i!(p-i)!) 2^{p-i}."""
    pref = Fraction(math.factorial(p), math.factorial(2 * p))
    c = [Fraction(0)] * (p + 1)
    for i in range(p + 1):
        c[p - i] = pref * Fraction(
            math.factorial(p + i), math.factorial(i) * math.factorial(p - i)
        ) * 2 ** (p - i)
    return c


def _matern_series_coeffs(p: int):
    """Taylor coefficients (t0, t1, t2) of the shape in ``u = s^2``:
    ``f = t0 + t1 u + t2 u^2 + O(u^{5/2})``, from the coefficients a_m of
    s^m in ``exp(-s) P_p(s)``."""
    c = _matern_poly(p)

    def a(m):
        return sum(c[j] * Fraction((-1) ** (m - j), math.factorial(m - j))
                   for j in range(min(m, p) + 1))

    return float(a(0)), float(a(2)), float(a(4))


class MaternKernel(Kernel):
    """Half-integer Matern kernel, ARD, ``nu = p + 1/2`` with p >= 1:

        k = sigma_f^2 exp(-s) P_p(s),   s = sqrt(2 nu) r,
        r^2 = sum_d (x1_d - x2_d)^2 / l_d^2;

    parameters ``(sigma_f, l_1, ..., l_D)``. Below ``u = s^2 = _U_SWITCH``
    the shape is its even Taylor series in u, so the derivative blocks are
    finite and exact at coincident points (the exact branch is evaluated at
    a safe argument there, so its tangents stay finite). Only p = 2 has a
    fused builder and an evidence-kernel kind; free nu is ROADMAP Queue 1
    item 11."""

    _U_SWITCH = 1e-6

    def __init__(self, nu: float = 2.5, num_dim: int = 1, **kw):
        two_nu = 2.0 * nu
        if abs(two_nu - round(two_nu)) > 1e-12 or round(two_nu) % 2 == 0:
            raise NotImplementedError(
                "MaternKernel: closed form requires half-integer nu "
                "(nu = p + 1/2); free nu is ROADMAP Queue 1 item 11"
            )
        self.nu = float(nu)
        self.p = int(round(nu - 0.5))
        if self.p == 0:
            raise NotImplementedError(
                "nu = 1/2 (exponential kernel) is not differentiable at "
                "coincident points; use MaternKernel(nu=1.5) or higher"
            )
        self._poly = tuple(float(v) for v in _matern_poly(self.p))
        self._taylor = _matern_series_coeffs(self.p)
        names = ("sigma_f",) + tuple(f"l_{d+1}" for d in range(num_dim))
        kw.setdefault("default_bounds", [(1e-4, 1e4)] * (num_dim + 1))
        super().__init__(num_dim, names, **kw)

    def _scalar(self, x1, x2, theta):
        sigma_f = theta[..., 0]
        z = (x1 - x2) / theta[..., 1 : 1 + self.num_dim]
        u = 2.0 * self.nu * torch.sum(z * z, -1)
        far = u > self._U_SWITCH
        s = torch.sqrt(torch.where(far, u, 1.0))
        poly = self._poly[self.p]
        for c in self._poly[-2::-1]:
            poly = poly * s + c
        t0, t1, t2 = self._taylor
        f = torch.where(far, torch.exp(-s) * poly, t0 + u * (t1 + u * t2))
        return sigma_f * sigma_f * f


class Matern52Kernel(MaternKernel):
    """Fixed nu = 5/2 Matern."""

    def __init__(self, num_dim: int = 1, **kw):
        super().__init__(nu=2.5, num_dim=num_dim, **kw)


class LengthScaleWarp:
    """Length-scale profile ``l(x) > 0`` for the Gibbs kernel."""

    param_names: Tuple[str, ...]
    default_bounds: Tuple[tuple, ...]

    def __call__(self, x, theta):
        """x: input coordinates; theta: (..., num_params) -> l(x)."""
        raise NotImplementedError(f"{type(self).__name__}: {_SCALARS}")


class TanhWarp(LengthScaleWarp):
    """``l(x) = l1 + (l2 - l1)/2 * (1 + tanh((x - x0) / lw))``; parameters
    ``(l1, l2, lw, x0)``. The fused builders and the CUDA kernels carry the
    same formula with its slope."""

    param_names = ("l1", "l2", "lw", "x0")
    default_bounds = ((1e-4, 1e4), (1e-4, 1e4), (1e-4, 1e4), (-1e4, 1e4))

    def __call__(self, x, theta):
        l1, l2, lw, x0 = theta[..., 0], theta[..., 1], theta[..., 2], theta[..., 3]
        return l1 + 0.5 * (l2 - l1) * (1.0 + torch.tanh((x - x0) / lw))


class GibbsKernel(Kernel):
    """Gibbs nonstationary covariance with input-dependent length scale;
    parameters ``(sigma_f,) + warp params``."""

    def __init__(self, warp: LengthScaleWarp, **kw):
        self.warp = warp
        names = ("sigma_f",) + tuple(warp.param_names)
        kw.setdefault("default_bounds", ((1e-4, 1e4),) + tuple(warp.default_bounds))
        super().__init__(1, names, **kw)

    def _scalar(self, x1, x2, theta):
        sigma_f = theta[..., 0]
        tw = theta[..., 1:]
        l1 = self.warp(x1[..., 0], tw)
        l2 = self.warp(x2[..., 0], tw)
        s2 = l1 * l1 + l2 * l2
        d = x1[..., 0] - x2[..., 0]
        return sigma_f * sigma_f * torch.sqrt(2.0 * l1 * l2 / s2) * torch.exp(-d * d / s2)


class GibbsKernel1dTanh(GibbsKernel):
    """The flagship kernel; parameters ``(sigma_f, l1, l2, lw, x0)``."""

    def __init__(self, **kw):
        super().__init__(TanhWarp(), **kw)


class DiagonalNoiseKernel(Kernel):
    """White noise ``sigma_n^2`` on matching (x, derivative order) rows,
    restricted to observations of order ``n`` when one is given
    (``n_match``); parameter ``(sigma_n,)``."""

    has_smooth = False

    def __init__(self, num_dim: int = 1, n=None, **kw):
        self.n_match = None if n is None else normalize_multi_index(n, num_dim)
        kw.setdefault("default_bounds", [(0.0, 1e4)])
        super().__init__(num_dim, ("sigma_n",), **kw)

    def _scalar(self, x1, x2, theta):
        # the smooth part of white noise is identically zero
        return torch.zeros(torch.broadcast_shapes(x1.shape[:-1], x2.shape[:-1]),
                           dtype=torch.result_type(x1, x2))

    def delta_terms(self):
        return [(0, self)]

    def delta_value(self, theta):
        """Variance added on matching diagonal entries."""
        return theta[..., 0] * theta[..., 0]


class InputWarp:
    """Monotone coordinate map ``w(x, theta)``, applied to each input
    dimension; x broadcasts against theta's leading axes, the warp's
    parameters on its last axis."""

    param_names: Tuple[str, ...] = ()
    default_bounds: Tuple[tuple, ...] = ()

    @property
    def num_params(self):
        return len(self.param_names)

    def __call__(self, x, theta):
        raise NotImplementedError(
            f"input warp {type(self).__name__}: only LinearWarp and BetaWarp "
            "are ported; the others are ROADMAP Queue 1 item 11"
        )


class LinearWarp(InputWarp):
    """``w(x) = (x - a) / (b - a)`` with static a, b."""

    def __init__(self, a: float, b: float):
        self.a = float(a)
        self.b = float(b)

    def __call__(self, x, theta):
        return (x - self.a) / (self.b - self.a)


class BetaWarp(InputWarp):
    """Beta-CDF warp ``w(x) = I_x(a, b)`` on [0, 1]; parameters (a, b),
    through the quadrature `special.betainc_dd` (differentiable in x, a
    and b)."""

    param_names = ("a", "b")
    default_bounds = ((1e-2, 1e2), (1e-2, 1e2))

    def __call__(self, x, theta):
        from gptools_tpu_torch.ops.special import betainc_dd

        return betainc_dd(theta[..., 0], theta[..., 1], x)


class WarpedKernel(Kernel):
    """``k(w(x1), w(x2))``: the base kernel's parameters, then the warp's
    (named ``warp.*``), with the reference's defaults for initial values,
    fixed flags and bounds."""

    def __init__(self, base: Kernel, warp: InputWarp, **kw):
        if base.delta_terms():
            raise ValueError("cannot warp a kernel containing delta terms")
        self.base = base
        self.input_warp = warp
        names = base.param_names + tuple(f"warp.{n}" for n in warp.param_names)
        kw.setdefault(
            "initial_params",
            base.initial_params
            + tuple(Kernel._default_initial(lo, hi) for lo, hi in warp.default_bounds),
        )
        kw.setdefault("fixed_params", base.fixed_params + (False,) * warp.num_params)
        kw.setdefault(
            "param_bounds", list(base.param_bounds) + list(warp.default_bounds)
        )
        super().__init__(base.num_dim, names, **kw)

    def _scalar(self, x1, x2, theta):
        pb = self.base.num_params
        tb, tw = theta[..., :pb], theta[..., pb:]
        w1 = torch.stack([self.input_warp(x1[..., d], tw) for d in range(self.num_dim)], -1)
        w2 = torch.stack([self.input_warp(x2[..., d], tw) for d in range(self.num_dim)], -1)
        return self.base.smooth_scalar(w1, w2, tb)
