"""Covariance-function zoo.

Counterpart of `gptools_tpu.ops.kernels`: names, bounds, initial values,
fixed flags and the hyperprior, with the reference's parameter order and
defaults, and the covariance surface of the reference's `Kernel`
(``_scalar``, ``smooth_scalar``, ``delta_terms``, ``block_fn``,
``__call__``, ``has_smooth``, ``+`` / ``*``) for every kernel of the
reference: the squared exponential, the half-integer Matern kernels, the
free-nu Matern (`MaternGeneralKernel`, through `special.bessel_kve`), the
rational quadratic, the Gibbs kernel with the tanh, Gauss, exp and
interpolated length-scale warps, the diagonal noise, the `WarpedKernel`
under a `LinearWarp`, `BetaWarp` or `ArbitraryWarp`, and the algebra (sum,
product, scaled, masked, arbitrary, chain-rule, constant and zero
kernels). The scalars broadcast: points ``(..., D)`` and hyperparameters
``(..., P)`` (parameter axis last, so a leading theta batch broadcasts
too); the callables of `ArbitraryKernel`, `ChainRuleKernel` and
`ArbitraryWarp` are torch functions with the same convention. Derivative
blocks come from `ops.derivs`. The batched evidence path does not use
these scalars where a fused builder or a CUDA kind exists
(`gptools_tpu_torch.ops.fused`); elsewhere the per-chain route evaluates
them, in chunks of `models.gp._PER_CHAIN_ENTRIES` over each kernel's
``entry_cost``.
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
    "SumKernel",
    "ProductKernel",
    "ScaledKernel",
    "MaskedKernel",
    "ArbitraryKernel",
    "ChainRuleKernel",
    "ConstantKernel",
    "ZeroKernel",
    "SquaredExponentialKernel",
    "MaternKernel",
    "MaternGeneralKernel",
    "MaternKernelArb",
    "Matern52Kernel",
    "RationalQuadraticKernel",
    "LengthScaleWarp",
    "TanhWarp",
    "GaussWarp",
    "ExpWarp",
    "InterpolatedWarp",
    "GibbsKernel",
    "GibbsKernel1dTanh",
    "GibbsKernel1dGauss",
    "GibbsKernel1dExp",
    "DiagonalNoiseKernel",
    "InputWarp",
    "LinearWarp",
    "BetaWarp",
    "ArbitraryWarp",
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


def _batch_shape(x1, x2, theta):
    """The broadcast batch of a scalar's points and hyperparameters."""
    return torch.broadcast_shapes(x1.shape[:-1], x2.shape[:-1], theta.shape[:-1])


class Kernel:
    """Base covariance function: subclasses define ``_scalar(x1, x2,
    theta)``, the smooth part."""

    #: True when the kernel contributes a smooth (differentiable) part.
    has_smooth: bool = True
    #: Intermediate entries the scalar keeps per covariance entry (a
    #: quadrature's nodes); the per-chain route sizes its chunks by it.
    entry_cost: int = 1

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

    @property
    def num_free_params(self) -> int:
        return sum(not f for f in self.fixed_params)

    @property
    def free_param_names(self):
        return tuple(n for n, f in zip(self.param_names, self.fixed_params) if not f)

    def delta_terms(self):
        """``(param_offset, DiagonalNoiseKernel)`` white-noise terms."""
        return []

    # -- covariance ---------------------------------------------------------
    def _scalar(self, x1, x2, theta):
        raise NotImplementedError(f"{type(self).__name__} defines no _scalar")

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

    # -- algebra ------------------------------------------------------------
    def __add__(self, other):
        if isinstance(other, Kernel):
            return SumKernel(self, other)
        return NotImplemented

    def __mul__(self, other):
        if isinstance(other, Kernel):
            return ProductKernel(self, other)
        if isinstance(other, (int, float)):
            return ScaledKernel(self, float(other))
        return NotImplemented

    __rmul__ = __mul__


class _CombinedKernel(Kernel):
    """Binary combination: parameters ``k1.*`` then ``k2.*``, the prior
    ``k1.hyperprior * k2.hyperprior``."""

    def __init__(self, k1: Kernel, k2: Kernel):
        if k1.num_dim != k2.num_dim:
            raise ValueError("combined kernels must share num_dim")
        self.k1 = k1
        self.k2 = k2
        names = tuple(f"k1.{n}" for n in k1.param_names) + tuple(
            f"k2.{n}" for n in k2.param_names
        )
        super().__init__(
            k1.num_dim,
            names,
            initial_params=k1.initial_params + k2.initial_params,
            fixed_params=k1.fixed_params + k2.fixed_params,
            param_bounds=k1.param_bounds + k2.param_bounds,
            hyperprior=k1.hyperprior * k2.hyperprior,
        )

    @property
    def entry_cost(self):
        return self.k1.entry_cost + self.k2.entry_cost

    def _split(self, theta):
        p1 = self.k1.num_params
        return theta[..., :p1], theta[..., p1:]


class SumKernel(_CombinedKernel):
    """``k1 + k2``; white-noise terms of either part are kept (those of
    ``k2`` at offsets shifted by ``k1.num_params``)."""

    def smooth_scalar(self, x1, x2, theta):
        t1, t2 = self._split(theta)
        parts = []
        if self.k1.has_smooth:
            parts.append(self.k1.smooth_scalar(x1, x2, t1))
        if self.k2.has_smooth:
            parts.append(self.k2.smooth_scalar(x1, x2, t2))
        if not parts:
            return torch.zeros(_batch_shape(x1, x2, theta),
                               dtype=torch.result_type(x1, theta), device=x1.device)
        return sum(parts[1:], parts[0])

    _scalar = smooth_scalar

    @property
    def has_smooth(self):
        return self.k1.has_smooth or self.k2.has_smooth

    def delta_terms(self):
        p1 = self.k1.num_params
        return list(self.k1.delta_terms()) + [
            (off + p1, dk) for off, dk in self.k2.delta_terms()
        ]


class ProductKernel(_CombinedKernel):
    """``k1 * k2``; products with white-noise terms are refused."""

    def __init__(self, k1: Kernel, k2: Kernel):
        if k1.delta_terms() or k2.delta_terms():
            raise ValueError(
                "products involving white-noise (delta) kernels are not "
                "supported; add noise at the top level instead"
            )
        super().__init__(k1, k2)

    def _scalar(self, x1, x2, theta):
        t1, t2 = self._split(theta)
        return self.k1.smooth_scalar(x1, x2, t1) * self.k2.smooth_scalar(x1, x2, t2)


class ScaledKernel(Kernel):
    """``c * k`` for a static constant c."""

    def __init__(self, base: Kernel, factor: float):
        if base.delta_terms():
            raise ValueError("cannot scale a kernel containing delta terms")
        self.base = base
        self.factor = float(factor)
        super().__init__(
            base.num_dim,
            base.param_names,
            initial_params=base.initial_params,
            fixed_params=base.fixed_params,
            param_bounds=base.param_bounds,
            hyperprior=base.hyperprior,
        )

    @property
    def entry_cost(self):
        return self.base.entry_cost

    def _scalar(self, x1, x2, theta):
        return self.factor * self.base.smooth_scalar(x1, x2, theta)


class MaskedKernel(Kernel):
    """``base`` on the input dimensions ``active_dims`` of ``total_dim``
    (derivatives along the others are exactly zero)."""

    def __init__(self, base: Kernel, total_dim: int, active_dims: Sequence[int]):
        active = tuple(int(d) for d in active_dims)
        if len(active) != base.num_dim:
            raise ValueError("len(active_dims) must equal base.num_dim")
        if any(d < 0 or d >= total_dim for d in active):
            raise ValueError("active_dims out of range")
        self.base = base
        self.active_dims = active
        self._idx = {}
        super().__init__(
            total_dim,
            base.param_names,
            initial_params=base.initial_params,
            fixed_params=base.fixed_params,
            param_bounds=base.param_bounds,
            hyperprior=base.hyperprior,
        )

    @property
    def entry_cost(self):
        return self.base.entry_cost

    def _dims_on(self, device):
        """The active dimensions as an index on ``device``, made once
        outside any jvp tower (indexing by a list would copy it to the
        card on every call, which a CUDA graph capture refuses)."""
        if device not in self._idx:
            with torch._C._DisableFuncTorch():
                self._idx[device] = torch.tensor(self.active_dims, device=device)
        return self._idx[device]

    def _scalar(self, x1, x2, theta):
        idx = self._dims_on(x1.device)
        return self.base.smooth_scalar(x1.index_select(-1, idx), x2.index_select(-1, idx),
                                       theta)

    def delta_terms(self):
        return self.base.delta_terms()


class ArbitraryKernel(Kernel):
    """A scalar covariance given as a torch callable ``fn(x1, x2, theta)``
    with the broadcast convention of this module (points (..., D),
    hyperparameters (..., P) -> (...))."""

    def __init__(self, fn: Callable, num_dim: int, param_names, **kw):
        self.fn = fn
        super().__init__(num_dim, param_names, **kw)

    def _scalar(self, x1, x2, theta):
        return self.fn(x1, x2, theta)


class ChainRuleKernel(ArbitraryKernel):
    """``k(x1, x2) = outer(inner(x1, x2, theta), theta)``, both torch
    callables with the broadcast convention (``inner`` -> (...), ``outer``
    elementwise); the chain rule comes from the jvp towers."""

    def __init__(self, outer: Callable, inner: Callable, num_dim: int, param_names, **kw):
        self.outer = outer
        self.inner = inner
        super().__init__(
            lambda x1, x2, theta: outer(inner(x1, x2, theta), theta),
            num_dim,
            param_names,
            **kw,
        )


class ConstantKernel(Kernel):
    """Constant covariance ``k = sigma2``; parameter ``(sigma2,)``."""

    def __init__(self, num_dim: int = 1, **kw):
        kw.setdefault("default_bounds", [(1e-8, 1e4)])
        super().__init__(num_dim, ("sigma2",), **kw)

    def _scalar(self, x1, x2, theta):
        return torch.broadcast_to(theta[..., 0], _batch_shape(x1, x2, theta))


class ZeroKernel(Kernel):
    """Identically-zero kernel; no parameters."""

    def __init__(self, num_dim: int = 1):
        super().__init__(num_dim, ())

    def _scalar(self, x1, x2, theta):
        return torch.zeros(_batch_shape(x1, x2, theta), dtype=torch.result_type(x1, x2),
                           device=x1.device)


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
    fused builder and an evidence-kernel kind; for a real (free) nu use
    `MaternGeneralKernel`."""

    _U_SWITCH = 1e-6

    def __init__(self, nu: float = 2.5, num_dim: int = 1, **kw):
        two_nu = 2.0 * nu
        if abs(two_nu - round(two_nu)) > 1e-12 or round(two_nu) % 2 == 0:
            raise NotImplementedError(
                "MaternKernel: closed form requires half-integer nu "
                "(nu = p + 1/2); for general real nu use MaternGeneralKernel"
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


class MaternGeneralKernel(Kernel):
    """Matern kernel with a free real smoothness nu, ARD:

        k = sigma_f^2 2^(1-nu)/Gamma(nu) s^nu K_nu(s),   s = sqrt(2 nu) r;

    parameters ``(sigma_f, nu, l_1, ..., l_D)``, K_nu from
    `special.bessel_kve` (differentiable in nu and s). Below ``u = 2 nu r^2
    = _U_SWITCH`` the shape is its two-series expansion (DLMF 10.31: the
    analytic part and the ``u^nu`` branch, the latter masked below
    ``_U_TINY``), so the value, (0,1) and (1,1) blocks are exact at and near
    coincident points for nu > 1; inside the series nu is nudged 1e-6 off
    an integer, where the two series have cancelling poles. The Bessel
    recurrence's length comes from the largest nu the bounds and the
    prior's support allow (`bessel_kve`'s ``max_order``)."""

    _U_SWITCH = 1e-2
    _U_TINY = 1e-25
    _SERIES_M = 5
    _NUM_NODES = 384  # bessel_kve's quadrature nodes

    # the quadratures at mu and mu + 1 each keep a node axis
    entry_cost = 2 * _NUM_NODES

    def __init__(self, num_dim: int = 1, **kw):
        names = ("sigma_f", "nu") + tuple(f"l_{d+1}" for d in range(num_dim))
        kw.setdefault(
            "default_bounds",
            [(1e-4, 1e4), (0.51, 30.0)] + [(1e-4, 1e4)] * num_dim,
        )
        super().__init__(num_dim, names, **kw)

    def nu_max_order(self) -> int:
        """``floor`` of the largest nu the sampler (the prior's support) or
        the optimizer (``param_bounds``) can reach, at most 63."""
        hi = max(float(self.param_bounds[1][1]), float(self.hyperprior.bounds[1][1]))
        return int(min(math.floor(hi), 63)) if math.isfinite(hi) else 63

    def _shape_series(self, u, nu):
        """shape(u) for small u (DLMF 10.31 / 10.27.4): ``sum_m (u/4)^m /
        (m! prod_{j<=m}(j - nu)) - [Gamma(1-nu)/Gamma(1+nu)] (u/4)^nu sum_m
        (u/4)^m / (m! prod_{j<=m}(j + nu))``, nu nudged off integers."""
        r = torch.round(nu)
        near = torch.abs(nu - r) < 1e-6
        nu = torch.where(near & (r >= 1.0), torch.where(nu >= r, r + 1e-6, r - 1e-6), nu)
        q = 0.25 * u
        A = torch.ones_like(u)
        B = torch.ones_like(u)
        tA = torch.ones_like(u)
        tB = torch.ones_like(u)
        for m in range(1, self._SERIES_M + 1):
            tA = tA * q / (m * (m - nu))
            tB = tB * q / (m * (m + nu))
            A = A + tA
            B = B + tB
        # Gamma(1-nu)/Gamma(1+nu) = pi / (sin(pi nu) Gamma(nu) Gamma(1+nu))
        log_gg = torch.lgamma(nu) + torch.lgamma(1.0 + nu)
        g = (math.pi / torch.sin(math.pi * nu)) * torch.exp(-log_gg)
        # (u/4)^nu with a NaN-safe log; it and its u-tangents (nu > 1)
        # vanish as u -> 0, so it is masked below _U_TINY
        q_safe = torch.clamp(q, min=0.25 * self._U_TINY)
        pow_term = g * torch.exp(nu * torch.log(q_safe)) * B
        return A - torch.where(u > self._U_TINY, pow_term, 0.0)

    def _scalar(self, x1, x2, theta):
        from gptools_tpu_torch.ops.special import bessel_kve

        sigma_f, nu = theta[..., 0], theta[..., 1]
        z = (x1 - x2) / theta[..., 2 : 2 + self.num_dim]
        u = 2.0 * nu * torch.sum(z * z, -1)
        far = u > self._U_SWITCH
        s = torch.sqrt(torch.where(far, u, self._U_SWITCH))
        # 2^(1-nu)/Gamma(nu) s^nu K_nu(s), the prefactor in log space
        log_pref = (1.0 - nu) * math.log(2.0) - torch.lgamma(nu) + nu * torch.log(s) - s
        shape_exact = torch.exp(log_pref) * bessel_kve(
            nu, s, num_nodes=self._NUM_NODES, max_order=self.nu_max_order()
        )
        shape = torch.where(far, shape_exact, self._shape_series(u, nu))
        return sigma_f * sigma_f * shape


# the reference's name for the free-nu Matern
MaternKernelArb = MaternGeneralKernel


class RationalQuadraticKernel(Kernel):
    """ARD rational quadratic ``sigma_f^2 (1 + r^2 / (2 alpha))^(-alpha)``;
    parameters ``(sigma_f, alpha, l_1, ..., l_D)``."""

    def __init__(self, num_dim: int = 1, **kw):
        names = ("sigma_f", "alpha") + tuple(f"l_{d+1}" for d in range(num_dim))
        kw.setdefault("default_bounds", [(1e-4, 1e4)] * (num_dim + 2))
        super().__init__(num_dim, names, **kw)

    def _scalar(self, x1, x2, theta):
        sigma_f, alpha = theta[..., 0], theta[..., 1]
        z = (x1 - x2) / theta[..., 2 : 2 + self.num_dim]
        r2 = torch.sum(z * z, -1)
        return sigma_f * sigma_f * torch.exp(-alpha * torch.log1p(r2 / (2.0 * alpha)))


class LengthScaleWarp:
    """Length-scale profile ``l(x) > 0`` for the Gibbs kernel."""

    param_names: Tuple[str, ...]
    default_bounds: Tuple[tuple, ...]

    @property
    def num_params(self):
        return len(self.param_names)

    def __call__(self, x, theta):
        """x: input coordinates; theta: (..., num_params) -> l(x)."""
        raise NotImplementedError(f"{type(self).__name__} defines no __call__")


class TanhWarp(LengthScaleWarp):
    """``l(x) = l1 + (l2 - l1)/2 * (1 + tanh((x - x0) / lw))``; parameters
    ``(l1, l2, lw, x0)``. The fused builders and the CUDA kernels carry the
    same formula with its slope."""

    param_names = ("l1", "l2", "lw", "x0")
    default_bounds = ((1e-4, 1e4), (1e-4, 1e4), (1e-4, 1e4), (-1e4, 1e4))

    def __call__(self, x, theta):
        l1, l2, lw, x0 = theta[..., 0], theta[..., 1], theta[..., 2], theta[..., 3]
        return l1 + 0.5 * (l2 - l1) * (1.0 + torch.tanh((x - x0) / lw))


class GaussWarp(LengthScaleWarp):
    """``l(x) = l1 - (l1 - l2) exp(-(x - x0)^2 / (2 lw^2))``: baseline l1
    with a localized excursion to l2 at x0; parameters ``(l1, l2, lw,
    x0)``."""

    param_names = ("l1", "l2", "lw", "x0")
    default_bounds = ((1e-4, 1e4), (1e-4, 1e4), (1e-4, 1e4), (-1e4, 1e4))

    def __call__(self, x, theta):
        l1, l2, lw, x0 = theta[..., 0], theta[..., 1], theta[..., 2], theta[..., 3]
        z = (x - x0) / lw
        return l1 - (l1 - l2) * torch.exp(-0.5 * z * z)


class ExpWarp(LengthScaleWarp):
    """``l(x) = l0 exp(x / s)``; parameters ``(l0, s)``."""

    param_names = ("l0", "s")
    default_bounds = ((1e-4, 1e4), (1e-4, 1e4))

    def __call__(self, x, theta):
        return theta[..., 0] * torch.exp(x / theta[..., 1])


class InterpolatedWarp(LengthScaleWarp):
    """Cubic-Hermite (Catmull-Rom, one-sided at the ends) interpolation of
    length-scale values at fixed, strictly increasing knots, held constant
    outside them; the knot values are the parameters ``l_knot_i``. The
    interval and the knot values around it are gathered per entry, so a
    batch of thetas (..., K) broadcasts against the points."""

    def __init__(self, knots: Sequence[float]):
        self.knots = tuple(float(v) for v in knots)
        if len(self.knots) < 2:
            raise ValueError("need >= 2 knots")
        if any(b <= a for a, b in zip(self.knots, self.knots[1:])):
            raise ValueError("knots must be strictly increasing")
        self.param_names = tuple(f"l_knot_{i}" for i in range(len(self.knots)))
        self.default_bounds = ((1e-4, 1e4),) * len(self.knots)
        self._xs = {}

    def _knots_on(self, like):
        """The knots on ``like``'s dtype and device, made once, outside any
        jvp tower (whose level a cached tensor must not belong to)."""
        key = (like.dtype, like.device)
        if key not in self._xs:
            with torch._C._DisableFuncTorch():
                self._xs[key] = torch.tensor(self.knots, dtype=like.dtype,
                                             device=like.device)
        return self._xs[key]

    def __call__(self, x, theta):
        xs = self._knots_on(x)
        n = len(self.knots)
        # max / min split the derivative at a tie, as the reference's clip
        xq = torch.minimum(torch.maximum(x, xs[0]), xs[-1])
        # searchsorted(side="right") - 1 as a count, which a jvp tower keeps
        i = torch.clamp((xs <= xq[..., None]).sum(-1) - 1, 0, n - 2)
        shape = torch.broadcast_shapes(i.shape, theta.shape[:-1])
        th = theta.expand(shape + (n,))

        def at(j):
            return torch.take_along_dim(th, j.expand(shape)[..., None], -1)[..., 0]

        im1 = torch.clamp(i - 1, min=0)
        ip2 = torch.clamp(i + 2, max=n - 1)
        x0, x1 = xs[i], xs[i + 1]
        h = x1 - x0
        t = (xq - x0) / h
        y0, y1 = at(i), at(i + 1)
        m0 = (y1 - at(im1)) / (xs[i + 1] - xs[im1])
        m1 = (at(ip2) - y0) / (xs[ip2] - xs[i])
        t2 = t * t
        t3 = t2 * t
        h00 = 2 * t3 - 3 * t2 + 1
        h10 = t3 - 2 * t2 + t
        h01 = -2 * t3 + 3 * t2
        h11 = t3 - t2
        return h00 * y0 + h10 * h * m0 + h01 * y1 + h11 * h * m1


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


class GibbsKernel1dGauss(GibbsKernel):
    """Gibbs kernel with the `GaussWarp`; parameters ``(sigma_f, l1, l2,
    lw, x0)``."""

    def __init__(self, **kw):
        super().__init__(GaussWarp(), **kw)


class GibbsKernel1dExp(GibbsKernel):
    """Gibbs kernel with the `ExpWarp`; parameters ``(sigma_f, l0, s)``."""

    def __init__(self, **kw):
        super().__init__(ExpWarp(), **kw)


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
        raise NotImplementedError(f"input warp {type(self).__name__} defines no __call__")


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


class ArbitraryWarp(InputWarp):
    """An input warp given as a torch callable ``w(x, theta)``: x (...)
    against the warp's parameters (..., num_params) -> (...)."""

    def __init__(self, fn: Callable, param_names=(), default_bounds=()):
        self.fn = fn
        self.param_names = tuple(param_names)
        self.default_bounds = tuple(default_bounds)

    def __call__(self, x, theta):
        return self.fn(x, theta)


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

    @property
    def entry_cost(self):
        return self.base.entry_cost

    def _scalar(self, x1, x2, theta):
        pb = self.base.num_params
        tb, tw = theta[..., :pb], theta[..., pb:]
        w1 = torch.stack([self.input_warp(x1[..., d], tw) for d in range(self.num_dim)], -1)
        w2 = torch.stack([self.input_warp(x2[..., d], tw) for d in range(self.num_dim)], -1)
        return self.base.smooth_scalar(w1, w2, tb)
