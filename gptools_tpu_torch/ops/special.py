"""Special functions differentiable in every argument.

Counterpart of `gptools_tpu.ops.special`: the regularized incomplete beta
`betainc_dd` (the BetaWarp input warp needs I_x(a, b) with gradients in a,
b and x) and the scaled modified Bessel function of the second kind
`bessel_kve` / `log_bessel_k` (the free-nu Matern kernel needs K_nu(x)
with gradients in nu and x), neither of which `torch.special` provides.
Both are fixed-node double-exponential quadratures in log space, so
autograd and `torch.func.jvp` differentiate under the integral sign. The
node tables are the reference's, computed in float64 numpy, and kept on
the data's device once per (dtype, device); the clips and the exact
endpoints are the reference's too, so the gradients match JAX's.

Memory: the quadrature broadcasts to ``a.shape ... x.shape + (num_nodes,)``.
For the chains-minor warp, (N, 1) points against (C,) parameters, that is
an (N, C, 144) intermediate (35 x 4096 x 144 float64 = 165 MB at config 3),
kept alive for the backward pass.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

__all__ = ["betainc_dd", "bessel_kve", "log_bessel_k"]


@lru_cache(maxsize=None)
def _tanh_sinh_nodes(n: int, L: float):
    """tanh-sinh nodes for integrals over (0, 1), in log space:
    t_k = sigmoid(pi sinh u_k), u_k uniform on (-L, L). Returns float64
    numpy ``(log_t, log_1mt, log_w)``; positions and complements stay logs
    so the endpoint-singular integrands never see an exact 0."""
    u = np.linspace(-L, L, n)
    du = u[1] - u[0]
    s = np.sinh(u) * math.pi
    log_t = -np.log1p(np.exp(-s))
    log_1mt = -np.log1p(np.exp(s))
    log_w = np.log(du * math.pi * np.cosh(u)) + log_t + log_1mt
    return log_t, log_1mt, log_w


@lru_cache(maxsize=None)
def _exp_sinh_nodes(n: int, L: float):
    """exp-sinh nodes for integrals over (0, inf) of decaying integrands:
    t_k = exp(pi/2 sinh u_k), u uniform on (-L, L). Returns float64 numpy
    ``(t, coshm1, log_w)``, ``coshm1 = cosh(t) - 1`` accurate for small t
    and clipped to 1e30 at the far nodes (so ``-x * coshm1`` stays finite:
    an inf there would make inf * 0 = NaN gradients through logsumexp)."""
    u = np.linspace(-L, L, n)
    du = u[1] - u[0]
    t = np.exp((math.pi / 2.0) * np.sinh(u))
    with np.errstate(over="ignore"):
        coshm1 = 0.5 * (np.expm1(np.minimum(t, 700.0)) + np.expm1(-t))
    coshm1 = np.minimum(coshm1, 1e30)
    log_w = np.log(du * (math.pi / 2.0) * np.cosh(u)) + np.log(t)
    return t, coshm1, log_w


def _kve_nodes(n: int, L: float, dtype: torch.dtype):
    """`_exp_sinh_nodes` as `_kve_quad` takes them: ``coshm1`` clipped at
    the dtype's range as in the reference, and ``log_w - log 2`` (the
    constant of log cosh)."""
    t, coshm1, log_w = _exp_sinh_nodes(n, L)
    return t, np.minimum(coshm1, torch.finfo(dtype).max * 1e-8), log_w - math.log(2.0)


@lru_cache(maxsize=32)
def _nodes_on(table: str, num_nodes: int, L: float, dtype: torch.dtype,
              device: torch.device):
    """A node table as tensors of ``dtype`` on ``device``, made once (each
    upload would be a host-to-device copy that waits for the card). Made
    outside any `torch.func` transform: a tensor created inside a jvp
    tower belongs to that tower's level and must not outlive it."""
    if table == "tanh_sinh":
        values = _tanh_sinh_nodes(num_nodes, L)
    else:
        values = _kve_nodes(num_nodes, L, dtype)
    with torch._C._DisableFuncTorch():
        return tuple(torch.as_tensor(v, dtype=dtype, device=device) for v in values)


def betainc_dd(a, b, x, *, num_nodes: int = 144, L: float = 5.2):
    """``I_x(a, b)`` with ``B(x; a, b) = x^a int_0^1 s^(a-1) (1 - x s)^(b-1)
    ds`` by tanh-sinh quadrature, over ``B(a, b)`` from `torch.lgamma`.
    Broadcasts over a, b and x (tensors of one dtype and device)."""
    dtype = torch.promote_types(torch.result_type(a, b), x.dtype)
    dev = x.device
    log_s, log_1ms, log_w = _nodes_on("tanh_sinh", num_nodes, L, dtype, dev)
    xc = torch.clamp(x, 1e-12, 1.0 - 1e-12)
    a_ = a[..., None]
    b_ = b[..., None]
    x_ = xc[..., None]
    # 1 - x s = (1 - x) + x (1 - s), from the stable complement
    log_1mxs = torch.log((1.0 - x_) + x_ * torch.exp(log_1ms))
    log_f = (a_ - 1.0) * log_s + (b_ - 1.0) * log_1mxs
    log_binc = torch.logsumexp(log_f + a_ * torch.log(x_) + log_w, dim=-1)
    log_beta = torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)
    out = torch.clamp(torch.exp(log_binc - log_beta), 0.0, 1.0)
    # exact endpoints (also zero the tangents there)
    zero = torch.zeros((), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    return torch.where(x <= 0.0, zero, torch.where(x >= 1.0, one, out))


# the reference's static bound on the order: 0 <= v < 64, so the upward
# recurrence takes at most 63 steps
_KVE_MAX_ORDER = 64


def _kve_quad(v, x, num_nodes: int, L: float):
    """exp-sinh quadrature of ``kve = int_0^inf exp(-x (cosh t - 1))
    cosh(v t) dt`` over a trailing node axis; ``v`` (..., K) is a stack of
    orders, each broadcast against ``x`` (...) -> (..., K). Accurate for
    |v| <= 2 (the integrand's peak stays in the resolved region)."""
    t, coshm1, log_w_half = _nodes_on("exp_sinh", num_nodes, L, x.dtype, x.device)
    # log cosh(a) = a + log1p(exp(-2a)) - log 2 with a = v t >= 0 (v >= 0
    # here); the - log 2 is folded into the weights
    a = v[..., None] * t
    log_cosh = a + torch.log1p(torch.exp(-2.0 * a))
    log_f = -x[..., None, None] * coshm1
    return torch.exp(torch.logsumexp(log_f + log_cosh + log_w_half, -1))


def bessel_kve(v, x, *, num_nodes: int = 384, L: float = 3.8,
               max_order: int = _KVE_MAX_ORDER - 1):
    """``K_v(x) exp(x)`` for x > 0 and 0 <= |v| < 64, differentiable in v
    and x (also under `torch.func.jvp`).

    The quadrature `_kve_quad` at the fractional order ``mu = v -
    floor(v)`` and at mu + 1 (in one pass, stacked), then the stable upward
    recurrence ``K_{m+1} = K_{m-1} + (2m/x) K_m`` lifted ``floor(v)``
    times, each step masked by ``i < floor(v)`` as in the reference.
    ``max_order`` is a static bound on ``floor(|v|)`` that the caller
    knows from its metadata (a kernel's bounds and prior support): the
    loop runs ``max_order - 1`` steps, because steps at ``i >= floor(v)``
    leave the pair as it was, so the result equals that of all 63 masked
    steps (the reference's loop) bit for bit. No loop length is read from the data, which
    under a jvp tower is a dual tensor. Where ``floor(|v|)`` exceeds
    ``max_order`` the result is NaN. Gradients in v flow through mu (exact
    away from integer v)."""
    v = torch.abs(v)
    v, x = torch.broadcast_tensors(v, x)
    m = torch.floor(v)
    mu = v - m
    k = _kve_quad(torch.stack([mu, mu + 1.0], -1), x, num_nodes, L)
    k0, k1 = k[..., 0], k[..., 1]
    steps = min(int(max_order), _KVE_MAX_ORDER - 1)
    for i in range(1, steps):
        knext = k0 + (2.0 * (mu + i) / x) * k1
        take = i < m
        k0, k1 = torch.where(take, k1, k0), torch.where(take, knext, k1)
    out = torch.where(m == 0, k0, k1)
    if steps < _KVE_MAX_ORDER - 1:
        out = torch.where(m > steps, torch.full_like(out, math.nan), out)
    return out


def log_bessel_k(v, x, **kw):
    """``log K_v(x)`` from the scaled quadrature: ``log(kve) - x``."""
    return torch.log(bessel_kve(v, x, **kw)) - x
