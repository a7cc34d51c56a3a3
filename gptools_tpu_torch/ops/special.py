"""Regularized incomplete beta, differentiable in every argument.

Counterpart of `gptools_tpu.ops.special.betainc_dd` and `_tanh_sinh_nodes`:
the BetaWarp input warp needs I_x(a, b) with gradients in a, b and x, which
`torch.special` does not provide. Fixed-node tanh-sinh quadrature in log
space, so autograd differentiates under the integral sign. The node table
is the reference's, computed in float64 numpy; the clips and the exact
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

__all__ = ["betainc_dd"]


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


@lru_cache(maxsize=16)
def _nodes_on(num_nodes: int, L: float, dtype: torch.dtype, device: torch.device):
    """`_tanh_sinh_nodes` as tensors of ``dtype`` on ``device``, made once
    (each upload would be a host-to-device copy that waits for the card)."""
    return tuple(torch.as_tensor(v, dtype=dtype, device=device)
                 for v in _tanh_sinh_nodes(num_nodes, L))


def betainc_dd(a, b, x, *, num_nodes: int = 144, L: float = 5.2):
    """``I_x(a, b)`` with ``B(x; a, b) = x^a int_0^1 s^(a-1) (1 - x s)^(b-1)
    ds`` by tanh-sinh quadrature, over ``B(a, b)`` from `torch.lgamma`.
    Broadcasts over a, b and x (tensors of one dtype and device)."""
    dtype = torch.promote_types(torch.result_type(a, b), x.dtype)
    dev = x.device
    log_s, log_1ms, log_w = _nodes_on(num_nodes, L, dtype, dev)
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
