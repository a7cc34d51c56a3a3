"""Covariance-matrix assembly from scalar kernels and derivative orders.

Counterpart of `gptools_tpu.ops.assemble`: each derivative block
``d^a d^b k`` comes from the jvp tower of `ops.derivs`, evaluated over the
whole (N1, N2) grid and mask-combined by the order ids. The reference
``vmap``s the scalar over points and hyperparameters; here the scalar
broadcasts instead: points enter as (N1, 1, D) and (1, N2, D), and a theta
batch (B, P) as (B, 1, 1, P), so a batch of B thetas gives (B, N1, N2) in
one evaluation. Where every order is 0 or the first derivative along one
dimension (value and slope observations), all four blocks come from one
nested tower (`derivs.first_order_blocks`). The mean half, `mean_vector`,
is the reference's layout, theta-major, of the chains-minor
`gptools_tpu_torch.models.mean.mean_vector`, which it calls.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from gptools_tpu_torch.models import mean as _mean
from gptools_tpu_torch.models.dataset import MultiIndex
from gptools_tpu_torch.ops import derivs, fused

__all__ = ["cov_matrix", "delta_matrix", "mean_vector", "all_pairs"]


def all_pairs(num_a: int, num_b: int) -> Tuple[Tuple[int, int], ...]:
    return tuple((i, j) for i in range(num_a) for j in range(num_b))


def _first_order_dim(multi_indices) -> Optional[int]:
    """The dimension d when the table holds the value order and e_d and
    nothing else, else None."""
    if len(multi_indices) != 2:
        return None
    zero, first = sorted(multi_indices, key=sum)
    if sum(zero) != 0 or sum(first) != 1:
        return None
    return first.index(1)


def _theta_grid(theta: torch.Tensor) -> torch.Tensor:
    """theta (P,) as is; (B, P) as (B, 1, 1, P), to broadcast over a grid."""
    return theta if theta.ndim == 1 else theta[:, None, None, :]


def cov_matrix(
    kernel,
    theta: torch.Tensor,
    X1: torch.Tensor,
    nid1: torch.Tensor,
    X2: torch.Tensor,
    nid2: torch.Tensor,
    multi_indices: Sequence[MultiIndex],
    pairs: Optional[Sequence[Tuple[int, int]]] = None,
    include_delta: bool = True,
) -> torch.Tensor:
    """Dense covariance between observation sets with derivative orders:
    theta (P,) or (B, P), X1 (N1, D), nid1 (N1,) ids into
    ``multi_indices``, likewise X2, nid2 -> (N1, N2) or (B, N1, N2).
    ``pairs``: the (aid, bid) combinations to evaluate (default: all);
    ``include_delta``: add the white-noise terms on matching (x, order).
    Differentiable in theta."""
    multi_indices = tuple(tuple(m) for m in multi_indices)
    if pairs is None:
        pairs = all_pairs(len(multi_indices), len(multi_indices))
    dtype = torch.promote_types(X1.dtype, theta.dtype)
    shape = theta.shape[:-1] + (X1.shape[0], X2.shape[0])
    x1, x2, th = X1[:, None, :], X2[None, :, :], _theta_grid(theta)
    K = torch.zeros(shape, dtype=dtype, device=theta.device)
    if kernel.has_smooth:
        if len(multi_indices) == 1:
            (a,) = multi_indices
            K = kernel.block_fn(a, a)(x1, x2, th).to(dtype).expand(shape)
        elif (d := _first_order_dim(multi_indices)) is not None:
            vals = derivs.first_order_blocks(kernel.smooth_scalar, d)(x1, x2, th)
            order = [sum(m) for m in multi_indices]  # 0 or 1 per table id
            for aid, bid in pairs:
                block = vals[order[aid] + 2 * order[bid]].to(dtype)
                mask = (nid1[:, None] == aid) & (nid2[None, :] == bid)
                K = K + torch.where(mask, block, 0.0)
        else:
            for aid, bid in pairs:
                fn = kernel.block_fn(multi_indices[aid], multi_indices[bid])
                block = fn(x1, x2, th).to(dtype)
                mask = (nid1[:, None] == aid) & (nid2[None, :] == bid)
                K = K + torch.where(mask, block, 0.0)
    if include_delta:
        K = K + delta_matrix(kernel, theta, X1, nid1, X2, nid2, multi_indices, dtype)
    return K


def delta_matrix(
    kernel,
    theta: torch.Tensor,
    X1: torch.Tensor,
    nid1: torch.Tensor,
    X2: torch.Tensor,
    nid2: torch.Tensor,
    multi_indices: Sequence[MultiIndex],
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """White-noise contributions: ``sigma_n^2`` where the inputs and the
    derivative orders match exactly (repeated x locations couple, as in
    the reference), restricted to the kernel's ``n_match`` order."""
    multi_indices = tuple(tuple(m) for m in multi_indices)
    if dtype is None:
        dtype = torch.promote_types(X1.dtype, theta.dtype)
    out = torch.zeros(theta.shape[:-1] + (X1.shape[0], X2.shape[0]), dtype=dtype,
                      device=theta.device)
    terms = kernel.delta_terms()
    if not terms:
        return out
    same_x = torch.all(X1[:, None, :] == X2[None, :, :], dim=-1)
    base_mask = same_x & (nid1[:, None] == nid2[None, :])
    for off, dk in terms:
        val = dk.delta_value(theta[..., off : off + dk.num_params]).to(dtype)
        if dk.n_match is not None:
            if dk.n_match not in multi_indices:
                continue  # no observation of the matching order exists
            mask = base_mask & (nid1[:, None] == multi_indices.index(dk.n_match))
        else:
            mask = base_mask
        out = out + torch.where(mask, _to_entries(val, out.shape[-2:]), 0.0)
    return out


def _to_entries(val: torch.Tensor, shape) -> torch.Tensor:
    """Per-theta values (...) broadcast to (..., N1, N2). Under autograd a
    batch's values are expanded by `fused._ExpandRow`, so that each theta's
    cotangent is summed over the entries in one order whatever the batch's
    size."""
    if val.ndim == 0 or not val.requires_grad:
        return val[..., None, None]
    n = shape[0] * shape[1]
    rows = fused._ExpandRow.apply(val.reshape(-1), n)  # (N1 N2, B)
    return rows.T.reshape(val.shape + tuple(shape))


def mean_vector(
    mean_fn,
    theta: torch.Tensor,
    X: torch.Tensor,
    nid: torch.Tensor,
    multi_indices: Sequence[MultiIndex],
) -> torch.Tensor:
    """A mean function at each observation's derivative order: theta (P,)
    -> (N,), or a batch (B, P) -> (B, N); X (N, D), nid (N,) ids into
    ``multi_indices``."""
    thetaT = theta.reshape(-1, theta.shape[-1]).T
    out = _mean.mean_vector(mean_fn, thetaT, X, nid, multi_indices).T
    return out.reshape(*theta.shape[:-1], X.shape[0])
