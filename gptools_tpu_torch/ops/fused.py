"""Fused Gibbs-tanh covariance build, chains-minor (plain PyTorch).

Counterpart of the Gibbs-tanh half of `gptools_tpu.ops.fused`. This is the
covariance half of the evidence kernel's plain version: differentiable by
autograd, and the CPU path of the port. The SE and Matern-5/2 builders and
the input-warped ones are ROADMAP Queue 1 item 9.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "gibbs_tanh_cov_fused_soa_sym",
    "classify_flagship",
    "fused_supported",
]


def _gibbs_pair(sf, la, dla, lb, dlb, d, sel: int):
    """Gibbs-tanh covariance entries of one derivative block on broadcast-
    compatible operands (the per-pair function of the reference's evidence
    kernel): sel 0 = value-value, 1 = value-slope (column derivative),
    2 = slope-value (row derivative), 3 = slope-slope. Only the selected
    block's math is evaluated."""
    u = la * la
    v = lb * lb
    inv_S = 1.0 / (u + v)
    d2 = d * d
    k = (sf * sf) * torch.sqrt(2.0 * la * lb * inv_S) * torch.exp(-d2 * inv_S)
    if sel == 0:
        return k
    up = 2.0 * la * dla
    vp = 2.0 * lb * dlb
    inv_S2 = inv_S * inv_S
    common = -0.5 * inv_S + d2 * inv_S2
    if sel == 2:
        return (up * (0.25 / u + common) - 2.0 * d * inv_S) * k
    if sel == 1:
        return (vp * (0.25 / v + common) + 2.0 * d * inv_S) * k
    g1 = up * (0.25 / u + common) - 2.0 * d * inv_S
    g2 = vp * (0.25 / v + common) + 2.0 * d * inv_S
    dg2dx = (
        vp * (0.5 * up * inv_S2 + 2.0 * d * inv_S2 - 2.0 * d2 * up * inv_S2 * inv_S)
        + 2.0 * inv_S
        - 2.0 * d * up * inv_S2
    )
    return (g1 * g2 + dg2dx) * k


@functools.lru_cache(maxsize=64)
def _triu_index_maps(n: int):
    """Upper-triangle (row, col) index vectors of length n(n+1)/2 and the
    (n, n) pair-id matrix that mirrors packed pair values into a matrix."""
    rows, cols = np.triu_indices(n)
    pid = np.zeros((n, n), np.int64)
    pid[rows, cols] = np.arange(rows.shape[0], dtype=np.int64)
    pid[cols, rows] = pid[rows, cols]
    return rows, cols, pid


@functools.lru_cache(maxsize=64)
def _pair_groups(nid: tuple):
    """Upper-triangle pairs grouped by derivative block: [(sel, pair
    indices)], and the permutation that puts the grouped values back in
    pair order."""
    rows, cols, _ = _triu_index_maps(len(nid))
    ids = np.asarray(nid)
    sel = 2 * ids[rows] + ids[cols]
    groups = [(s, np.nonzero(sel == s)[0]) for s in range(4) if (sel == s).any()]
    order = np.concatenate([g for _, g in groups])
    return groups, np.argsort(order)


def gibbs_tanh_cov_fused_soa_sym(X, nid, thetaT):
    """Symmetric chains-minor Gibbs-tanh covariance: X (N,), nid (N,) in
    {0, 1}, thetaT (5, C) -> K (N, N, C).

    Only the N(N+1)/2 upper-triangle pairs are computed, the warp once per
    point. The reference evaluates all four {value, slope} blocks at every
    pair and selects with `assemble_blocks`; here the pairs are grouped by
    block and each group evaluates only its own formula (the same values,
    with a quarter of the work at config 4, where 325 of 378 pairs are
    value-value)."""
    rows, cols, pid = _triu_index_maps(X.shape[0])
    groups, inv = _pair_groups(tuple(int(v) for v in nid.tolist()))
    dev = thetaT.device
    sf, l1, l2, lw, x0 = thetaT[0], thetaT[1], thetaT[2], thetaT[3], thetaT[4]
    t = torch.tanh((X[:, None] - x0) / lw)  # (N, C)
    l = l1 + 0.5 * (l2 - l1) * (1.0 + t)
    dl = 0.5 * (l2 - l1) * (1.0 - t * t) / lw
    parts = []
    for sel, idx in groups:
        r = torch.as_tensor(rows[idx], device=dev)
        c = torch.as_tensor(cols[idx], device=dev)
        d = (X[r] - X[c])[:, None]  # (pairs, 1): chain-free
        parts.append(_gibbs_pair(sf, l[r], dl[r], l[c], dl[c], d, sel))
    vals = torch.cat(parts)[torch.as_tensor(inv, device=dev)]  # (Np, C)
    return vals[torch.as_tensor(pid, device=dev)]


def classify_flagship(kernel):
    """``("gibbs_tanh", num_params, None)`` for the Gibbs-tanh kernel, else
    None: the SE / Matern / input-warped kinds are ROADMAP Queue 1 item 9."""
    from gptools_tpu_torch.ops.kernels import GibbsKernel, TanhWarp

    if isinstance(kernel, GibbsKernel) and type(kernel.warp) is TanhWarp:
        return "gibbs_tanh", kernel.num_params, None
    return None


def fused_supported(kernel, multi_indices, num_dim) -> bool:
    if num_dim != 1:
        return False
    if not set(tuple(m) for m in multi_indices) <= {(0,), (1,)}:
        return False
    return classify_flagship(kernel) is not None


def _order_ids(nid, multi_indices):
    mi = tuple(tuple(m) for m in multi_indices)
    if mi == ((0,),) or mi == ((0,), (1,)):
        return nid
    if mi == ((1,),):
        return nid + 1
    raise ValueError(f"unsupported multi-index table {mi}")
