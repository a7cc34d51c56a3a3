"""Fused covariance builds, chains-minor (plain PyTorch).

Counterpart of the chains-minor half of `gptools_tpu.ops.fused`: the
Gibbs-tanh, SE and Matern-5/2 {value, slope} blocks, the BetaWarp /
LinearWarp input-warped builds, the classifier and `flagship_cov_soa`.
These are the covariance half of the evidence kernel's plain version:
differentiable by autograd, and the CPU path of the port. The per-chain
(single-theta) builders and the full-matrix ``*_soa`` twins serve only the
single-theta surface and the reference's A/B switch (ROADMAP Queue 1
item 12); the Pallas tile builder is Queue 2 item 4.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from gptools_tpu_torch.ops.special import betainc_dd

__all__ = [
    "se_blocks_d",
    "matern52_blocks_d",
    "assemble_blocks",
    "se_cov_fused_soa_sym",
    "gibbs_tanh_cov_fused_soa_sym",
    "matern52_cov_fused_soa_sym",
    "beta_warp_pdf",
    "warp_coords",
    "coords_cov_soa_sym",
    "warped_cov_fused_soa_sym",
    "classify_flagship",
    "flagship_cov_soa",
]

_SQRT5 = math.sqrt(5.0)


def se_blocks_d(d, theta):
    """SE {value, slope} blocks (k00, k10, k01, k11) from a separation
    ``d = x_row - x_col`` (static or warped); theta rows [sigma_f, l]."""
    sf, ell = theta[0], theta[1]
    inv_l2 = 1.0 / (ell * ell)
    r2 = d * d * inv_l2
    e = sf * sf * torch.exp(-0.5 * r2)
    k10 = -d * inv_l2 * e
    return e, k10, -k10, (1.0 - r2) * inv_l2 * e


def matern52_blocks_d(d, theta):
    """Matern-5/2 blocks: k = sf^2 (1 + s + s^2/3) e^{-s}, s = sqrt(5)|d|/l,
    with the closed slope forms (finite at d = 0)."""
    sf, ell = theta[0], theta[1]
    s = _SQRT5 * torch.abs(d) / ell
    e = sf * sf * torch.exp(-s)
    k00 = (1.0 + s + s * s / 3.0) * e
    g = (5.0 / 3.0) * (d / (ell * ell)) * (1.0 + s) * e
    k11 = (5.0 / (3.0 * ell * ell)) * (1.0 + s - s * s) * e
    return k00, -g, g, k11


_BASE_BLOCKS_D = {"se": se_blocks_d, "matern52": matern52_blocks_d}


def assemble_blocks(blocks, nid_row, nid_col):
    """Select each entry's block by derivative-order ids (0 = value,
    1 = slope; any other id gives zero)."""
    k00, k10, k01, k11 = blocks
    rv, cv = nid_row == 0, nid_col == 0
    rd, cd = nid_row == 1, nid_col == 1
    return torch.where(
        rv & cv, k00,
        torch.where(rd & cv, k10, torch.where(rv & cd, k01, torch.where(rd & cd, k11, 0.0))),
    )


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


def _pairs_sym(X, nid, thetaT, blocks_d):
    """Upper-triangle pairs of a stationary kernel at static separations,
    mirrored to (N, N, C)."""
    rows, cols, pid = _triu_index_maps(X.shape[0])
    dev = thetaT.device
    r = torch.as_tensor(rows, device=dev)
    c = torch.as_tensor(cols, device=dev)
    d = (X[r] - X[c])[:, None]
    vals = assemble_blocks(blocks_d(d, thetaT), nid[r][:, None], nid[c][:, None])
    return vals[torch.as_tensor(pid, device=dev)]


def se_cov_fused_soa_sym(X, nid, thetaT):
    """Symmetric chains-minor SE covariance: X (N,), nid (N,), thetaT
    (2, C) -> K (N, N, C); the N(N+1)/2 upper pairs, mirrored."""
    return _pairs_sym(X, nid, thetaT, se_blocks_d)


def matern52_cov_fused_soa_sym(X, nid, thetaT):
    """Symmetric chains-minor Matern-5/2 covariance (see
    `se_cov_fused_soa_sym`)."""
    return _pairs_sym(X, nid, thetaT, matern52_blocks_d)


def beta_warp_pdf(a, b, x):
    """Beta(a, b) density: the BetaWarp slope w'(x). Broadcasts like
    `special.betainc_dd`."""
    xc = torch.clamp(x, 1e-12, 1.0 - 1e-12)
    log_beta = torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)
    return torch.exp((a - 1.0) * torch.log(xc) + (b - 1.0) * torch.log1p(-xc) - log_beta)


def warp_coords(input_warp, X, theta_w, need_slope: bool):
    """Warped coordinates w(x) (N, C) of points X (N,) for the warp's
    parameter rows ``theta_w`` (each (C,)), and the slope w'(x) (N, C) when
    derivative observations exist (else None). The reference's
    ``chains_minor=True`` form, with w broadcast to (N, C) for the
    parameter-free LinearWarp too."""
    from gptools_tpu_torch.ops.kernels import BetaWarp, LinearWarp

    Xcol = X[:, None]
    if type(input_warp) is LinearWarp:
        C = theta_w.shape[-1]
        scale = 1.0 / (input_warp.b - input_warp.a)
        w = ((Xcol - input_warp.a) * scale).expand(X.shape[0], C)
        return w, (torch.full_like(w, scale) if need_slope else None)
    if type(input_warp) is BetaWarp:
        a, b = theta_w[0], theta_w[1]
        w = betainc_dd(a, b, Xcol)
        return w, (beta_warp_pdf(a, b, Xcol) if need_slope else None)
    raise ValueError(type(input_warp).__name__)


def coords_cov_soa_sym(base_kind, w, wp, ids, thetaT):
    """A stationary base kernel on per-point coordinates w (N, C): pairs at
    d = w_i - w_j, slope blocks scaled by the warp slopes wp (N, C) (chain
    rule; None when there are no slope rows) -> (N, N, C)."""
    rows, cols, pid = _triu_index_maps(w.shape[0])
    dev = thetaT.device
    r = torch.as_tensor(rows, device=dev)
    c = torch.as_tensor(cols, device=dev)
    k00, k10, k01, k11 = _BASE_BLOCKS_D[base_kind](w[r] - w[c], thetaT)
    if wp is not None:
        k10 = k10 * wp[r]
        k01 = k01 * wp[c]
        k11 = k11 * (wp[r] * wp[c])
    vals = assemble_blocks((k00, k10, k01, k11), ids[r][:, None], ids[c][:, None])
    return vals[torch.as_tensor(pid, device=dev)]


def warped_cov_fused_soa_sym(base_kind, input_warp, X, ids, thetaT):
    """Symmetric chains-minor input-warped covariance: thetaT rows
    [base params | warp params] (P, C) -> (N, N, C); the warp is evaluated
    once per point and gathered per pair."""
    pb = {"se": 2, "matern52": 2}[base_kind]
    need_slope = bool((ids == 1).any())
    w, wp = warp_coords(input_warp, X, thetaT[pb:], need_slope)
    return coords_cov_soa_sym(base_kind, w, wp, ids, thetaT[:pb])


def classify_flagship(kernel):
    """``(kind, base_params, input_warp)`` for a kernel with a fused build
    and a CUDA kind, else None: kind in {'se', 'gibbs_tanh', 'matern52'},
    ``base_params`` the number of base-kernel rows, ``input_warp`` the
    BetaWarp / LinearWarp of a `WarpedKernel` (None when unwarped). Gibbs
    cannot be input-warped."""
    from gptools_tpu_torch.ops.kernels import (
        BetaWarp,
        GibbsKernel,
        LinearWarp,
        MaternKernel,
        SquaredExponentialKernel,
        TanhWarp,
        WarpedKernel,
    )

    def base_kind(k):
        if type(k) is SquaredExponentialKernel and k.num_dim == 1:
            return "se"
        if isinstance(k, MaternKernel) and k.p == 2 and k.num_dim == 1:
            return "matern52"
        return None

    if isinstance(kernel, WarpedKernel):
        if type(kernel.input_warp) not in (BetaWarp, LinearWarp):
            return None
        kind = base_kind(kernel.base)
        if kind is None:
            return None
        return kind, kernel.base.num_params, kernel.input_warp
    if isinstance(kernel, GibbsKernel) and type(kernel.warp) is TanhWarp:
        return "gibbs_tanh", kernel.num_params, None
    kind = base_kind(kernel)
    if kind is None:
        return None
    return kind, kernel.num_params, None


def flagship_cov_soa(kernel, thetaT, X, nid, multi_indices):
    """Chains-minor fused K: thetaT (P, C) -> (N, N, C) for a classified
    kernel on 1-D points X (N, 1) or (N,)."""
    cls = classify_flagship(kernel)
    if cls is None:
        raise ValueError(type(kernel).__name__)
    kind, _, input_warp = cls
    ids = _order_ids(nid, multi_indices)
    Xf = X.reshape(-1)
    if input_warp is not None:
        return warped_cov_fused_soa_sym(kind, input_warp, Xf, ids, thetaT)
    builds = {
        "se": se_cov_fused_soa_sym,
        "gibbs_tanh": gibbs_tanh_cov_fused_soa_sym,
        "matern52": matern52_cov_fused_soa_sym,
    }
    return builds[kind](Xf, ids, thetaT)


def _order_ids(nid, multi_indices):
    mi = tuple(tuple(m) for m in multi_indices)
    if mi == ((0,),) or mi == ((0,), (1,)):
        return nid
    if mi == ((1,),):
        return nid + 1
    raise ValueError(f"unsupported multi-index table {mi}")
