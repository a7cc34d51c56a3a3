"""Fused covariance builds (plain PyTorch).

Counterpart of `gptools_tpu.ops.fused`, in two halves:

- chains-minor, thetaT (P, C) -> (N, N, C): the Gibbs-tanh, SE and
  Matern-5/2 {value, slope} blocks over the upper-triangle pairs (the
  ``*_soa_sym`` builders), the BetaWarp / LinearWarp input-warped builds
  and `flagship_cov_soa`. They are the covariance half of the evidence
  kernel's plain version and of the batch evidence's chains-minor route
  (`models.gp`). The reference's full-matrix ``*_soa`` builders, every
  entry computed, are here too: `flagship_cov_soa` takes them when
  ``symmetric`` is False.
- single theta, theta (P,) -> (N, N), or a leading batch (B, P) ->
  (B, N, N): `se_cov_fused`, `gibbs_tanh_cov_fused`, `matern52_cov_fused`,
  `warped_cov_fused` and `flagship_cov` with its ``backend`` switch. They
  serve `GPModel`'s single-theta surface, and the first two are the plain
  version of the covariance kernel (`ops.cov_cuda`).

Both are differentiable by autograd.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from gptools_tpu_torch.ops.special import betainc_dd

__all__ = [
    "se_blocks_d",
    "se_blocks",
    "matern52_blocks_d",
    "matern52_blocks",
    "gibbs_tanh_blocks",
    "assemble_blocks",
    "se_cov_fused",
    "gibbs_tanh_cov_fused",
    "matern52_cov_fused",
    "warped_cov_fused",
    "se_cov_fused_soa",
    "gibbs_tanh_cov_fused_soa",
    "matern52_cov_fused_soa",
    "se_cov_fused_soa_sym",
    "gibbs_tanh_cov_fused_soa_sym",
    "matern52_cov_fused_soa_sym",
    "beta_warp_pdf",
    "warp_coords",
    "coords_cov_soa_sym",
    "warped_cov_fused_soa_sym",
    "classify_flagship",
    "fused_supported",
    "flagship_cov",
    "flagship_cov_soa",
]

_SQRT5 = math.sqrt(5.0)


def _se_chain(theta):
    """The SE's per-chain factors (sigma_f^2, 1 / l^2) of theta rows
    [sigma_f, l]."""
    sf, ell = theta[0], theta[1]
    return sf * sf, 1.0 / (ell * ell)


def _se_pairs(d, sf2, inv_l2):
    r2 = d * d * inv_l2
    e = sf2 * torch.exp(-0.5 * r2)
    k10 = -d * inv_l2 * e
    return e, k10, -k10, (1.0 - r2) * inv_l2 * e


def se_blocks_d(d, theta):
    """SE {value, slope} blocks (k00, k10, k01, k11) from a separation
    ``d = x_row - x_col`` (static or warped); theta rows [sigma_f, l]."""
    return _se_pairs(d, *_se_chain(theta))


def _matern52_chain(theta):
    """The Matern-5/2's per-chain factors (sigma_f^2, l, l^2, 5 / (3 l^2))."""
    sf, ell = theta[0], theta[1]
    return sf * sf, ell, ell * ell, 5.0 / (3.0 * ell * ell)


def _matern52_pairs(d, sf2, ell, l2, c11):
    s = _SQRT5 * torch.abs(d) / ell
    e = sf2 * torch.exp(-s)
    k00 = (1.0 + s + s * s / 3.0) * e
    g = (5.0 / 3.0) * (d / l2) * (1.0 + s) * e
    k11 = c11 * (1.0 + s - s * s) * e
    return k00, -g, g, k11


def matern52_blocks_d(d, theta):
    """Matern-5/2 blocks: k = sf^2 (1 + s + s^2/3) e^{-s}, s = sqrt(5)|d|/l,
    with the closed slope forms (finite at d = 0)."""
    return _matern52_pairs(d, *_matern52_chain(theta))


# each base kind's (per-chain factors, pair function): the chains-minor
# builders expand the factors to the pairs (`_ExpandRow`) in between
_BASE_PAIRS = {"se": (_se_chain, _se_pairs), "matern52": (_matern52_chain, _matern52_pairs)}


def _rows(theta):
    """A theta (P,) as is, a batch (B, P) as rows (P, B, 1, 1): either way
    ``rows[p]`` broadcasts against an (N, M) grid."""
    return theta if theta.ndim == 1 else theta.T[:, :, None, None]


def se_blocks(x_row, x_col, theta):
    """SE {value, slope} blocks on a broadcast (row, col) grid: x_row
    (N, 1), x_col (1, M), theta rows [sigma_f, l] -> (k00, k10, k01, k11),
    k10 the derivative in the row point."""
    return se_blocks_d(x_row - x_col, theta)


def matern52_blocks(x_row, x_col, theta):
    """Matern-5/2 blocks on a broadcast (row, col) grid."""
    return matern52_blocks_d(x_row - x_col, theta)


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


def _gibbs_pair(sf2, la, dla, lb, dlb, d, sel: int):
    """Gibbs-tanh covariance entries of one derivative block on broadcast-
    compatible operands (the per-pair function of the reference's evidence
    kernel): sel 0 = value-value, 1 = value-slope (column derivative),
    2 = slope-value (row derivative), 3 = slope-slope; ``sf2`` is
    sigma_f^2. Only the selected block's math is evaluated."""
    u = la * la
    v = lb * lb
    inv_S = 1.0 / (u + v)
    d2 = d * d
    k = sf2 * torch.sqrt(2.0 * la * lb * inv_S) * torch.exp(-d2 * inv_S)
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


def _gibbs_pair_blocks(sf, la, dla, lb, dlb, d):
    """All four Gibbs-tanh blocks (k00, k10, k01, k11) on broadcast
    operands: the reference evaluates every block at every pair."""
    sf2 = sf * sf
    return tuple(_gibbs_pair(sf2, la, dla, lb, dlb, d, sel) for sel in (0, 2, 1, 3))


def _tanh_warp(x, l1, l2, lw, x0):
    """l(x) and l'(x) of the tanh length-scale profile."""
    t = torch.tanh((x - x0) / lw)
    return l1 + 0.5 * (l2 - l1) * (1.0 + t), 0.5 * (l2 - l1) * (1.0 - t * t) / lw


def gibbs_tanh_blocks(x_row, x_col, theta):
    """Gibbs-tanh {value, slope} blocks on a broadcast (row, col) grid;
    theta rows [sigma_f, l1, l2, lw, x0]."""
    sf, warp = theta[0], theta[1:5]
    la, dla = _tanh_warp(x_row, *warp)
    lb, dlb = _tanh_warp(x_col, *warp)
    return _gibbs_pair_blocks(sf, la, dla, lb, dlb, x_row - x_col)


def _cov_fused(blocks_fn, X, nid, theta):
    return assemble_blocks(
        blocks_fn(X[:, None], X[None, :], _rows(theta)), nid[:, None], nid[None, :]
    )


def se_cov_fused(X, nid, theta):
    """SE covariance: X (N,), nid (N,) order ids (0 value, 1 slope, any
    other id zero), theta (2,) or (B, 2) -> (N, N) or (B, N, N)."""
    return _cov_fused(se_blocks, X, nid, theta)


def gibbs_tanh_cov_fused(X, nid, theta):
    """Gibbs-tanh covariance: theta (5,) or (B, 5) -> (N, N) or
    (B, N, N)."""
    return _cov_fused(gibbs_tanh_blocks, X, nid, theta)


def matern52_cov_fused(X, nid, theta):
    """Matern-5/2 covariance: theta (2,) or (B, 2) -> (N, N) or
    (B, N, N)."""
    return _cov_fused(matern52_blocks, X, nid, theta)


def _cov_fused_soa(blocks_fn, X, nid, thetaT):
    return assemble_blocks(
        blocks_fn(X[:, None, None], X[None, :, None], thetaT),
        nid[:, None, None], nid[None, :, None],
    )


def se_cov_fused_soa(X, nid, thetaT):
    """Chains-minor SE covariance with every entry computed: X (N,), nid
    (N,), thetaT (2, C) -> K (N, N, C)."""
    return _cov_fused_soa(se_blocks, X, nid, thetaT)


def gibbs_tanh_cov_fused_soa(X, nid, thetaT):
    """Chains-minor Gibbs-tanh covariance with every entry computed:
    thetaT (5, C) -> K (N, N, C)."""
    return _cov_fused_soa(gibbs_tanh_blocks, X, nid, thetaT)


def matern52_cov_fused_soa(X, nid, thetaT):
    """Chains-minor Matern-5/2 covariance with every entry computed:
    thetaT (2, C) -> K (N, N, C)."""
    return _cov_fused_soa(matern52_blocks, X, nid, thetaT)


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


class _ExpandRow(torch.autograd.Function):
    """A chain row (C,) -> (n, C), repeated n times. Autograd's own sum over
    broadcast rows groups the chains by the batch's width, so a chain's
    gradient would depend on how many chains share the call and a sharded
    run (`parallel.mesh`) would leave the unsharded one's bits. The
    backward here sums each chain's n cotangents in a fixed order, the
    same for any width: (k, m) blocks, k ~ sqrt(n), each of the two sums a
    scan down the columns, which PyTorch runs one column a thread in order
    on the card and on the CPU. Expand a chain's factors after the
    arithmetic that involves the chain alone, which then stays (C,). Its
    users: `_pairs_sym`, `gibbs_tanh_cov_fused_soa_sym`,
    `coords_cov_soa_sym`, `warp_coords` (the BetaWarp rows),
    `models.mean.mean_vector`, the ``nd`` channel of
    `models.gp.GPModel._evidence_inputs` and `ops.assemble.delta_matrix`;
    the contract's other sites (the kernel, `ops.evidence._mean_diag`,
    `models.gp._pad_rows`) and the rule for new code are in
    `parallel.mesh`'s docstring."""

    @staticmethod
    def forward(ctx, row, n: int):
        return row.expand(n, row.shape[0])

    @staticmethod
    def backward(ctx, g):
        n, c = g.shape
        k = max(1, math.isqrt(n))
        m = -(-n // k)
        # zero rows to k * m; a second column where there is one, since a
        # scan over a single column takes a parallel route on the card
        g = torch.nn.functional.pad(g, (0, 1 if c == 1 else 0, 0, k * m - n))
        s = g.reshape(k, m, g.shape[1]).cumsum(0)[-1]  # (m, C')
        return s.cumsum(0)[-1, :c].clone(), None


def _expand_rows(rows, n: int):
    """Chain rows, each (C,) -> each (n, C) (`_ExpandRow`)."""
    return [_ExpandRow.apply(t, n) for t in rows]


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
    l, dl = _tanh_warp(X[:, None], *_expand_rows(thetaT[1:5], X.shape[0]))  # (N, C) each
    parts = []
    sf2 = thetaT[0] * thetaT[0]
    for sel, idx in groups:
        r = torch.as_tensor(rows[idx], device=dev)
        c = torch.as_tensor(cols[idx], device=dev)
        d = (X[r] - X[c])[:, None]  # (pairs, 1): chain-free
        sf2_p = _ExpandRow.apply(sf2, len(idx))
        parts.append(_gibbs_pair(sf2_p, l[r], dl[r], l[c], dl[c], d, sel))
    vals = torch.cat(parts)[torch.as_tensor(inv, device=dev)]  # (Np, C)
    return vals[torch.as_tensor(pid, device=dev)]


def _pairs_sym(X, nid, thetaT, chain, pairs):
    """Upper-triangle pairs of a stationary kernel at static separations,
    mirrored to (N, N, C): ``pairs(d, *chain(thetaT))``, the per-chain
    factors expanded to the pairs (`_ExpandRow`)."""
    rows, cols, pid = _triu_index_maps(X.shape[0])
    dev = thetaT.device
    r = torch.as_tensor(rows, device=dev)
    c = torch.as_tensor(cols, device=dev)
    d = (X[r] - X[c])[:, None]
    blocks = pairs(d, *_expand_rows(chain(thetaT), d.shape[0]))
    vals = assemble_blocks(blocks, nid[r][:, None], nid[c][:, None])
    return vals[torch.as_tensor(pid, device=dev)]


def se_cov_fused_soa_sym(X, nid, thetaT):
    """Symmetric chains-minor SE covariance: X (N,), nid (N,), thetaT
    (2, C) -> K (N, N, C); the N(N+1)/2 upper pairs, mirrored."""
    return _pairs_sym(X, nid, thetaT, _se_chain, _se_pairs)


def matern52_cov_fused_soa_sym(X, nid, thetaT):
    """Symmetric chains-minor Matern-5/2 covariance (see
    `se_cov_fused_soa_sym`)."""
    return _pairs_sym(X, nid, thetaT, _matern52_chain, _matern52_pairs)


def beta_warp_pdf(a, b, x):
    """Beta(a, b) density: the BetaWarp slope w'(x). Broadcasts like
    `special.betainc_dd`."""
    xc = torch.clamp(x, 1e-12, 1.0 - 1e-12)
    log_beta = torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)
    return torch.exp((a - 1.0) * torch.log(xc) + (b - 1.0) * torch.log1p(-xc) - log_beta)


def warp_coords(input_warp, X, theta_w, need_slope: bool, chains_minor: bool = True):
    """Warped coordinates w(x) of points X (N,) and the slope w'(x) when
    derivative observations exist (else None). Chains-minor: the warp's
    parameter rows ``theta_w`` are (C,) each and w, w' are (N, C), broadcast
    to (N, C) for the parameter-free LinearWarp too; else they are scalars
    and w, w' are (N,)."""
    from gptools_tpu_torch.ops.kernels import BetaWarp, LinearWarp

    Xcol = X[:, None] if chains_minor else X
    if type(input_warp) is LinearWarp:
        scale = 1.0 / (input_warp.b - input_warp.a)
        w = (Xcol - input_warp.a) * scale
        if chains_minor:
            w = w.expand(X.shape[0], theta_w.shape[-1])
        return w, (torch.full_like(w, scale) if need_slope else None)
    if type(input_warp) is BetaWarp:
        a, b = theta_w[0], theta_w[1]
        if chains_minor:  # each chain's (a, b) to the points (`_ExpandRow`)
            a, b = _expand_rows((a, b), X.shape[0])
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
    chain, pairs = _BASE_PAIRS[base_kind]
    k00, k10, k01, k11 = pairs(w[r] - w[c], *_expand_rows(chain(thetaT), r.shape[0]))
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


def warped_cov_fused(base_kind, input_warp, X, ids, theta):
    """Input-warped covariance k_base(w(x), w(x')) with the slope blocks
    scaled by w' (chain rule): theta [base params | warp params], (P,) or
    (B, P) -> (N, N) or (B, N, N)."""
    pb = {"se": 2, "matern52": 2}[base_kind]
    if theta.ndim == 1:
        w, wp = warp_coords(input_warp, X, theta[pb:], True, chains_minor=False)  # (N,)
    else:
        w, wp = warp_coords(input_warp, X, theta[:, pb:].T, True)  # (N, B)
        w, wp = w.T, wp.T
    wr, wc = w[..., :, None], w[..., None, :]
    chain, pairs = _BASE_PAIRS[base_kind]
    k00, k10, k01, k11 = pairs(wr - wc, *chain(_rows(theta[..., :pb])))
    pr, pc = wp[..., :, None], wp[..., None, :]
    return assemble_blocks(
        (k00, k10 * pr, k01 * pc, k11 * (pr * pc)), ids[:, None], ids[None, :]
    )


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


def flagship_cov_soa(kernel, thetaT, X, nid, multi_indices, symmetric: bool = True):
    """Chains-minor fused K: thetaT (P, C) -> (N, N, C) for a classified
    kernel on 1-D points X (N, 1) or (N,). ``symmetric``: build the upper
    triangle and mirror it, else every entry (the input-warped build is
    symmetric only). Only the symmetric builders give each chain's K
    independently of the batch's width (`_ExpandRow`), which the sharded
    densities' exact equality needs."""
    cls = classify_flagship(kernel)
    if cls is None:
        raise ValueError(type(kernel).__name__)
    kind, _, input_warp = cls
    ids = _order_ids(nid, multi_indices)
    Xf = X.reshape(-1)
    if input_warp is not None:
        return warped_cov_fused_soa_sym(kind, input_warp, Xf, ids, thetaT)
    builds = {
        "se": (se_cov_fused_soa, se_cov_fused_soa_sym),
        "gibbs_tanh": (gibbs_tanh_cov_fused_soa, gibbs_tanh_cov_fused_soa_sym),
        "matern52": (matern52_cov_fused_soa, matern52_cov_fused_soa_sym),
    }
    return builds[kind][1 if symmetric else 0](Xf, ids, thetaT)


def fused_supported(kernel, multi_indices, num_dim) -> bool:
    """True when the fused builders cover (kernel, orders, dimension)."""
    if num_dim != 1:
        return False
    if not set(tuple(m) for m in multi_indices) <= {(0,), (1,)}:
        return False
    return classify_flagship(kernel) is not None


def flagship_cov(kernel, theta, X, nid, multi_indices, backend: str = "fused",
                 points=None):
    """Fused K over one point set for a classified kernel: theta (P,) or
    (B, P) -> (N, N) or (B, N, N).

    backend: ``"fused"`` (plain PyTorch, differentiable) or ``"pallas"``
    (the covariance kernel `ops.cov_cuda` forward, the fused build as its
    backward; on a CPU tensor the kernel's plain version). The kernel
    exists for the SE and Gibbs-tanh kinds only; other kinds take the
    fused build, as in the reference. ``points``: the kernel's
    `cov_cuda.points` of (X, nid, multi_indices), made once by the caller
    that keeps the dataset; made here when None."""
    from gptools_tpu_torch.ops.kernels import GibbsKernel, TanhWarp

    if isinstance(kernel, GibbsKernel) and type(kernel.warp) is not TanhWarp:
        raise ValueError(
            "flagship_cov only implements the TanhWarp Gibbs kernel; got "
            f"GibbsKernel with warp {type(kernel.warp).__name__}. Use the "
            "generic assembly (ops.assemble) for other warps."
        )
    cls = classify_flagship(kernel)
    if cls is None:
        raise ValueError(type(kernel).__name__)
    kind, _, input_warp = cls
    if backend == "pallas" and kind in ("se", "gibbs_tanh") and input_warp is None:
        from gptools_tpu_torch.ops import cov_cuda

        if points is None:
            points = cov_cuda.points(X, nid, multi_indices)
        return cov_cuda.cov_vjp(kind, points, theta)
    ids = _order_ids(nid, multi_indices)
    Xt = X.reshape(-1).to(theta.dtype)
    if input_warp is not None:
        return warped_cov_fused(kind, input_warp, Xt, ids, theta)
    builds = {
        "se": se_cov_fused,
        "gibbs_tanh": gibbs_tanh_cov_fused,
        "matern52": matern52_cov_fused,
    }
    return builds[kind](Xt, ids, theta)


def _order_ids(nid, multi_indices):
    mi = tuple(tuple(m) for m in multi_indices)
    if mi == ((0,),) or mi == ((0,), (1,)):
        return nid
    if mi == ((1,),):
        return nid + 1
    raise ValueError(f"unsupported multi-index table {mi}")
