"""The CUDA kernels' bodies, compiled for the host, against their plain
PyTorch versions, float64.

`gptools_tpu_torch/csrc/evidence_chain.cuh` holds the evidence kernel's
warp-per-chain body for every pair kind and aux channel, with hand-derived
gradients (held to autograd at 1e-10); the host build runs its 32 lanes
phase by phase, in order 0..31 and, for the lane-order test, 31..0, which
must give the same bits. `cov_entry.cuh` holds the covariance kernel's
per-point and per-entry functions (held to the fused single-theta builders
at 1e-12) and its three layouts (a block per theta for N <= 64, a block
per 4 rows of a theta for N <= 32 when the thetas do not fill the card,
64 x 64 tiles above) as functions of the thread index, whose host build
runs every phase's threads in both orders and must give the same bits,
an exactly symmetric K and the plain version's entries.
`evidence_chain_host.cpp` builds both with the host C++ compiler. Skips
when no C++ compiler is installed.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gptools_tpu_torch import configs
from gptools_tpu_torch.ops import cov_cuda, evidence_cuda

torch.set_num_threads(1)

CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "gptools_tpu_torch",
    "csrc",
)
GOLD_MEAN = np.array([0.6053, 1.0609, 0.2892, 0.0413, 0.9208])
GOLD_STD = np.array([0.2216, 0.2118, 0.1234, 0.0181, 0.0272])
AUX = evidence_cuda.AUX_NAMES


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The host build of the kernels' bodies."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    so = tmp_path_factory.mktemp("chain") / "libchain.so"
    subprocess.run(
        [cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(so),
         os.path.join(CSRC, "evidence_chain_host.cpp")],
        check=True, capture_output=True, timeout=300,
    )
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def body(host_lib):
    """``run(thetaT, ev, aux=None, reversed=False) -> (ll, grad, gaux)``
    through the host build of the kind's warp-per-chain body, its lanes in
    order 0..31 (or 31..0 with ``reversed``); numpy in, numpy out."""
    lib = host_lib
    fns = {}
    for kind in evidence_cuda.KINDS:
        for rev in (False, True):
            fn = getattr(lib, f"gt_{kind}_chain_host_{'rev_' if rev else ''}f64")
            fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
                ctypes.c_double, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 10
            fn.restype = ctypes.c_int
            fns[kind, rev] = fn

    def ptr(a):
        return None if a is None else a.ctypes.data_as(ctypes.c_void_p)

    def run(thetaT, ev, aux=None, reversed=False):
        aux = {k: np.ascontiguousarray(v, np.float64) for k, v in (aux or {}).items()}
        thetaT = np.ascontiguousarray(thetaT, np.float64)
        C = thetaT.shape[1]
        ll = np.empty(C)
        grad = np.empty_like(thetaT)
        gaux = {k: np.empty_like(v) for k, v in aux.items()}
        arrs = [ev.X.numpy(), ev.nid.numpy(), ev.y.numpy(), ev.err2.numpy()]
        rc = fns[ev.kind, reversed](
            ev.n, *(ptr(a) for a in arrs), ev.diag_factor, ptr(thetaT), C,
            *(ptr(aux.get(k)) for k in AUX), ptr(ll), ptr(grad),
            *(ptr(gaux.get(k)) for k in AUX),
        )
        assert rc == 0
        return ll, grad, gaux

    return run


def _draws(rng, C):
    mu = np.array([0.0, -1.0, -2.3, -2.3])
    sg = np.array([0.75, 0.6, 0.6, 0.6])
    prior = np.concatenate(
        [np.exp(mu + sg * rng.standard_normal((C // 2, 4))),
         rng.uniform(0.6, 1.1, (C // 2, 1))],
        axis=1,
    )
    post = GOLD_MEAN + GOLD_STD * rng.uniform(-1.0, 1.0, (C - C // 2, 5))
    return np.concatenate([prior, post]).T.copy()  # (5, C)


def _check(body, thetaT, ev, aux=None):
    ll_b, g_b, ga_b = body(thetaT, ev, aux)
    out = evidence_cuda.loglik_vag_plain(
        torch.tensor(thetaT), ev, {k: torch.tensor(v) for k, v in (aux or {}).items()}
    )
    np.testing.assert_allclose(ll_b, out[0].numpy(), rtol=1e-10, atol=0.0)
    np.testing.assert_allclose(g_b, out[1].numpy(), rtol=1e-10, atol=1e-10)
    for k in aux or {}:
        np.testing.assert_allclose(ga_b[k], out[2][k].numpy(), rtol=1e-10,
                                   atol=1e-10, err_msg=k)


def test_body_matches_plain_at_config4(body):
    prob = configs.config4_gibbs_smc(device="cpu")
    ev = prob.model._evidence_data(prob.data)
    _check(body, _draws(np.random.default_rng(11), 32), ev)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_body_matches_plain_every_selector(body, seed):
    """Slopes interleaved with values, so all four derivative blocks (and
    both pair orders) occur in the lower triangle."""
    rng = np.random.default_rng(seed)
    n = 10
    X = np.sort(rng.uniform(0.0, 1.2, n))
    nid = rng.permutation([0] * 6 + [1] * 4)
    y = rng.standard_normal(n)
    ev = evidence_cuda.make_data(X, nid, y, np.full(n, 0.02), 1e2, "cpu")
    _check(body, rng.uniform(0.3, 1.4, (5, 16)), ev)


def test_body_jitter_trace_term(body):
    """Large amplitudes put the mean diagonal above 1, where the jitter
    depends on K and adds its trace term to the diagonal cotangent."""
    prob = configs.config4_gibbs_smc(device="cpu")
    ev = prob.model._evidence_data(prob.data)
    thetaT = _draws(np.random.default_rng(4), 8)
    thetaT[0] = np.linspace(1.5, 4.0, 8)
    _check(body, thetaT, ev)


def test_body_failure_contract(body):
    prob = configs.config4_gibbs_smc(device="cpu")
    ev = prob.model._evidence_data(prob.data)
    thetaT = _draws(np.random.default_rng(5), 4)
    thetaT[2, 1] = np.nan
    ll, g, _ = body(thetaT, ev)
    assert ll[1] == -np.inf and (g[:, 1] == 0).all()
    assert np.isfinite(ll[[0, 2, 3]]).all() and np.isfinite(g).all()
    bad = evidence_cuda.make_data(ev.X, ev.nid, ev.y, -ev.err2 * 1e4, 1e2, "cpu")
    ll, g, _ = body(thetaT, bad)  # non-positive pivots
    assert (ll == -np.inf).all() and (g == 0).all()


def _stationary_problem(rng, kind, slopes: bool, n_val=8):
    """Values on (0, 1) with slope rows interleaved (two at repeated x, as
    in config 2), or values only; X sorted so a monotone warp keeps the
    order."""
    X = np.sort(rng.uniform(0.05, 0.95, n_val))
    nid = np.zeros(n_val, int)
    if slopes:
        X = np.sort(np.concatenate([X, X[[0, -1]], rng.uniform(0.1, 0.9, 2)]))
        nid = np.zeros(X.shape[0], int)
        nid[[0, -1]] = 1  # slope at the repeated end points
        nid[rng.choice(np.arange(2, X.shape[0] - 2), 2, replace=False)] = 1
    n = X.shape[0]
    y = rng.standard_normal(n)
    return evidence_cuda.make_data(X, nid, y, np.full(n, 0.01), 1e2, "cpu", kind)


def _aux_channels(rng, ev, C, names):
    """Aux inputs (N, C): a mean, a noise variance and a monotone warp
    w = x^p with its slope p x^(p-1), per chain."""
    X = ev.X.numpy()[:, None]
    p = rng.uniform(0.6, 1.6, C)[None, :]
    vals = {
        "mu": 0.3 * rng.standard_normal((ev.n, C)),
        "nd": rng.uniform(0.001, 0.05, (ev.n, C)),
        "w": X**p,
        "wp": p * X ** (p - 1.0),
    }
    return {k: vals[k] for k in names}


_AUX_SETS = [(), ("mu", "nd"), ("mu", "nd", "w", "wp"), ("w",)]


@pytest.mark.parametrize("kind", ["se", "matern52"])
@pytest.mark.parametrize("names", _AUX_SETS, ids=lambda t: "+".join(t) or "none")
def test_body_matches_plain_stationary(body, kind, names):
    """SE and Matern-5/2 with every aux channel: theta gradient and every
    cotangent at 1e-10, on theta draws with scale above 1 in half of them
    (the jitter's trace term live)."""
    rng = np.random.default_rng([_AUX_SETS.index(names), kind == "se"])
    ev = _stationary_problem(rng, kind, slopes="w" not in names or "wp" in names)
    C = 10
    thetaT = np.stack([rng.uniform(0.3, 2.5, C), rng.uniform(0.15, 1.2, C)])
    _check(body, thetaT, ev, _aux_channels(rng, ev, C, names))


def test_body_matches_plain_gibbs_with_mean_and_noise(body):
    rng = np.random.default_rng(9)
    n = 10
    X = np.sort(rng.uniform(0.0, 1.2, n))
    nid = rng.permutation([0] * 7 + [1] * 3)
    ev = evidence_cuda.make_data(X, nid, rng.standard_normal(n), np.full(n, 0.02), 1e2, "cpu")
    _check(body, rng.uniform(0.3, 1.4, (5, 8)), ev, _aux_channels(rng, ev, 8, ("mu", "nd")))


@pytest.mark.parametrize("kind", ["se", "matern52"])
def test_body_failure_contract_zeroes_aux(body, kind):
    rng = np.random.default_rng(3)
    ev = _stationary_problem(rng, kind, slopes=True)
    aux = _aux_channels(rng, ev, 4, AUX)
    thetaT = np.stack([rng.uniform(0.3, 2.5, 4), rng.uniform(0.15, 1.2, 4)])
    aux["nd"][3, 2] = -1e3  # a negative pivot in chain 2
    ll, g, ga = body(thetaT, ev, aux)
    assert ll[2] == -np.inf and (g[:, 2] == 0).all()
    assert all((v[:, 2] == 0).all() for v in ga.values())
    assert np.isfinite(ll[[0, 1, 3]]).all()


# ---- sizes and lane order of the warp-per-chain body --------------------------


def _sized_problem(rng, kind, n):
    """n points on (0.05, 0.95), about a quarter of them slope rows (one at
    a repeated x); a single point is a slope row, so every aux channel
    applies. Returns the data and the largest aux set of the kind, with a
    theta draw of 6 chains."""
    if n == 1:
        X, nid = np.array([0.5]), np.array([1])
    else:
        n_slope = max(1, n // 4)
        X = np.sort(rng.uniform(0.05, 0.95, n - 1))
        X = np.sort(np.concatenate([X, X[[0]]]))  # x repeated at the first point
        nid = np.zeros(n, int)
        nid[1] = 1
        nid[rng.choice(np.arange(2, n), n_slope - 1, replace=False)] = 1
    # a smooth curve and its slope, with noise at the error scale: white
    # noise as y would leave alpha = K^-1 r so large that its cotangents
    # cancel to the plain version's own rounding
    y = np.where(nid == 1, 5 * np.cos(5 * X), np.sin(5 * X)) + 0.1 * rng.standard_normal(n)
    ev = evidence_cuda.make_data(X, nid, y, np.full(n, 0.01), 1e2, "cpu", kind)
    C = 6
    if kind == "gibbs_tanh":
        names = ("mu", "nd")
        thetaT = np.stack([rng.uniform(0.5, 1.5, C), rng.uniform(0.3, 1.2, C),
                           rng.uniform(0.05, 0.4, C), rng.uniform(0.03, 0.2, C),
                           rng.uniform(0.3, 0.7, C)])
    else:
        names = AUX
        # length scales up to half the span: at 48 points a longer one
        # leaves K so near singular that the plain version's own rounding
        # exceeds 1e-10
        thetaT = np.stack([rng.uniform(0.5, 1.5, C), rng.uniform(0.1, 0.5, C)])
    return thetaT, ev, _aux_channels(rng, ev, C, names)


@pytest.mark.parametrize("kind", list(evidence_cuda.KINDS))
@pytest.mark.parametrize("n", [1, 27, 32, 33, 35, 48])
def test_body_matches_plain_sizes(body, kind, n):
    """One point, the configs' 27, 32 and 35, 33 (from n = 32 on a lane
    owns two rows of each Cholesky step) and N_MAX = 48, with every aux
    channel the kind takes, at 1e-10."""
    rng = np.random.default_rng([n, len(kind)])
    _check(body, *_sized_problem(rng, kind, n))


@pytest.mark.parametrize("kind", list(evidence_cuda.KINDS))
@pytest.mark.parametrize("where", ["config4", "n48"])
def test_body_lane_order_is_bitwise_invariant(body, kind, where):
    """Lanes run 0..31 and 31..0 give the same bits in ll, the gradient and
    every cotangent: no lane reads, within a phase, what another lane
    writes in it."""
    rng = np.random.default_rng(21)
    if where == "config4":
        prob = configs.config4_gibbs_smc(device="cpu")
        e = prob.model._evidence_data(prob.data)
        ev = evidence_cuda.make_data(e.X, e.nid, e.y, e.err2, e.diag_factor, "cpu", kind)
        thetaT = _draws(rng, 16)
        if kind != "gibbs_tanh":
            thetaT = thetaT[[0, 1]]
        aux = None
    else:
        thetaT, ev, aux = _sized_problem(rng, kind, 48)
    fwd = body(thetaT, ev, aux)
    rev = body(thetaT, ev, aux, reversed=True)
    assert np.isfinite(fwd[0]).all()
    np.testing.assert_array_equal(fwd[0], rev[0])
    np.testing.assert_array_equal(fwd[1], rev[1])
    for k in fwd[2]:
        np.testing.assert_array_equal(fwd[2][k], rev[2][k], err_msg=k)


# ---- the covariance kernel: every layout, thread by thread -------------------


def _cov_host(host_lib, kind, dtype, reversed=False, sms=132):
    """The host build of the kernel's launch on a card of ``sms``
    multiprocessors (132, an H100: B < 132 thetas at n <= 32 take the
    bands; 1: every B fills the card, so n <= 64 takes a block per
    theta)."""
    fn = getattr(host_lib, f"gt_{kind}_cov_host_{'rev_' if reversed else ''}{dtype}")
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int])
    fn.restype = ctypes.c_int
    npdt = np.float64 if dtype == "f64" else np.float32

    def run(X, nid, theta, offset=0):
        """K (B, n, n) from a NaN-filled buffer, the output `offset`
        entries into it (an output that starts off a 16-byte boundary);
        the entries around the output must stay NaN."""
        B, n = theta.shape[0], X.shape[0]
        th = np.ascontiguousarray(theta, npdt)
        buf = np.full(B * n * n + 8, np.nan, npdt)
        out = buf[offset:offset + B * n * n]
        args = (np.ascontiguousarray(X, np.float64), np.ascontiguousarray(nid, np.int32), th)
        assert fn(n, *(a.ctypes.data_as(ctypes.c_void_p) for a in args), B,
                  out.ctypes.data_as(ctypes.c_void_p), sms) == 0
        assert np.isnan(buf[:offset]).all() and np.isnan(buf[offset + B * n * n:]).all()
        return out.reshape(B, n, n)

    return run


def _cov_thetas(rng, kind, B):
    if kind == "se":
        return np.stack([rng.uniform(0.4, 1.6, B), rng.uniform(0.2, 0.8, B)], 1)
    return np.stack([rng.uniform(0.5, 1.5, B), rng.uniform(0.3, 1.2, B),
                     rng.uniform(0.05, 0.4, B), rng.uniform(0.03, 0.2, B),
                     rng.uniform(0.3, 0.9, B)], 1)


def _cov_points(rng, n):
    """n sorted points on (0, 1.2), about a fifth of them slope rows, one
    id -1 and one id 2 (exact zeros) from n = 7 on."""
    X = np.sort(rng.uniform(0.0, 1.2, n))
    nid = (rng.uniform(size=n) < 0.2).astype(np.int32)
    if n >= 7:
        nid[rng.choice(n, 2, replace=False)] = [-1, 2]
    return X, nid


@pytest.mark.parametrize("kind", ["se", "gibbs_tanh"])
def test_cov_entries_match_plain(host_lib, kind):
    """Every entry of K for a theta batch of 3, slopes interleaved and ids
    outside {0, 1}, against the fused single-theta builder at 1e-12; the
    whole matrix exactly symmetric, the bad ids' rows and columns exact
    zeros."""
    rng = np.random.default_rng(12)
    n = 23
    X = np.sort(rng.uniform(0.0, 1.2, n))
    nid = rng.permutation([0] * 15 + [1] * 6 + [-1, 2]).astype(np.int32)
    theta = (np.stack([rng.uniform(0.4, 1.6, 3), rng.uniform(0.2, 0.8, 3)], 1)
             if kind == "se" else np.stack(
                 [rng.uniform(0.5, 1.5, 3), rng.uniform(0.3, 1.2, 3),
                  rng.uniform(0.05, 0.4, 3), rng.uniform(0.03, 0.2, 3),
                  rng.uniform(0.7, 1.0, 3)], 1))
    out = _cov_host(host_lib, kind, "f64")(X, nid, theta)
    ref = cov_cuda.cov_plain(kind, torch.tensor(X), torch.tensor(nid), torch.tensor(theta))
    np.testing.assert_allclose(out, ref.numpy(), rtol=1e-12, atol=1e-14)
    assert (out == out.transpose(0, 2, 1)).all()
    bad = (nid < 0) | (nid > 1)
    assert (out[:, bad, :] == 0).all() and (out[:, :, bad] == 0).all()


# n: one point; 2 and 7, fewer pairs than a block's threads; the serving 27 and 32;
# 31 and 33 around a warp; 63 and 64, the last of the small layout; 65
# and 130, tiles with a ragged edge of 1 and 2
COV_SIZES = [1, 2, 7, 27, 31, 32, 33, 63, 64, 65, 130]


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("n", COV_SIZES)
@pytest.mark.parametrize("kind", ["se", "gibbs_tanh"])
def test_cov_layout_thread_order_and_plain(host_lib, kind, n, B, dtype):
    """The kernel's layout for this n and B (bands, small or tiles), its
    threads run 0..nt-1 and nt-1..0 in every phase on NaN-filled shared
    memory, on an H100's 132 SMs (bands at n <= 32) and on a card of 1
    (a block per theta): the same bits in all four runs, every entry written (no NaN; nothing written around
    the output), the whole matrix exactly symmetric, ids outside {0, 1}
    exact zeros, and K within 1e-12 (float64) / 1e-5 (float32, the plain
    version rounds X to float32 first) of max |K| of the plain version.
    With B = 3 the output also starts off a 16-byte boundary."""
    rng = np.random.default_rng([n, B, kind == "se"])
    X, nid = _cov_points(rng, n)
    theta = _cov_thetas(rng, kind, B)
    offset = 1 if B == 3 else 0
    fwd = _cov_host(host_lib, kind, dtype)(X, nid, theta, offset)
    assert not np.isnan(fwd).any()
    for rev, sms in ((True, 132), (False, 1), (True, 1)):
        other = _cov_host(host_lib, kind, dtype, reversed=rev, sms=sms)(X, nid, theta, offset)
        np.testing.assert_array_equal(fwd.view(np.uint8), other.view(np.uint8))
    assert (fwd == fwd.transpose(0, 2, 1)).all()
    bad = (nid < 0) | (nid > 1)
    assert (fwd[:, bad, :] == 0).all() and (fwd[:, :, bad] == 0).all()
    tdt = torch.float64 if dtype == "f64" else torch.float32
    ref = cov_cuda.cov_plain(kind, torch.tensor(X), torch.tensor(nid),
                             torch.tensor(theta, dtype=tdt)).numpy()
    tol = 1e-12 if dtype == "f64" else 1e-5
    assert np.abs(fwd - ref).max() <= tol * max(np.abs(ref).max(), 1e-300)
