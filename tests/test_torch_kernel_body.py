"""The CUDA kernel's per-chain body, compiled for the host, against the
plain PyTorch version (autograd), float64 at 1e-10.

`gptools_tpu_torch/csrc/gibbs_tanh_chain.cuh` holds the whole per-chain
algorithm, with hand-derived gradients; `gibbs_tanh_chain_host.cpp` builds
it with the host C++ compiler. Skips when no C++ compiler is installed.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gptools_tpu_torch import configs
from gptools_tpu_torch.ops import evidence_cuda

torch.set_num_threads(1)

CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "gptools_tpu_torch",
    "csrc",
)
GOLD_MEAN = np.array([0.6053, 1.0609, 0.2892, 0.0413, 0.9208])
GOLD_STD = np.array([0.2216, 0.2118, 0.1234, 0.0181, 0.0272])


@pytest.fixture(scope="module")
def body(tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    so = tmp_path_factory.mktemp("chain") / "libchain.so"
    subprocess.run(
        [cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(so),
         os.path.join(CSRC, "gibbs_tanh_chain_host.cpp")],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(so))
    fn = lib.gt_gibbs_tanh_chain_host_f64
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
        ctypes.c_double, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int

    def run(thetaT, ev):
        thetaT = np.ascontiguousarray(thetaT, np.float64)
        C = thetaT.shape[1]
        ll = np.empty(C)
        grad = np.empty((5, C))
        arrs = [ev.X.numpy(), ev.nid.numpy(), ev.y.numpy(), ev.err2.numpy()]
        ptr = [a.ctypes.data_as(ctypes.c_void_p) for a in arrs]
        rc = fn(ev.n, *ptr, ev.diag_factor,
                thetaT.ctypes.data_as(ctypes.c_void_p), C,
                ll.ctypes.data_as(ctypes.c_void_p),
                grad.ctypes.data_as(ctypes.c_void_p))
        assert rc == 0
        return ll, grad

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


def _check(body, thetaT, ev):
    ll_b, g_b = body(thetaT, ev)
    ll_p, g_p = evidence_cuda.loglik_vag_plain(torch.tensor(thetaT), ev)
    np.testing.assert_allclose(ll_b, ll_p.numpy(), rtol=1e-10, atol=0.0)
    np.testing.assert_allclose(g_b, g_p.numpy(), rtol=1e-10, atol=1e-10)


def test_body_matches_plain_at_config4(body):
    prob = configs.config4_gibbs_smc()
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
    prob = configs.config4_gibbs_smc()
    ev = prob.model._evidence_data(prob.data)
    thetaT = _draws(np.random.default_rng(4), 8)
    thetaT[0] = np.linspace(1.5, 4.0, 8)
    _check(body, thetaT, ev)


def test_body_failure_contract(body):
    prob = configs.config4_gibbs_smc()
    ev = prob.model._evidence_data(prob.data)
    thetaT = _draws(np.random.default_rng(5), 4)
    thetaT[2, 1] = np.nan
    ll, g = body(thetaT, ev)
    assert ll[1] == -np.inf and (g[:, 1] == 0).all()
    assert np.isfinite(ll[[0, 2, 3]]).all() and np.isfinite(g).all()
    bad = evidence_cuda.make_data(ev.X, ev.nid, ev.y, -ev.err2 * 1e4, 1e2, "cpu")
    ll, g = body(thetaT, bad)  # non-positive pivots
    assert (ll == -np.inf).all() and (g == 0).all()
