"""The CUDA evidence kernel on the card (marked ``cuda``; skipped without
one). Imports no jax, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Kernel vs plain version on the same device: float64 at ll rtol 1e-9, grad
rtol 1e-7 / atol 1e-9 on posterior-typical draws; float32 within the
tolerances stated in chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from gptools_tpu_torch import configs
from gptools_tpu_torch.ops import evidence_cuda

pytestmark = pytest.mark.cuda

GOLD_MEAN = np.array([0.6053, 1.0609, 0.2892, 0.0413, 0.9208])
GOLD_STD = np.array([0.2216, 0.2118, 0.1234, 0.0181, 0.0272])


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def problem(dev):
    prob = configs.config4_gibbs_smc(dtype=torch.float64, device=dev)
    return prob, prob.model._evidence_data(prob.data)


def _draws(C, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    th = GOLD_MEAN + GOLD_STD * rng.uniform(-1.0, 1.0, (C, 5))
    return torch.tensor(th.T.copy(), dtype=dtype, device=dev)


@pytest.mark.parametrize("C", [1, 63, 1000])
def test_kernel_matches_plain_f64(dev, problem, C):
    _, ev = problem
    th = _draws(C, torch.float64, dev, seed=C)
    n0 = evidence_cuda.LAUNCHES
    llk, gk = evidence_cuda.vag(th, ev)
    assert evidence_cuda.LAUNCHES == n0 + 1
    llp, gp = evidence_cuda.loglik_vag_plain(th, ev)
    np.testing.assert_allclose(llk.cpu().numpy(), llp.cpu().numpy(), rtol=1e-9)
    np.testing.assert_allclose(gk.cpu().numpy(), gp.cpu().numpy(), rtol=1e-7, atol=1e-9)


def test_kernel_matches_plain_f32(dev, problem):
    _, ev = problem
    th = _draws(4096, torch.float32, dev, seed=1)
    llk, gk = evidence_cuda.loglik_vag_cuda(th, ev)
    llp, gp = evidence_cuda.loglik_vag_plain(th, ev)
    assert float(((llk - llp).abs() / llp.abs().clamp(min=1.0)).max()) <= 1e-3
    assert float(((gk - gp).norm(dim=0) / gp.norm(dim=0)).max()) <= 1e-2


def test_failure_contract(dev, problem):
    _, ev = problem
    for dtype in (torch.float32, torch.float64):
        th = _draws(6, dtype, dev, seed=2)
        th[2, 1] = float("nan")
        ll, g = evidence_cuda.loglik_vag_cuda(th, ev)
        assert float(ll[1]) == -float("inf")
        assert bool((g[:, 1] == 0).all()) and bool(torch.isfinite(g).all())
        assert bool(torch.isfinite(ll[[0, 2, 3, 4, 5]]).all())


def test_model_gradient_through_kernel(dev, problem):
    """GPModel on a CUDA Dataset takes the kernel; backward is g * grad."""
    prob, ev = problem
    th = _draws(16, torch.float64, dev, seed=3).T.contiguous().requires_grad_(True)
    n0, p0 = evidence_cuda.LAUNCHES, evidence_cuda.PLAIN_CALLS
    ll = prob.model.log_marginal_batch(th, prob.data)
    ct = torch.linspace(0.5, 2.0, 16, dtype=torch.float64, device=dev)
    (g,) = torch.autograd.grad(ll, th, ct)
    assert evidence_cuda.LAUNCHES == n0 + 1 and evidence_cuda.PLAIN_CALLS == p0
    llp, gp = evidence_cuda.loglik_vag_plain(th.detach().T.contiguous(), ev)
    np.testing.assert_allclose(
        g.cpu().numpy(), (ct[:, None] * gp.T).cpu().numpy(), rtol=1e-7, atol=1e-9
    )


def test_model_raises_beyond_kernel_range(dev):
    prob = configs.config4_gibbs_smc(n_points=47, dtype=torch.float64, device=dev)
    th = _draws(4, torch.float64, dev).T.contiguous()
    with pytest.raises(ValueError, match="N_MAX"):
        prob.model.log_marginal_batch(th, prob.data)
