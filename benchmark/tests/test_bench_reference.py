"""The plain reference against the program's CPU path, float64."""

import importlib
import json
import os

import numpy as np
import pytest
import torch

from benchmark.tests.conftest import ROOT

CONFIGS = ("config4_gibbs_tanh", "config3_matern_warp_mean")


def _load(name):
    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as f:
        cfg = json.load(f)
    mod = importlib.import_module(f"benchmark.configs.{name}")
    arrays = mod.make_data(cfg)
    return cfg, mod, arrays


@pytest.mark.parametrize("name", CONFIGS)
def test_data_is_the_ports_config(name):
    """make_data copies the repository's config generator."""
    from gptools_tpu_torch import configs

    cfg, mod, arrays = _load(name)
    port = {"config4_gibbs_tanh": configs.config4_gibbs_smc,
            "config3_matern_warp_mean": configs.config3_matern_mean_warp_hmc}[name](
        seed=cfg["data_seed"], device="cpu")
    model, data = mod.program(cfg, arrays, torch.float64, torch.device("cpu"))
    assert torch.equal(data.y, port.data.y)
    assert torch.equal(data.Xf, port.data.Xf)
    assert torch.equal(data.err_y, port.data.err_y)
    assert torch.equal(data.nid, port.data.nid)
    assert model.param_names == port.model.param_names == tuple(cfg["param_names"])


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_matches_program(name):
    cfg, mod, arrays = _load(name)
    model, data = mod.program(cfg, arrays, torch.float64, torch.device("cpu"))
    ref = mod.reference(cfg, arrays, torch.device("cpu"))
    gen = torch.Generator().manual_seed(5)
    u0 = model.u_of_theta(torch.tensor(cfg["pilot_mean"], dtype=torch.float64))
    u = u0 + 0.5 * torch.randn(16, u0.shape[0], generator=gen, dtype=torch.float64)
    th = model.theta_of_u(u)
    np.testing.assert_allclose(ref.theta_of_u(u), th, rtol=1e-14, atol=0)
    np.testing.assert_allclose(ref.log_posterior_u(u).detach(),
                               model.log_posterior_u_batch(u, data), rtol=1e-10, atol=1e-10)
    t = th.clone().requires_grad_(True)
    ll = model.log_marginal_batch(t, data)
    (g,) = torch.autograd.grad((model.log_prior(t) + ll).sum(), t)
    ll_ref, g_ref = ref.ll_and_grad(th)
    np.testing.assert_allclose(ll_ref, ll.detach(), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(g_ref, g, rtol=1e-8, atol=1e-8)


def test_betainc_against_series():
    """I_x(a, b) against its power series, summed in float64 to 400 terms."""
    from benchmark.reference.special import betainc

    a = torch.tensor([0.3, 0.5, 1.0, 2.3, 3.0], dtype=torch.float64)[:, None]
    b = torch.tensor([3.0, 1.1, 0.3, 1.0, 2.9], dtype=torch.float64)[:, None]
    x = torch.linspace(0.02, 0.98, 35, dtype=torch.float64)[None]
    got = betainc(a, b, x)
    # I_x(a, b) = x^a (1-x)^b / (a B(a, b)) sum_n B(a+1, n+1)/B(a+b, n+1) x^n
    lb = torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)
    term = torch.ones_like(got)
    total = torch.ones_like(got)
    for n in range(1, 4000):
        term = term * (a + b + n - 1) / (a + n) * x
        total = total + term
    want = torch.exp(a * torch.log(x) + b * torch.log1p(-x) - lb) / a * total
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)


def test_ess_of_ar1():
    """The frozen ESS against the AR(1) process's (1 - phi) / (1 + phi)."""
    from benchmark.lib.diagnostics import ess, split_rhat

    phi, m, n = 0.6, 400, 2000
    gen = torch.Generator().manual_seed(3)
    e = torch.randn(m, n, generator=gen, dtype=torch.float64)
    x = torch.empty_like(e)
    x[:, 0] = e[:, 0] / (1 - phi * phi) ** 0.5
    for t in range(1, n):
        x[:, t] = phi * x[:, t - 1] + e[:, t]
    want = m * n * (1 - phi) / (1 + phi)
    assert abs(float(ess(x)) / want - 1) < 0.05
    r = split_rhat(x[:, :, None])
    assert 1.0 <= float(r[0]) < 1.01


def test_ess_is_the_ports():
    """The frozen copy gives the program's diagnostics' numbers."""
    from benchmark.lib.diagnostics import ess_per_param, split_rhat
    from gptools_tpu_torch.utils import diagnostics

    gen = torch.Generator().manual_seed(4)
    s = torch.randn(64, 300, 3, generator=gen, dtype=torch.float64).cumsum(1) * 0.1
    s = s + torch.randn(64, 300, 3, generator=gen, dtype=torch.float64)
    np.testing.assert_allclose(ess_per_param(s), diagnostics.ess_per_param(s), rtol=1e-9)
    np.testing.assert_allclose(split_rhat(s), diagnostics.split_rhat(s), rtol=1e-12)
