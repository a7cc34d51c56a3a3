"""The CUDA kernels on the card (marked ``cuda``; skipped without one).
Imports no jax, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Kernel vs plain version on the same device: float64 at ll rtol 1e-9, grad
(and every aux cotangent) rtol 1e-7 / atol 1e-9 on posterior-typical
draws; float32 within the tolerances stated in chip_smoke.py. Config 4
holds kind gibbs_tanh; configs 2 and 3 hold kinds se and matern52 with the
aux channels their models build (none; mu and w), and the se_noise and
warped_se_deriv models hold nd, w and wp (se_noise also at N = 48, the
largest shared-memory case); the kernel is held at C = 1 and at C that
fill no block of 4 warps, and three calls must give the same bits. The
covariance kernel
(`cov_cuda`) is held to its plain version at theta batches 1 and 512 on
configs 4 (gibbs_tanh) and 2 (se) and in its tile layout at N = 1001
(ragged) and 65 and 130 (ids outside {0, 1}), the whole matrix exactly
symmetric, with its VJP and the pallas-backend serving predictor. A
batched density call with its gradient (config 4, all free and with x0
fixed) never makes the host wait for the card.
"""

import json
import os

import numpy as np
import pytest
import torch

from gptools_tpu_torch import configs
from gptools_tpu_torch.models.dataset import DatasetBuilder
from gptools_tpu_torch.models.gp import GPModel
from gptools_tpu_torch.ops import evidence_cuda
from gptools_tpu_torch.ops.kernels import (
    BetaWarp,
    DiagonalNoiseKernel,
    SquaredExponentialKernel,
    WarpedKernel,
)

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


@pytest.mark.parametrize("C", [1, 63, 1000, 1023])
def test_kernel_matches_plain_f64(dev, problem, C):
    _, ev = problem
    th = _draws(C, torch.float64, dev, seed=C)
    n0 = evidence_cuda.LAUNCHES["gibbs_tanh"]
    llk, gk = evidence_cuda.vag(th, ev)
    assert evidence_cuda.LAUNCHES["gibbs_tanh"] == n0 + 1
    llp, gp = evidence_cuda.loglik_vag_plain(th, ev)
    np.testing.assert_allclose(llk.cpu().numpy(), llp.cpu().numpy(), rtol=1e-9)
    np.testing.assert_allclose(gk.cpu().numpy(), gp.cpu().numpy(), rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("C", [1, 1023, 4096])
def test_kernel_matches_plain_f32(dev, problem, C):
    _, ev = problem
    th = _draws(C, torch.float32, dev, seed=1)
    llk, gk = evidence_cuda.loglik_vag_cuda(th, ev)
    llp, gp = evidence_cuda.loglik_vag_plain(th, ev)
    assert float(((llk - llp).abs() / llp.abs().clamp(min=1.0)).max()) <= 1e-3
    assert float(((gk - gp).norm(dim=0) / gp.norm(dim=0)).max()) <= 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_kernel_is_deterministic(dev, problem, dtype):
    """Three calls at config 4's 12288 chains give the same bits (no
    atomics; every sum in a fixed order)."""
    _, ev = problem
    th = _draws(12288, dtype, dev, seed=7)
    outs = [evidence_cuda.loglik_vag_cuda(th, ev) for _ in range(3)]
    for ll, g in outs[1:]:
        assert torch.equal(ll, outs[0][0]) and torch.equal(g, outs[0][1])


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
    n0, p0 = dict(evidence_cuda.LAUNCHES), dict(evidence_cuda.PLAIN_CALLS)
    ll = prob.model.log_marginal_batch(th, prob.data)
    ct = torch.linspace(0.5, 2.0, 16, dtype=torch.float64, device=dev)
    (g,) = torch.autograd.grad(ll, th, ct)
    assert evidence_cuda.LAUNCHES["gibbs_tanh"] == n0["gibbs_tanh"] + 1
    assert evidence_cuda.PLAIN_CALLS == p0
    llp, gp = evidence_cuda.loglik_vag_plain(th.detach().T.contiguous(), ev)
    np.testing.assert_allclose(
        g.cpu().numpy(), (ct[:, None] * gp.T).cpu().numpy(), rtol=1e-7, atol=1e-9
    )


@pytest.mark.parametrize("fixed", [False, True])
def test_density_call_never_waits_for_the_card(dev, problem, fixed):
    """One `hmc.value_and_grad(log_posterior_u_batch)` call on config 4's
    model (and on it with x0 fixed, once its fixed tensors are made) under
    ``set_sync_debug_mode("error")``: no read of the card and no copy to
    it that waits for the stream."""
    from gptools_tpu_torch.infer import hmc
    from gptools_tpu_torch.ops.kernels import GibbsKernel1dTanh

    prob, _ = problem
    model = prob.model
    if fixed:
        model = GPModel(GibbsKernel1dTanh(hyperprior=model.kernel.hyperprior,
                                          fixed_params=[False] * 4 + [True]))
    th = model.extract_free(_draws(256, torch.float64, dev, seed=4).T.contiguous())
    us = model.u_of_theta(model.embed_free(th))
    vg = hmc.value_and_grad(lambda u: model.log_posterior_u_batch(u, prob.data))
    lp0, g0 = vg(us)  # loads the library, uploads the data and the fixed tensors
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        lp, g = vg(us)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize(dev)
    assert torch.equal(lp, lp0) and torch.equal(g, g0)
    assert bool(torch.isfinite(lp).all()) and bool(torch.isfinite(g).all())


def test_model_raises_beyond_kernel_range(dev):
    """Past N_MAX the kernel's wrapper still raises; the model does not
    call it there, and takes the route instead (as the reference does), with
    the CPU's numbers."""
    prob = configs.config4_gibbs_smc(n_points=47, dtype=torch.float64, device=dev)
    th = _draws(4, torch.float64, dev).T.contiguous()
    big = evidence_cuda.make_data(prob.data.Xf[:, 0], prob.data.nid, prob.data.y,
                                  prob.data.err_y ** 2, 1e2, dev)
    assert big.n == 49
    with pytest.raises(ValueError, match="outside the kernel's range"):
        evidence_cuda.loglik_vag_cuda(th.T.contiguous(), big)
    evidence_cuda.reset_counts()
    ll = prob.model.log_marginal_batch(th, prob.data)
    assert evidence_cuda.ROUTE_CALLS["chains_minor"] == 1
    assert sum(evidence_cuda.LAUNCHES.values()) == 0
    cpu = configs.config4_gibbs_smc(n_points=47, dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(
        ll.cpu().numpy(), cpu.model.log_marginal_batch(th.cpu(), cpu.data).numpy(), rtol=1e-9)


# ---- kinds se and matern52, with the aux channels ---------------------------


def _golden_draws(config, C, dtype, dev, seed):
    """Golden mean +- 1 std (uniform): thetas (C, P)."""
    path = os.path.join(os.path.dirname(__file__), f"golden_config{config}.json")
    with open(path) as f:
        gold = json.load(f)
    gm, gs = np.asarray(gold["mean"]), np.asarray(gold["std"])
    th = gm + gs * np.random.default_rng(seed).uniform(-1.0, 1.0, (C, gm.shape[0]))
    return torch.tensor(th, dtype=dtype, device=dev)


def _variant(name, dev):
    """The se_noise / warped_se_deriv models of the reference's
    tests/test_evidence_pallas.py::_model_variants on seeded data;
    se_noise_n48 is se_noise at N_MAX = 48 points (46 values), the kernel's
    largest shared-memory case."""
    rng = np.random.default_rng(5)
    lo, hi = (0.05, 0.95) if name == "warped_se_deriv" else (0.0, 1.2)
    b = DatasetBuilder(1)
    X = np.sort(rng.uniform(lo, hi, 46 if name == "se_noise_n48" else 7))
    b.add(X, np.sin(X), err_y=0.1)
    b.add(np.array([lo, hi]), np.zeros(2), err_y=0.05, n=1)
    if name != "warped_se_deriv":
        model = GPModel(SquaredExponentialKernel(), noise_kernel=DiagonalNoiseKernel(n=0))
    else:
        model = GPModel(WarpedKernel(SquaredExponentialKernel(), BetaWarp()))
    return model, b.build(torch.float64, dev)


def _inputs(model, data, thetas):
    with torch.no_grad():
        thT, ev, aux = model._evidence_inputs(thetas.T, data)
    return thT.contiguous(), ev, {k: v.contiguous() for k, v in aux.items()}


def _assert_kernel_matches_plain_f64(model, data, thetas):
    thT, ev, aux = _inputs(model, data, thetas)
    n0, p0 = dict(evidence_cuda.LAUNCHES), dict(evidence_cuda.PLAIN_CALLS)
    outk = evidence_cuda.vag(thT, ev, aux)
    assert evidence_cuda.LAUNCHES[ev.kind] == n0[ev.kind] + 1
    assert evidence_cuda.PLAIN_CALLS == p0  # a CUDA tensor never takes the plain version
    outp = evidence_cuda.loglik_vag_plain(thT, ev, aux)
    np.testing.assert_allclose(outk[0].cpu().numpy(), outp[0].cpu().numpy(), rtol=1e-9)
    np.testing.assert_allclose(outk[1].cpu().numpy(), outp[1].cpu().numpy(),
                               rtol=1e-7, atol=1e-9)
    for k in aux:
        np.testing.assert_allclose(outk[2][k].cpu().numpy(), outp[2][k].cpu().numpy(),
                                   rtol=1e-7, atol=1e-9, err_msg=k)


@pytest.fixture(scope="module", params=[2, 3], ids=["config2_se", "config3_matern52"])
def stationary(dev, request):
    return request.param, configs.ALL_CONFIGS[request.param](dtype=torch.float64, device=dev)


@pytest.mark.parametrize("C", [1, 63, 1000, 1023])
def test_stationary_kernel_matches_plain_f64(dev, stationary, C):
    config, prob = stationary
    thetas = _golden_draws(config, C, torch.float64, dev, seed=C)
    _assert_kernel_matches_plain_f64(prob.model, prob.data, thetas)


@pytest.mark.parametrize("name", ["se_noise", "warped_se_deriv", "se_noise_n48"])
def test_aux_variant_kernel_matches_plain_f64(dev, name):
    model, data = _variant(name, dev)
    assert data.Xf.shape[0] == (48 if name == "se_noise_n48" else 9)
    rng = np.random.default_rng(6)
    thetas = torch.tensor(rng.uniform(0.4, 1.2, (63, model.num_params)), device=dev)
    _assert_kernel_matches_plain_f64(model, data, thetas)


def test_stationary_kernel_matches_plain_f32(dev, stationary):
    config, prob = stationary
    thetas = _golden_draws(config, 4096, torch.float32, dev, seed=1)
    thT, ev, aux = _inputs(prob.model, prob.data, thetas)
    outk = evidence_cuda.loglik_vag_cuda(thT, ev, aux)
    outp = evidence_cuda.loglik_vag_plain(thT, ev, aux)
    assert float(((outk[0] - outp[0]).abs() / outp[0].abs().clamp(min=1.0)).max()) <= 1e-3
    gk = [outk[1]] + [outk[2][k] for k in aux]
    gp = [outp[1]] + [outp[2][k] for k in aux]
    for a, b in zip(gk, gp):
        assert float(((a - b).norm(dim=0) / b.norm(dim=0)).max()) <= 1e-2


def test_stationary_kernel_is_deterministic(dev, stationary):
    """Three calls at the main path's 4096 chains, with config 3's aux
    channels, give the same bits in ll, the gradient and every cotangent."""
    config, prob = stationary
    for dtype in (torch.float32, torch.float64):
        thT, ev, aux = _inputs(prob.model, prob.data,
                               _golden_draws(config, 4096, dtype, dev, seed=8))
        outs = [evidence_cuda.loglik_vag_cuda(thT, ev, aux) for _ in range(3)]
        flat = [[o[0], o[1], *(o[2][k] for k in aux)] for o in outs]
        for f in flat[1:]:
            assert all(torch.equal(a, b) for a, b in zip(flat[0], f))


def test_stationary_failure_contract(dev, stationary):
    """A NaN theta gives ll = -inf and zeros in the gradient and in every
    aux cotangent of that chain only."""
    config, prob = stationary
    for dtype in (torch.float32, torch.float64):
        thetas = _golden_draws(config, 6, dtype, dev, seed=2)
        thetas[1, 0] = float("nan")
        thT, ev, aux = _inputs(prob.model, prob.data, thetas)
        out = evidence_cuda.loglik_vag_cuda(thT, ev, aux)
        gs = [out[1]] + [out[2][k] for k in aux]
        assert float(out[0][1]) == -float("inf")
        assert bool(torch.isfinite(out[0][[0, 2, 3, 4, 5]]).all())
        for g in gs:
            assert bool((g[:, 1] == 0).all()) and bool(torch.isfinite(g).all())


def test_stationary_model_gradient_through_kernel(dev, stationary):
    """GPModel on the card takes the kernel alone, and autograd chains its
    aux cotangents through the mean and the warp: the theta gradient equals
    the CPU model's (plain version, autograd end to end)."""
    config, prob = stationary
    cpu = configs.ALL_CONFIGS[config](dtype=torch.float64, device="cpu")
    thetas = _golden_draws(config, 16, torch.float64, dev, seed=3)
    ct = torch.linspace(0.5, 2.0, 16, dtype=torch.float64)
    n0, p0 = dict(evidence_cuda.LAUNCHES), dict(evidence_cuda.PLAIN_CALLS)
    th = thetas.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(prob.model.log_marginal_batch(th, prob.data), th, ct.to(dev))
    kind = "se" if config == 2 else "matern52"
    assert evidence_cuda.LAUNCHES[kind] == n0[kind] + 1
    assert evidence_cuda.PLAIN_CALLS == p0
    th_c = thetas.cpu().requires_grad_(True)
    (g_c,) = torch.autograd.grad(cpu.model.log_marginal_batch(th_c, cpu.data), th_c, ct)
    np.testing.assert_allclose(g.cpu().numpy(), g_c.numpy(), rtol=1e-7, atol=1e-9)


# ---- the covariance kernel (cov_cuda) ---------------------------------------


@pytest.fixture(scope="module", params=[4, 2], ids=["config4_gibbs_tanh", "config2_se"])
def cov_problem(dev, request):
    config = request.param
    prob = configs.ALL_CONFIGS[config](dtype=torch.float64, device=dev)
    kind = "gibbs_tanh" if config == 4 else "se"
    nid = prob.data.nid
    return config, kind, prob, prob.data.Xf.reshape(-1), nid


@pytest.mark.parametrize("B", [1, 512])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_cov_kernel_matches_plain(dev, cov_problem, B, dtype):
    """f64: max |dK| / max |K| <= 1e-12; f32 <= 1e-5; the whole matrix
    exactly symmetric (each pair is evaluated once and written twice); one
    launch, no plain call."""
    from gptools_tpu_torch.ops import cov_cuda

    config, kind, _, X, nid = cov_problem
    th = _golden_draws(config, B, dtype, dev, seed=B)
    n0, p0 = dict(cov_cuda.LAUNCHES), dict(cov_cuda.PLAIN_CALLS)
    K = cov_cuda.cov_matrix_flagship(cov_problem[2].model.kernel, th, cov_problem[2].data)
    torch.cuda.synchronize()
    assert cov_cuda.LAUNCHES[kind] == n0[kind] + 1 and cov_cuda.PLAIN_CALLS == p0
    Kp = cov_cuda.cov_plain(kind, X, nid, th)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert float((K - Kp).abs().max() / Kp.abs().max()) <= tol
    assert bool((K == K.mT).all())


@pytest.mark.parametrize("config", [4, 2], ids=["config4_gibbs_tanh", "config2_se"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_cov_kernel_ragged_tiles(dev, config, dtype):
    """The tile layout at N = 1001 (999 points and two slopes: a ragged
    last tile of 41, and odd rows, which start off 16-byte boundaries),
    B = 16: within 1e-12 (f64) / 1e-5 (f32) of the plain version, exactly
    symmetric; and at N = 65 and 130 with ids outside {0, 1}, whose rows
    and columns are exact zeros."""
    from gptools_tpu_torch.ops import cov_cuda

    kind = "gibbs_tanh" if config == 4 else "se"
    prob = configs.ALL_CONFIGS[config](n_points=999, dtype=torch.float64, device=dev)
    X, nid = prob.data.Xf.reshape(-1), prob.data.nid
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    th = _golden_draws(config, 16, dtype, dev, seed=16)
    K = cov_cuda.cov_cuda(kind, X, nid, th)
    Kp = cov_cuda.cov_plain(kind, X, nid, th)
    assert K.shape == (16, 1001, 1001)
    assert float((K - Kp).abs().max() / Kp.abs().max()) <= tol
    assert bool((K == K.mT).all())
    rng = np.random.default_rng(config)
    for n in (65, 130):
        Xs = torch.tensor(np.sort(rng.uniform(0.0, 1.2, n)), device=dev)
        ids = (rng.uniform(size=n) < 0.2).astype(np.int32)
        ids[[3, n - 5]] = [-1, 2]
        ids = torch.tensor(ids, device=dev)
        K = cov_cuda.cov_cuda(kind, Xs, ids, th[:3])
        Kp = cov_cuda.cov_plain(kind, Xs, ids, th[:3])
        assert float((K - Kp).abs().max() / Kp.abs().max()) <= tol
        assert bool((K == K.mT).all())
        assert bool((K[:, [3, n - 5], :] == 0).all() and (K[:, :, [3, n - 5]] == 0).all())


def test_cov_vjp_gradient_on_card(dev, cov_problem):
    """The VJP's forward launches the kernel; its theta gradient equals the
    CPU plain builder's autograd."""
    from gptools_tpu_torch.ops import cov_cuda

    config, kind, _, X, nid = cov_problem
    th = _golden_draws(config, 8, torch.float64, dev, seed=4)
    gK = torch.randn((8,) + (X.shape[0],) * 2, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(0)).to(dev)
    fn = cov_cuda.gibbs_tanh_cov_vjp if kind == "gibbs_tanh" else cov_cuda.se_cov_vjp
    n0 = cov_cuda.LAUNCHES[kind]
    t = th.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(fn(X, nid, t), t, gK)
    assert cov_cuda.LAUNCHES[kind] == n0 + 1
    tc = th.cpu().requires_grad_(True)
    (gc,) = torch.autograd.grad(fn(X.cpu(), nid.cpu(), tc), tc, gK.cpu())
    np.testing.assert_allclose(g.cpu().numpy(), gc.numpy(), rtol=1e-10, atol=1e-12)


def test_frozen_mcmc_predictor_pallas_on_card(dev, cov_problem):
    """FrozenMCMCPredictor with cov_backend="pallas" builds its states in
    one kernel launch, calls no plain version, and answers as the fused
    backend does (1e-9)."""
    from gptools_tpu_torch.models.gp import GPModel
    from gptools_tpu_torch.models.serve import FrozenMCMCPredictor
    from gptools_tpu_torch.ops import cov_cuda

    config, kind, prob, _, _ = cov_problem
    th = _golden_draws(config, 64, torch.float64, dev, seed=9)
    xs = np.linspace(0.0, 1.2 if config == 4 else 3.0, 40)
    out = {}
    for backend in ("pallas", "fused"):
        model = GPModel(prob.model.kernel, cov_backend=backend)
        cov_cuda.reset_counts()
        pred = FrozenMCMCPredictor(model, prob.data, th, max_samples=64)
        out[backend] = [t.cpu().numpy() for n in (0, 1) for t in pred(xs, n=n)]
        if backend == "pallas":
            assert cov_cuda.LAUNCHES[kind] == 1 and sum(cov_cuda.PLAIN_CALLS.values()) == 0
    for a, b in zip(out["pallas"], out["fused"]):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)


# ---- the route past the kernel, and config 5's shapes ------------------------


def test_route_at_n62_matches_cpu(dev):
    """Config 4 at 60 points (N = 62 > N_MAX) takes the chains-minor route
    on the card (no launch), with the CPU's ll (1e-9) and gradient (1e-9 /
    1e-9)."""
    prob = configs.config4_gibbs_smc(n_points=60, dtype=torch.float64, device=dev)
    cpu = configs.config4_gibbs_smc(n_points=60, dtype=torch.float64, device="cpu")
    th = _golden_draws(4, 256, torch.float64, dev, seed=62)
    evidence_cuda.reset_counts()
    t = th.clone().requires_grad_(True)
    ll = prob.model.log_marginal_batch(t, prob.data)
    (g,) = torch.autograd.grad(ll.sum(), t)
    assert evidence_cuda.ROUTE_CALLS["chains_minor"] == 1
    assert sum(evidence_cuda.LAUNCHES.values()) == 0
    assert sum(evidence_cuda.PLAIN_CALLS.values()) == 0
    tc = th.cpu().requires_grad_(True)
    llc = cpu.model.log_marginal_batch(tc, cpu.data)
    (gc,) = torch.autograd.grad(llc.sum(), tc)
    np.testing.assert_allclose(ll.detach().cpu().numpy(), llc.detach().numpy(), rtol=1e-9)
    np.testing.assert_allclose(g.cpu().numpy(), gc.numpy(), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("B", [1, 512])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_cov_kernel_config5_shapes(dev, B, dtype):
    """gibbs_tanh at config 5's served shapes, (B, 47) on its latent points
    (47 is odd: every other float64 row starts off a 16-byte boundary),
    thetas from its golden: within 1e-12 (f64) / 1e-5 (f32) of max |K| of
    the plain version, exactly symmetric, one launch."""
    from gptools_tpu_torch.ops import cov_cuda

    prob = configs.config5_multihost_profile(dtype=torch.float64, device=dev)
    X, nid = prob.data.Xf.reshape(-1), prob.data.nid
    assert X.shape == (47,)
    th = _golden_draws(5, B, dtype, dev, seed=B)
    n0 = cov_cuda.LAUNCHES["gibbs_tanh"]
    K = cov_cuda.cov_cuda("gibbs_tanh", X, nid, th)
    torch.cuda.synchronize()
    assert cov_cuda.LAUNCHES["gibbs_tanh"] == n0 + 1
    Kp = cov_cuda.cov_plain("gibbs_tanh", X, nid, th)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert float((K - Kp).abs().max() / Kp.abs().max()) <= tol
    assert bool((K == K.mT).all())


def test_per_chain_route_on_card(dev, monkeypatch):
    """A 2-D SE model (no fused build) takes the per-chain route on the
    card, here in three chunks of 32 chains, with the CPU's ll (1e-9) and
    gradient (1e-9 / 1e-9)."""
    from gptools_tpu_torch.models import gp

    rng = np.random.default_rng(4)
    X = rng.uniform(0.0, 1.0, (30, 2))
    th = rng.uniform(0.3, 1.1, (96, 3))
    monkeypatch.setattr(gp, "_PER_CHAIN_ENTRIES", 32 * 30**2)
    out = {}
    for d in (dev, torch.device("cpu")):
        b = DatasetBuilder(2)
        b.add(X, np.sin(X.sum(1)), err_y=0.1)
        data = b.build(torch.float64, d)
        model = GPModel(SquaredExponentialKernel(num_dim=2))
        evidence_cuda.reset_counts()
        t = torch.tensor(th, device=d, requires_grad=True)
        ll = model.log_marginal_batch(t, data)
        (g,) = torch.autograd.grad(ll.sum(), t)
        assert evidence_cuda.ROUTE_CALLS["per_chain"] == 1
        assert sum(evidence_cuda.LAUNCHES.values()) == 0
        out[d.type] = (ll.detach().cpu().numpy(), g.cpu().numpy())
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-9)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-9, atol=1e-9)


def _zoo_models():
    """Phase 8c's models, as (name, model builder, dataset builder, theta
    sampler, density): Gibbs Gauss / exp / interpolated on config 4's data,
    a chain-rule SE on config 2's data, a Gibbs-Gauss model under a
    sorted-uniform prior (its density in u, through the ordered bijector),
    a 2-D grid under 2 (SE(x1) RQ(x2)) + noise and the free-nu Matern."""
    from gptools_tpu_torch.ops import kernels as K
    from gptools_tpu_torch.utils import priors as PR

    def cfg(n):
        return lambda d: configs.ALL_CONFIGS[n](dtype=torch.float64, device=d).data

    def grid(d):
        g = np.linspace(0.0, 1.0, 6)
        x1, x2 = np.meshgrid(g, g, indexing="ij")
        X = np.stack([x1.ravel(), x2.ravel()], -1)
        b = DatasetBuilder(2)
        b.add(X, np.sin(3.0 * X[:, 0]) * np.cos(2.0 * X[:, 1]), err_y=0.05)
        b.add(np.stack([np.zeros(6), g], -1), 3.0 * np.cos(2.0 * g), err_y=0.1, n=[1, 0])
        return b.build(torch.float64, d)

    def sorted_gauss():
        prior = (PR.LogNormalJointPrior([0.0], [0.75]) * PR.SortedUniformJointPrior(2, 0.01, 1.0)
                 * PR.LogNormalJointPrior([-2.3], [0.6]) * PR.UniformJointPrior([0.6], [1.1]))
        return GPModel(K.GibbsKernel1dGauss(hyperprior=prior))

    def nu_model():
        prior = (PR.LogNormalJointPrior([0.0], [0.75]) * PR.UniformJointPrior([1.05], [6.0])
                 * PR.LogNormalJointPrior([-0.5], [0.75]))
        return GPModel(K.MaternGeneralKernel(hyperprior=prior))

    def lm(m, t, data):
        return m.log_marginal_batch(t, data)

    def lpu(m, t, data):
        return m.log_posterior_u_batch(t, data)

    knots = np.linspace(0.0, 1.1, 6)
    return {
        "gibbs_gauss": (lambda: GPModel(K.GibbsKernel1dGauss()), cfg(4),
                        [(0.5, 1.5), (0.2, 0.6), (0.02, 0.1), (0.03, 0.15), (0.9, 1.05)], lm),
        "gibbs_exp": (lambda: GPModel(K.GibbsKernel1dExp()), cfg(4),
                      [(0.5, 1.5), (0.05, 0.3), (0.5, 2.0)], lm),
        "gibbs_interpolated": (lambda: GPModel(K.GibbsKernel(K.InterpolatedWarp(knots))),
                               cfg(4), [(0.5, 1.5)] + [(0.05, 0.5)] * 6, lm),
        "chain_rule_se": (lambda: GPModel(K.ChainRuleKernel(
            lambda v, t: t[..., 0] ** 2 * torch.exp(v),
            lambda x1, x2, t: -0.5 * torch.sum((x1 - x2) ** 2, -1) / t[..., 1] ** 2,
            1, ("sigma_f", "l_1"))), cfg(2), [(0.5, 1.5), (0.3, 1.0)], lm),
        "sorted_uniform_gauss": (sorted_gauss, cfg(4), [(-1.0, 1.0)] * 5, lpu),
        "grid_2d": (lambda: GPModel(
            2.0 * (K.MaskedKernel(K.SquaredExponentialKernel(), 2, [0])
                   * K.MaskedKernel(K.RationalQuadraticKernel(), 2, [1]))
            + K.DiagonalNoiseKernel(2)), grid,
            [(0.5, 1.5), (0.2, 0.6), (0.5, 1.5), (0.5, 3.0), (0.2, 0.6), (0.02, 0.2)], lm),
        "matern_general": (nu_model, cfg(2), [(0.8, 1.3), (1.2, 5.8), (0.4, 0.9)], lm),
    }


@pytest.mark.parametrize("name", ["gibbs_gauss", "gibbs_exp", "gibbs_interpolated",
                                  "chain_rule_se", "sorted_uniform_gauss", "grid_2d",
                                  "matern_general"])
def test_zoo_per_chain_route_matches_cpu(dev, name):
    """Phase 8c at C = 8: the per-chain route on the card, launching
    neither CUDA kernel and calling neither plain version, with the CPU's
    value (1e-9 relative / 1e-9 absolute, for a log likelihood near zero)
    and gradient (1e-7 / 1e-9)."""
    from gptools_tpu_torch.ops import cov_cuda

    make, data_fn, box, density = _zoo_models()[name]
    rng = np.random.default_rng(8)
    x = np.stack([rng.uniform(lo, hi, 8) for lo, hi in box], -1)
    out = {}
    for d in (dev, torch.device("cpu")):
        model, data = make(), data_fn(d)
        assert model._evidence_plan(data) is None
        evidence_cuda.reset_counts()
        cov_cuda.reset_counts()
        t = torch.tensor(x, device=d, requires_grad=True)
        v = density(model, t, data)
        (g,) = torch.autograd.grad(v.sum(), t)
        assert evidence_cuda.ROUTE_CALLS == {"chains_minor": 0, "per_chain": 1}
        assert sum(evidence_cuda.LAUNCHES.values()) + sum(cov_cuda.LAUNCHES.values()) == 0
        assert sum(evidence_cuda.PLAIN_CALLS.values()) + sum(cov_cuda.PLAIN_CALLS.values()) == 0
        out[d.type] = (v.detach().cpu().numpy(), g.cpu().numpy())
    assert np.isfinite(out["cuda"][0]).all()
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-7, atol=1e-9)


def test_per_chain_route_graph_equals_eager(dev, monkeypatch):
    """On the card the per-chain route's value and gradient replay a CUDA
    graph captured at the first call of each shape: the same numbers as
    the eager route (1e-12), a new capture for a new C, and at most
    `_PER_CHAIN_GRAPHS` graphs kept per model."""
    from gptools_tpu_torch.models import gp

    make, data_fn, box, density = _zoo_models()["gibbs_gauss"]
    model, data = make(), data_fn(dev)
    rng = np.random.default_rng(9)

    def call(C):
        x = np.stack([rng.uniform(lo, hi, C) for lo, hi in box], -1)
        t = torch.tensor(x, device=dev, requires_grad=True)
        v = density(model, t, data)
        return x, v.detach(), torch.autograd.grad(v.sum(), t)[0]

    results = [call(C) for C in (8, 8, 5, 3, 2, 7)]
    assert len(model._route_graphs) == gp._PER_CHAIN_GRAPHS
    monkeypatch.setattr(gp, "_PER_CHAIN_GRAPHS", 0)
    for x, v, g in results:
        t = torch.tensor(x, device=dev, requires_grad=True)
        ve = density(model, t, data)
        (ge,) = torch.autograd.grad(ve.sum(), t)
        torch.testing.assert_close(v, ve.detach(), rtol=1e-12, atol=0)
        torch.testing.assert_close(g, ge, rtol=1e-12, atol=1e-12 * float(ge.abs().max()))


def test_log_marginal_batch_mesh_nccl_world_one(dev, problem):
    """``log_marginal_batch(mesh=make_mesh())`` at world size 1 on NCCL: the
    rank's block is every chain, one kernel launch, gathered through NCCL;
    the same bits as the call without a mesh, value and gradient."""
    import torch.distributed as dist

    from gptools_tpu_torch.parallel import make_mesh
    from gptools_tpu_torch.parallel import mesh as pmesh

    prob, _ = problem
    th = _draws(1024, torch.float64, dev, seed=3).T.contiguous()
    mesh = make_mesh()
    try:
        assert dist.get_backend() == "nccl"
        n0, c0 = evidence_cuda.LAUNCHES["gibbs_tanh"], pmesh.COLLECTIVE_CALLS["density"]
        got = prob.model.log_marginal_batch(th, prob.data, mesh=mesh)
        assert evidence_cuda.LAUNCHES["gibbs_tanh"] == n0 + 1
        assert pmesh.COLLECTIVE_CALLS["density"] == c0 + 1
        assert torch.equal(got, prob.model.log_marginal_batch(th, prob.data))
        t = th.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(prob.model.log_marginal_batch(t, prob.data, mesh=mesh).sum(), t)
        t = th.clone().requires_grad_(True)
        (g0,) = torch.autograd.grad(prob.model.log_marginal_batch(t, prob.data).sum(), t)
        assert torch.equal(g, g0)
    finally:
        dist.destroy_process_group()
