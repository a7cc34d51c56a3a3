"""The port's parallel tempering (`infer.pt`) and ADVI (`infer.advi`)
against the JAX package, float64 on the CPU.

- `geometric_ladder` equal to the reference's (1e-12);
- `_swap_step` with the reference's uniforms: the same permuted states,
  log-likelihood table and swap fractions, both parities, and every
  chain's multiset of states across the rungs conserved;
- the cold rung of replica-exchange HMC recovers a correlated 2-D
  Gaussian's moments within 4 Monte Carlo standard errors (flat prior, so
  rung t targets N(mean, cov / beta_t));
- ADVI's negative ELBO and its gradient at fixed (mu, log sigma,
  off-diagonal, draws) on config 2's density equal the reference's
  expression (1e-9), mean-field and full-rank; that expression equals the
  first ELBO of the reference's own `advi.fit` (the draws recovered from
  its key);
- full-rank ADVI recovers the Gaussian's moments within 4 standard errors
  of its draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptools_tpu import configs as jconfigs
from gptools_tpu.infer import advi as jadvi
from gptools_tpu.infer import pt as jpt
from gptools_tpu_torch import convert
from gptools_tpu_torch.infer import advi, model_logp, pt
from gptools_tpu_torch.utils.diagnostics import ess_and_rhat

torch.set_num_threads(1)

MEAN = np.array([1.0, -2.0])
COV = np.array([[1.0, 0.8], [0.8, 1.0]])


def gauss_logp(u):
    prec = torch.tensor(np.linalg.inv(COV), dtype=u.dtype)
    d = u - torch.tensor(MEAN, dtype=u.dtype)
    return -0.5 * ((d @ prec) * d).sum(-1)


def check_gaussian(flat, ess):
    """Means, variances and covariance of (n, 2) draws within 4 standard
    errors for the effective sample sizes ``ess`` (2,)."""
    m, c = flat.mean(0), np.cov(flat.T)
    sd = np.sqrt(np.diag(COV))
    assert np.all(np.abs(m - MEAN) <= 4.0 * sd / np.sqrt(ess)), (m, ess)
    assert np.all(np.abs(np.diag(c) - np.diag(COV))
                  <= 4.0 * np.diag(COV) * np.sqrt(2.0 / ess)), (c, ess)
    se_cov = sd[0] * sd[1] * np.sqrt(1.64 / np.min(ess))
    assert abs(c[0, 1] - COV[0, 1]) <= 4.0 * se_cov, (c, ess)


@pytest.mark.parametrize("num_temps,beta_min", [(1, 0.1), (2, 0.3), (4, 0.1), (8, 0.05)])
def test_geometric_ladder_matches_jax(num_temps, beta_min):
    np.testing.assert_allclose(
        pt.geometric_ladder(num_temps, beta_min, torch.float64).numpy(),
        np.asarray(jpt.geometric_ladder(num_temps, beta_min, jnp.float64)), rtol=1e-12)


@pytest.mark.parametrize("parity", [0, 1])
def test_swap_step_matches_jax(rng, parity):
    T, C, P = 5, 64, 3
    betas = np.asarray(jpt.geometric_ladder(T, 0.2, jnp.float64))
    u = rng.standard_normal((T, C, P))
    lp = rng.standard_normal((T, C))
    ll = rng.normal(0.0, 2.0, (T, C))
    key = jax.random.PRNGKey(11 + parity)
    (ju, jlp), jll, jfrac = jpt._swap_step(
        [jnp.asarray(u), jnp.asarray(lp)], jnp.asarray(ll), jnp.asarray(betas), key, parity)
    unif = jax.random.uniform(key, (T - 1, C), jnp.float64)
    (tu, tlp), tll, tfrac = pt._swap_step(
        [torch.tensor(u), torch.tensor(lp)], torch.tensor(ll), torch.tensor(betas),
        torch.tensor(np.asarray(unif)), parity)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tlp.numpy(), np.asarray(jlp))
    np.testing.assert_array_equal(tll.numpy(), np.asarray(jll))
    np.testing.assert_allclose(tfrac.numpy(), np.asarray(jfrac), rtol=1e-12)
    assert 0.0 < float(tfrac.sum())
    # each chain's states are permuted across the rungs, none lost or copied
    np.testing.assert_array_equal(np.sort(tll.numpy(), 0), np.sort(ll, 0))
    np.testing.assert_array_equal(np.sort(tu.numpy()[..., 0], 0), np.sort(u[..., 0], 0))


def test_pt_cold_rung_recovers_gaussian():
    T, C = 4, 16
    gen = torch.Generator().manual_seed(6)
    betas = pt.geometric_ladder(T, 0.1, torch.float64)
    u0 = 2.0 * torch.randn((T, C, 2), generator=gen, dtype=torch.float64)
    res = pt.sample_tempered(gauss_logp, lambda u: torch.zeros_like(u[:, 0]), u0, gen, betas,
                             num_samples=400, num_warmup=200, num_steps=8)
    d = res.diagnostics
    assert res.u.shape == (C, 400, 2) and res.log_prob.shape == (C, 400)
    assert d["step_size"].shape == (T,) and d["swap_accept"].shape == (T - 1,)
    assert bool((d["swap_accept"] > 0.1).all()) and int(d["divergences"]) == 0
    np.testing.assert_allclose(res.log_prob.numpy(), gauss_logp(res.u.reshape(-1, 2))
                               .reshape(C, 400).numpy(), rtol=1e-10, atol=1e-12)
    ess, rhat = ess_and_rhat(res.u)
    assert float(np.max(np.asarray(rhat, dtype=float))) <= 1.1
    check_gaussian(res.u.reshape(-1, 2).numpy(), np.asarray(ess, dtype=float))


def _jax_neg_elbo(logp, params, z, full_rank):
    """The reference's ELBO expression (`gptools_tpu.infer.advi._fit_program`
    :: neg_elbo) with the draws ``z`` given."""
    nf = params["mu"].shape[0]
    if full_rank:
        tril_r, tril_c = jnp.tril_indices(nf, k=-1)
        L = jnp.diag(jnp.exp(params["log_sigma"])).at[tril_r, tril_c].set(params["off"])
        us = params["mu"] + z @ L.T
    else:
        us = params["mu"] + jnp.exp(params["log_sigma"]) * z
    lps = jax.vmap(logp)(us)
    lps = jnp.where(jnp.isfinite(lps), lps, -1e30)
    entropy = jnp.sum(params["log_sigma"]) + 0.5 * nf * (1.0 + jnp.log(2.0 * jnp.pi))
    return -(jnp.mean(lps) + entropy)


@pytest.fixture(scope="module")
def config2():
    jp = jconfigs.config2_se_deriv_nuts()
    model = convert.model_from_jax(jp.model)
    data = convert.dataset_from_jax(jp.data, torch.float64, "cpu")
    return jp, model, data, lambda u: jp.model.log_posterior_u(u, jp.data)


@pytest.mark.parametrize("full_rank", [False, True])
def test_neg_elbo_and_gradient_match_jax(config2, rng, full_rank):
    _, model, data, jlogp = config2
    S, P = 16, 2
    mu = np.array([0.2, -0.4])
    log_sigma = np.array([-1.5, -2.2])
    off = np.array([0.07])
    z = rng.standard_normal((S, P))
    params = {"mu": jnp.asarray(mu), "log_sigma": jnp.asarray(log_sigma)}
    if full_rank:
        params["off"] = jnp.asarray(off)
    val_j, grad_j = jax.jit(jax.value_and_grad(
        lambda p: _jax_neg_elbo(jlogp, p, jnp.asarray(z), full_rank)))(params)
    tp = [torch.tensor(mu, requires_grad=True), torch.tensor(log_sigma, requires_grad=True)]
    if full_rank:
        tp.append(torch.tensor(off, requires_grad=True))
    val_t = advi.neg_elbo(model_logp(model, data), tp[0], tp[1],
                          tp[2] if full_rank else None, torch.tensor(z))
    grads = torch.autograd.grad(val_t, tp)
    np.testing.assert_allclose(float(val_t.detach()), float(val_j), rtol=1e-9)
    for name, g in zip(("mu", "log_sigma", "off"), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(grad_j[name]), rtol=1e-9, atol=1e-12)


def test_neg_elbo_expression_is_the_references(config2):
    """The copy above against the reference's own first ELBO: `advi.fit`
    with one step draws z from ``split(key, 1)[0]`` at the initial
    parameters (mean at the model's initial point, log-scales -2)."""
    jp, model, data, jlogp = config2
    key = jax.random.PRNGKey(3)
    res = jadvi.fit(jp.model, jp.data, key, num_steps=1, num_elbo_samples=16)
    u0 = jp.model.u_of_theta(jnp.asarray(jp.model.initial_params))
    z = jax.random.normal(jax.random.split(key, 1)[0], (16, u0.shape[0]), u0.dtype)
    tu0 = model.u_of_theta(torch.tensor(model.initial_params, dtype=torch.float64))
    val_t = advi.neg_elbo(model_logp(model, data), tu0, torch.full((2,), -2.0,
                          dtype=torch.float64), None, torch.tensor(np.asarray(z)))
    np.testing.assert_allclose(-float(val_t), float(res.elbo_trace[0]), rtol=1e-9)


def test_full_rank_advi_recovers_gaussian():
    gen = torch.Generator().manual_seed(8)
    res = advi.fit_logp(gauss_logp, torch.zeros(2, dtype=torch.float64), gen, num_steps=1500,
                        num_elbo_samples=16, learning_rate=0.05, full_rank=True)
    assert bool(torch.isfinite(res.elbo_trace).all())
    assert float(res.elbo_trace[-100:].mean()) > float(res.elbo_trace[:100].mean())
    n = 4000
    z = torch.randn((n, 2), generator=gen, dtype=torch.float64)
    us = res.mu + z @ advi._factor(res.log_sigma, res.chol_offdiag).T
    check_gaussian(us.numpy(), np.full(2, float(n)))
