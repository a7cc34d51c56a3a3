"""The port's HMC module (`infer.hmc`) and ChEES driver against the JAX
package, float64 on the CPU.

- Welford moments and variance against `hmc.welford_*` (1e-12), pooled
  and per rung; `warmup_schedule` equal for every ``num_warmup`` tested;
- one fixed-length HMC proposal on config 2's density with the momentum,
  the jittered steps and the acceptance uniforms given: the same positions
  and log densities as the reference's `hmc.leapfrog` loop over
  ``model.log_posterior_u`` with its Metropolis test (1e-9);
- windowed HMC and ChEES alone recover a correlated 2-D Gaussian's means,
  variances and covariance within 4 Monte Carlo standard errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptools_tpu import configs as jconfigs
from gptools_tpu.infer import hmc as jhmc
from gptools_tpu_torch import convert
from gptools_tpu_torch.infer import chees, hmc, model_logp
from gptools_tpu_torch.utils.diagnostics import ess_and_rhat

torch.set_num_threads(1)

MEAN = np.array([1.0, -2.0])
COV = np.array([[1.0, 0.8], [0.8, 1.0]])


def gauss_logp(u):
    prec = torch.tensor(np.linalg.inv(COV), dtype=u.dtype)
    d = u - torch.tensor(MEAN, dtype=u.dtype)
    return -0.5 * ((d @ prec) * d).sum(-1)


def check_gaussian(u, z_max=4.0):
    """Means, variances and the covariance of (chains, samples, 2) draws
    within ``z_max`` Monte Carlo standard errors (ESS from the draws)."""
    ess, rhat = ess_and_rhat(u)
    ess = np.asarray(ess, dtype=float)
    assert float(np.max(np.asarray(rhat, dtype=float))) <= 1.1
    flat = u.reshape(-1, 2).numpy()
    m = flat.mean(0)
    c = np.cov(flat.T)
    sd = np.sqrt(np.diag(COV))
    z_mean = (m - MEAN) / (sd / np.sqrt(ess))
    z_var = (np.diag(c) - np.diag(COV)) / (np.diag(COV) * np.sqrt(2.0 / ess))
    rho = COV[0, 1] / (sd[0] * sd[1])
    se_cov = sd[0] * sd[1] * np.sqrt((1.0 + rho**2) / ess.min())
    z_cov = (c[0, 1] - COV[0, 1]) / se_cov
    assert np.all(np.abs(z_mean) <= z_max), z_mean
    assert np.all(np.abs(z_var) <= z_max), z_var
    assert abs(z_cov) <= z_max, z_cov


def test_welford_matches_jax(rng):
    xs = rng.standard_normal((12, 50, 3)) * np.array([1.0, 2.0, 0.5]) + 3.0
    st_t = hmc.welford_init(3, torch.float64)
    st_j = jhmc.welford_init(3, jnp.float64)
    for chunk in xs:
        st_t = hmc.welford_update_batch(st_t, torch.tensor(chunk))
        st_j = jhmc.welford_update_batch(st_j, jnp.asarray(chunk))
    for f in st_t._fields:
        np.testing.assert_allclose(getattr(st_t, f).numpy(), np.asarray(getattr(st_j, f)),
                                   rtol=1e-12, atol=1e-12)
    for reg in (True, False):
        np.testing.assert_allclose(hmc.welford_variance(st_t, reg).numpy(),
                                   np.asarray(jhmc.welford_variance(st_j, reg)), rtol=1e-12)
    # per rung (parallel tempering's leading axis) = the reference vmapped
    T = 4
    st_t = hmc.welford_init(3, torch.float64, lead=(T,))
    st_j = jax.tree_util.tree_map(lambda a: jnp.stack([a] * T), jhmc.welford_init(3, jnp.float64))
    for chunk in xs[:6]:
        stack = np.stack([chunk * (t + 1) for t in range(T)])
        st_t = hmc.welford_update_batch(st_t, torch.tensor(stack))
        st_j = jax.vmap(jhmc.welford_update_batch)(st_j, jnp.asarray(stack))
    np.testing.assert_allclose(hmc.welford_variance(st_t).numpy(),
                               np.asarray(jax.vmap(jhmc.welford_variance)(st_j)), rtol=1e-12)


@pytest.mark.parametrize("num_warmup", [0, 10, 20, 21, 150, 500, 1000])
def test_warmup_schedule_matches_jax(num_warmup):
    assert hmc.warmup_schedule(num_warmup) == jhmc.warmup_schedule(num_warmup)


def test_hmc_proposal_matches_jax_on_config2(rng):
    jp = jconfigs.config2_se_deriv_nuts()
    model = convert.model_from_jax(jp.model)
    data = convert.dataset_from_jax(jp.data, torch.float64, "cpu")
    C, P, num_steps, eps, jitter = 4, 2, 8, 0.15, 0.2
    inv_mass = np.array([0.8, 1.3])
    q0 = rng.normal(0.0, 0.3, (C, P))
    p0 = rng.standard_normal((C, P)) / np.sqrt(inv_mass)
    eps_c = eps * (1.0 + jitter * (2.0 * rng.uniform(size=C) - 1.0))
    log_u = np.log(rng.uniform(size=C))
    log_u[0], log_u[1] = 0.0, -np.inf  # chain 0 rejects, chain 1 accepts

    vg_t = hmc.value_and_grad(model_logp(model, data))
    lp0, g0 = vg_t(torch.tensor(q0))
    q_t, lp_t, g_t, stats = hmc._hmc_proposal(
        vg_t, torch.tensor(q0), lp0, g0, torch.tensor(p0), torch.tensor(eps_c)[:, None],
        torch.tensor(inv_mass), num_steps, torch.tensor(log_u))

    vg_j = jax.jit(jax.vmap(jax.value_and_grad(lambda u: jp.model.log_posterior_u(u, jp.data))))
    lpj0, gj = vg_j(jnp.asarray(q0))
    q, p, lp, g = jnp.asarray(q0), jnp.asarray(p0), lpj0, gj
    for _ in range(num_steps):
        q, p, lp, g = jhmc.leapfrog(vg_j, q, p, jnp.asarray(eps_c)[:, None],
                                    jnp.asarray(inv_mass), grad=g)
    kin = jax.vmap(lambda p_: jhmc.kinetic(p_, jnp.asarray(inv_mass)))
    h0, h1 = -lpj0 + kin(jnp.asarray(p0)), -lp + kin(p)
    log_acc = jnp.minimum(0.0, h0 - h1)
    log_acc = jnp.where(jnp.isnan(log_acc), -jnp.inf, log_acc)
    accept = jnp.asarray(log_u) < log_acc
    q_j = jnp.where(accept[:, None], q, jnp.asarray(q0))
    lp_j = jnp.where(accept, lp, lpj0)

    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-9)
    np.testing.assert_allclose(stats["accept_prob"].numpy(), np.asarray(jnp.exp(log_acc)),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(stats["diverged"].numpy(), np.asarray((h1 - h0) > 1000.0))
    assert bool(accept.any()) and not bool(accept.all())
    np.testing.assert_allclose(hmc.kinetic(torch.tensor(p0), torch.tensor(inv_mass)).numpy(),
                               np.asarray(kin(jnp.asarray(p0))), rtol=1e-12)


def test_hmc_recovers_gaussian():
    gen = torch.Generator().manual_seed(3)
    u0 = torch.randn((8, 2), generator=gen, dtype=torch.float64)
    res = hmc.sample(gauss_logp, u0, gen, num_warmup=300, num_samples=600, num_steps=16)
    assert res.u.shape == (8, 600, 2) and int(res.diagnostics["divergences"]) == 0
    assert float(res.diagnostics["mean_accept"]) > 0.5
    check_gaussian(res.u)


def test_chees_alone_recovers_gaussian():
    gen = torch.Generator().manual_seed(4)
    u0 = torch.randn((16, 2), generator=gen, dtype=torch.float64)
    res = chees.sample(gauss_logp, u0, gen, num_warmup=300, num_samples=600)
    assert res.u.shape == (16, 600, 2) and int(res.diagnostics["divergences"]) == 0
    check_gaussian(res.u)
