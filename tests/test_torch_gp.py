"""The port's GPModel batch surface against the JAX package at config 4,
float64: the unconstrained log posterior and its gradient (ll rtol 1e-9;
grad rtol 1e-7, atol 1e-9), 10 leapfrog steps over the whitened density
(1e-9), and the free/fixed parameter plumbing (1e-12)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptools_tpu import configs as jconfigs
from gptools_tpu.infer import hmc as jhmc
from gptools_tpu.models.gp import GPModel as JGPModel
from gptools_tpu.ops.kernels import GibbsKernel1dTanh as JGibbs
from gptools_tpu_torch import convert
from gptools_tpu_torch.infer import hmc as thmc
from gptools_tpu_torch.infer.chees import _value_and_grad
from gptools_tpu_torch.models.gp import GPModel as TGPModel
from gptools_tpu_torch.ops.kernels import GibbsKernel1dTanh as TGibbs

torch.set_num_threads(1)

GOLD_MEAN = np.array([0.6053, 1.0609, 0.2892, 0.0413, 0.9208])


@pytest.fixture(scope="module")
def setup():
    prob = jconfigs.config4_gibbs_smc()
    jmodel = JGPModel(prob.model.kernel, evidence_backend="xla")
    tmodel = convert.model_from_jax(prob.model)
    tdata = convert.dataset_from_jax(prob.data, torch.float64, "cpu")
    u_gold = np.asarray(jmodel.u_of_theta(jnp.asarray(GOLD_MEAN)))
    rng = np.random.default_rng(21)
    # whitening moments as the pipeline forms them: mu, lower Cholesky C
    A = 0.3 * rng.standard_normal((5, 5))
    C = np.linalg.cholesky(A @ A.T + 0.05 * np.eye(5))
    mu = u_gold

    @jax.jit
    def vg(vs, mu_, C_):
        lp, pull = jax.vjp(
            lambda v: jmodel.log_posterior_u_batch(v @ C_.T + mu_, prob.data), vs
        )
        return lp, pull(jnp.ones_like(lp))[0]

    return dict(jmodel=jmodel, tmodel=tmodel, tdata=tdata, mu=mu, C=C,
                vg=vg, rng=rng)


def test_log_posterior_u_batch_matches_jax(setup):
    s = setup
    us = s["mu"] + 0.4 * s["rng"].standard_normal((12, 5))
    us[0, 4] = 9.0  # x0 deep in the sigmoid's tail
    lp_j, g_j = s["vg"](jnp.asarray(us), jnp.zeros(5), jnp.eye(5))
    t = torch.tensor(us, requires_grad=True)
    lp = s["tmodel"].log_posterior_u_batch(t, s["tdata"])
    (g,) = torch.autograd.grad(lp.sum(), t)
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(lp_j), rtol=1e-9)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=1e-7, atol=1e-9)


def test_ten_leapfrog_steps_match_jax(setup):
    s = setup
    mu, C = s["mu"], s["C"]
    rng = np.random.default_rng(5)
    q0 = 0.5 * rng.standard_normal((8, 5))
    p0 = rng.standard_normal((8, 5))
    inv_mass = np.linspace(0.8, 1.2, 5)
    eps = 0.05

    def vg_j(q):
        return s["vg"](q, jnp.asarray(mu), jnp.asarray(C))

    Ct, mut = torch.tensor(C), torch.tensor(mu)
    vg_t = _value_and_grad(
        lambda vs: s["tmodel"].log_posterior_u_batch(vs @ Ct.T + mut, s["tdata"])
    )
    qj, pj = jnp.asarray(q0), jnp.asarray(p0)
    qt, pt = torch.tensor(q0), torch.tensor(p0)
    gj = gt = None
    for _ in range(10):
        qj, pj, lj, gj = jhmc.leapfrog(vg_j, qj, pj, eps, jnp.asarray(inv_mass), grad=gj)
        qt, pt, lt, gt = thmc.leapfrog(vg_t, qt, pt, eps, torch.tensor(inv_mass), grad=gt)
    for a, b in ((qt, qj), (pt, pj), (lt, lj), (gt, gj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-9)


def test_free_fixed_plumbing_matches_jax(rng):
    """A model with x0 fixed: embed/extract, u <-> theta, log prior."""
    from gptools_tpu.utils import priors as jp
    from gptools_tpu_torch.utils import priors as tp

    def prior(m):
        return (m.LogNormalJointPrior([0.0, -1.0, -2.3, -2.3], [0.75, 0.6, 0.6, 0.6])
                * m.UniformJointPrior([0.6], [1.1]))

    kw = dict(fixed_params=[False, False, False, False, True],
              initial_params=[0.5, 1.0, 0.3, 0.04, 0.9])
    jm = JGPModel(JGibbs(hyperprior=prior(jp), **kw))
    tm = TGPModel(TGibbs(hyperprior=prior(tp), **kw))
    assert tm.free_idx == jm.free_idx and tm.num_free_params == 4
    u = rng.standard_normal((6, 4))
    th_j = np.asarray(jax.vmap(jm.theta_of_u)(jnp.asarray(u)))
    th_t = tm.theta_of_u(torch.tensor(u)).numpy()
    np.testing.assert_allclose(th_t, th_j, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        tm.u_of_theta(torch.tensor(th_j)).numpy(),
        np.asarray(jax.vmap(jm.u_of_theta)(jnp.asarray(th_j))), rtol=1e-12, atol=1e-12,
    )
    free = GOLD_MEAN[:4] + 0.01 * rng.standard_normal((3, 4))
    np.testing.assert_allclose(
        tm.embed_free(torch.tensor(free)).numpy(),
        np.asarray(jax.vmap(jm.embed_free)(jnp.asarray(free))), rtol=0, atol=0,
    )
    np.testing.assert_allclose(
        tm.extract_free(torch.tensor(th_j)).numpy(), th_j[:, :4], rtol=0, atol=0
    )
    np.testing.assert_allclose(
        tm.log_prior(torch.tensor(th_j)).numpy(),
        np.asarray(jax.vmap(jm.log_prior)(jnp.asarray(th_j))), rtol=1e-12,
    )


def test_unported_model_parts_raise():
    with pytest.raises(NotImplementedError, match="item 9"):
        TGPModel(TGibbs(), noise_kernel=object())
