"""The port's `GaussianProcess` wrapper, its serving predictors and
`run_sampler`, against the JAX package's wrapper on the same numpy data,
float64.

- `predict_MCMC`, `compute_from_MCMC` (``thetas=``), `FrozenPredictor` and
  `FrozenMCMCPredictor` (a ragged query size, ``max_samples`` below the
  draws): 1e-9 (atol 1e-12); the port's predictors on
  ``cov_backend="pallas"`` (the covariance kernel's plain version on the
  CPU);
- `update_hyperparameters`, `compute_K_L_alpha_ll`, `remove_outliers`,
  `compute_ll_matrix` and the live bounds views;
- `draw_sample`: the two packages draw different normals, so the Cholesky
  draws are held statistically (20,000 draws: mean and covariance within 5
  standard errors of `predict`'s) and the ``eig`` path's sign gauge
  directly (the draws' linear map from the normals, recovered exactly);
- a short ``smc+chees`` run through `sample_hyperparameter_posterior` on
  config 4 (128 chains): shapes and finite values, then the predictors on
  its draws.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptools_tpu.models.gp import GaussianProcess as JGP
from gptools_tpu.models.serve import FrozenMCMCPredictor as JFrozenMCMC
from gptools_tpu.models.serve import FrozenPredictor as JFrozen
from gptools_tpu.ops import kernels as jk
from gptools_tpu.utils import priors as jp
from gptools_tpu_torch import configs
from gptools_tpu_torch.infer import run_sampler
from gptools_tpu_torch.models.gp import GaussianProcess as TGP
from gptools_tpu_torch.models.gp import GPModel
from gptools_tpu_torch.models.serve import FrozenMCMCPredictor, FrozenPredictor
from gptools_tpu_torch.ops import cov_cuda
from gptools_tpu_torch.ops import kernels as tk
from gptools_tpu_torch.utils import priors as tp

torch.set_num_threads(1)

TOL = dict(rtol=1e-9, atol=1e-12)
THETA = np.array([1.1, 0.55])


def _data(outlier=False):
    rng = np.random.default_rng(4)
    X = np.linspace(0.0, 3.0, 7)
    y = np.sin(1.5 * X) + 0.1 * rng.standard_normal(7)
    if outlier:
        y[3] += 3.0
    return X, y


def _pair(outlier=False, fixed=False):
    """The same SE GP (7 values, a slope at x = 0) in both packages; the
    port's on the CPU with ``cov_backend="pallas"``."""
    kw = dict(fixed_params=[True, False]) if fixed else {}
    jgp = JGP(jk.SquaredExponentialKernel(
        hyperprior=jp.LogNormalJointPrior([0.0, -0.7], [0.8, 0.8]), **kw))
    tgp = TGP(tk.SquaredExponentialKernel(
        hyperprior=tp.LogNormalJointPrior([0.0, -0.7], [0.8, 0.8]), **kw),
        cov_backend="pallas", device="cpu")
    X, y = _data(outlier)
    for gp in (jgp, tgp):
        gp.add_data(X, y, err_y=0.1)
        gp.add_data(0.0, 1.5, err_y=0.05, n=1)
        gp.update_hyperparameters(THETA)
    return jgp, tgp


def _thetas(S=6):
    rng = np.random.default_rng(8)
    return THETA * np.exp(0.1 * rng.standard_normal((S, 2)))


@pytest.fixture(scope="module")
def pair():
    return _pair()


XS = np.linspace(-0.2, 3.2, 37)  # a ragged query size against bucket 16


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


def test_wrapper_state_matches_jax(pair):
    jgp, tgp = pair
    _close(tgp.update_hyperparameters(THETA * 1.1), jgp.update_hyperparameters(THETA * 1.1))
    for gp in (jgp, tgp):
        gp.update_hyperparameters(THETA)
    _close(tgp.ll, jgp.ll)
    _close(tgp.L, jgp.L)
    _close(tgp.alpha, jgp.alpha)
    _close(tgp.K, jgp.K)
    np.testing.assert_array_equal(tgp.n, jgp.n)
    m_t, s_t = tgp.predict(XS, n=1)
    m_j, s_j = jgp.predict(XS, n=1)
    _close(m_t, m_j)
    _close(s_t, s_j)


def test_predict_mcmc_and_compute_from_mcmc(pair):
    """The reference's methods are pure in the thetas, so they are jitted
    here (its eager vmap compiles op by op)."""
    import jax

    jgp, tgp = pair
    th = _thetas()
    m_t, s_t = tgp.predict_MCMC(XS, thetas=th)
    m_j, s_j = jax.jit(lambda t: jgp.predict_MCMC(XS, thetas=t))(th)
    _close(m_t, m_j)
    _close(s_t, s_j)
    m_t, c_t = tgp.predict(XS[::4], n=1, use_MCMC=True, thetas=th, return_cov=True, thin=2)
    m_j, c_j = jax.jit(lambda t: jgp.predict(XS[::4], n=1, use_MCMC=True, thetas=t,
                                             return_cov=True, thin=2))(th)
    _close(m_t, m_j)
    _close(c_t, c_j)
    ms_t, ss_t = tgp.compute_from_MCMC(XS, thetas=th, n=1)
    ms_j, ss_j = jax.jit(lambda t: jgp.compute_from_MCMC(XS, thetas=t, n=1))(th)
    assert ms_t.shape == (6, XS.shape[0])
    _close(ms_t, ms_j)
    _close(ss_t, ss_j)


def test_frozen_predictors_match_jax(pair):
    jgp, tgp = pair
    fj = JFrozen(jgp.model, jgp.data, jnp.asarray(THETA), bucket=16)
    ft = tgp.freeze_predictor(bucket=16)
    for n in (0, 1):
        for a, b in zip(ft(XS, n=n), fj(XS, n=n)):
            assert a.shape == (37,)
            _close(a, b)
    _close(ft(XS, return_std=False), fj(XS, return_std=False))

    th = _thetas(6)
    n0 = cov_cuda.PLAIN_CALLS["se"]
    mj = JFrozenMCMC(jgp.model, jgp.data, jnp.asarray(th), max_samples=4, bucket=16)
    mt = tgp.freeze_mcmc_predictor(thetas=th, max_samples=4)
    assert cov_cuda.PLAIN_CALLS["se"] == n0 + 1  # one batched build of the 4 states
    assert isinstance(mt, FrozenMCMCPredictor) and mt.thetas.shape == (4, 2)
    _close(mt.thetas, mj.thetas)
    for n in (0, 1):
        for a, b in zip(mt(XS, n=n), mj(XS, n=n)):
            _close(a, b)


def test_remove_outliers_matches_jax():
    jgp, tgp = _pair(outlier=True)
    removed = tgp.remove_outliers(thresh=3.0)
    assert removed == jgp.remove_outliers(thresh=3.0) and removed >= 1
    _close(tgp.X, jgp.X)
    _close(tgp.y, jgp.y)
    np.testing.assert_array_equal(tgp.n, jgp.n)
    _close(tgp.ll, jgp.ll)


def test_compute_ll_matrix_and_bounds_views():
    jgp, tgp = _pair(fixed=True)
    assert tgp.free_param_names == jgp.free_param_names == ("k.l_1",)
    import jax

    vals_t, axes_t = tgp.compute_ll_matrix([(0.3, 0.9)], 7)
    vals_j, axes_j = jax.jit(lambda: jgp.compute_ll_matrix([(0.3, 0.9)], 7))()
    _close(vals_t, vals_j)
    _close(axes_t[0], axes_j[0])
    for gp in (jgp, tgp):  # the fixed entry goes back to its initial value
        gp.free_params = [0.7]
    _close(tgp.params, jgp.params)
    _close(tgp.free_params, [0.7])
    # live views: writes go through to the kernel's own list
    assert list(tgp.param_bounds) == list(jgp.param_bounds)
    tgp.free_param_bounds[0] = (0.1, 2.0)
    assert tgp.k.param_bounds[1] == (0.1, 2.0) and tgp.param_bounds[1] == (0.1, 2.0)
    tgp.param_bounds[0] = (0.5, 1.5)
    assert tgp.k.param_bounds[0] == (0.5, 1.5) and len(tgp.free_param_bounds) == 1


def test_draw_sample_cholesky_statistics(pair):
    _, tgp = pair
    xs = np.linspace(0.2, 2.8, 6)
    mean, cov = tgp.predict(xs, n=1, return_cov=True)
    g = torch.Generator().manual_seed(3)
    draws = tgp.draw_sample(xs, num_samp=20000, n=1, generator=g)
    assert draws.shape == (6, 20000)
    m = draws.mean(1)
    c = torch.cov(draws)
    sd = torch.sqrt(torch.diagonal(cov))
    assert bool(((m - mean).abs() <= 5.0 * sd / np.sqrt(20000)).all())
    se_c = torch.sqrt((torch.outer(sd**2, sd**2) + cov**2) / 20000)
    assert bool(((c - cov).abs() <= 5.0 * se_c).all())


@pytest.mark.parametrize("num_eig", [None, 4])
def test_draw_sample_eig_gauge_matches_jax(pair, num_eig):
    """With as many draws as modes, the draws determine their linear map
    A = V sqrt(w) from the normals z exactly: A = (draws - mean) z^{-1}.
    The sign gauge makes A unique, so the two packages' A agree."""
    import jax

    jgp, tgp = pair
    xs = np.linspace(0.2, 2.8, 6)
    k = 6 if num_eig is None else num_eig
    key = jax.random.PRNGKey(5)
    dj = np.asarray(jgp.draw_sample(xs, num_samp=k, key=key, method="eig",
                                    num_eig=num_eig, modify_sign=True))
    zj = np.asarray(jax.random.normal(key, (6, k), dtype=jnp.float64))[:k]
    dt = tgp.draw_sample(xs, num_samp=k, generator=torch.Generator().manual_seed(5),
                         method="eig", num_eig=num_eig, modify_sign=True).numpy()
    zt = torch.randn((6, k), generator=torch.Generator().manual_seed(5),
                     dtype=torch.float64).numpy()[:k]
    mean = np.asarray(jgp.predict(xs, return_std=False))
    A_j = (dj - mean[:, None]) @ np.linalg.inv(zj)
    A_t = (dt - mean[:, None]) @ np.linalg.inv(zt)
    np.testing.assert_allclose(A_t, A_j, rtol=1e-6, atol=1e-9)


def test_sample_posterior_smc_chees_then_serve():
    prob = configs.config4_gibbs_smc(device="cpu")
    data = prob.data
    gp = TGP(prob.model.kernel, cov_backend="pallas", device="cpu")
    nid = data.nid.numpy()
    gp.add_data(data.Xf.numpy()[nid == 0, 0], data.y.numpy()[nid == 0],
                err_y=data.err_y.numpy()[nid == 0])
    gp.add_data(data.Xf.numpy()[nid == 1, 0], data.y.numpy()[nid == 1],
                err_y=data.err_y.numpy()[nid == 1], n=1)
    res = gp.sample_hyperparameter_posterior(
        nsamp=20, burn=20, num_chains=128, sampler="smc+chees", thin=2,
        generator=torch.Generator().manual_seed(0), num_particles=256,
    )
    assert res.thetas.shape == (128, 10, 5) and res.u.shape == (128, 10, 5)
    assert bool(torch.isfinite(res.thetas).all()) and bool(torch.isfinite(res.log_prob).all())
    xs = np.linspace(0.0, 1.2, 25)
    mean, std = gp.freeze_mcmc_predictor(max_samples=64)(xs)
    assert mean.shape == std.shape == (25,)
    assert bool(torch.isfinite(mean).all()) and bool((std > 0).all())
    m2, s2 = gp.predict_MCMC(xs, thetas=gp.freeze_mcmc_predictor(max_samples=64).thetas)
    _close(m2, mean)
    _close(s2, std)


def test_unported_routes_raise():
    model = GPModel(tk.SquaredExponentialKernel())
    data = configs.config2_se_deriv_nuts(n_points=6, device="cpu").data
    for sampler in ("hmc", "pt"):
        with pytest.raises(NotImplementedError, match="item 15"):
            run_sampler(model, data, torch.Generator(), sampler=sampler, metrics=object())
    with pytest.raises(ValueError, match="unknown sampler"):
        run_sampler(model, None, torch.Generator(), sampler="emcee")
    with pytest.raises(ValueError, match="evidence_backend"):
        GPModel(tk.SquaredExponentialKernel(), evidence_backend="pallas")
    with pytest.raises(ValueError, match="cov_backend"):
        GPModel(tk.SquaredExponentialKernel(), cov_backend="xla")
    assert isinstance(FrozenPredictor, type)
