"""The port's SE and Matern-5/2 kinds, the BetaWarp and the mean functions
against the JAX package, float64.

- fused builders (`se_`, `matern52_`, `warped_cov_fused_soa_sym`),
  `special.betainc_dd` (value and gradient in a, b and x),
  `beta_warp_pdf`, `NormalJointPrior`, `IdentityBijector` and
  `mean_vector` at orders 0 and 1: 1e-12;
- configs 2 and 3, built by the port and carried across from the JAX
  package: the same data and parameters, `log_marginal_batch` with its
  theta gradient against JAX's ``evidence_backend="xla"`` path (ll rtol
  1e-9, gradient rtol 1e-6 / atol 1e-9) and `log_posterior_u_batch` at
  1e-9;
- repeated-row diagonal noise (the route, held to the reference), what
  the port still refuses (warps and Matern orders it lacks), and the card
  when there is none.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptools_tpu import configs as jconfigs
from gptools_tpu.models import dataset as jdataset
from gptools_tpu.models import mean as jmean
from gptools_tpu.models.gp import GPModel as JGPModel
from gptools_tpu.ops import assemble as jassemble
from gptools_tpu.ops import fused as jfused
from gptools_tpu.ops import kernels as jkernels
from gptools_tpu.ops import special as jspecial
from gptools_tpu.utils import bijectors as jbij
from gptools_tpu.utils import priors as jpriors
from gptools_tpu_torch import configs as tconfigs
from gptools_tpu_torch import convert
from gptools_tpu_torch.models import mean as tmean
from gptools_tpu_torch.models.dataset import DatasetBuilder
from gptools_tpu_torch.models.gp import GPModel as TGPModel
from gptools_tpu_torch.ops import fused as tfused
from gptools_tpu_torch.ops import kernels as tkernels
from gptools_tpu_torch.ops import special as tspecial
from gptools_tpu_torch.utils import bijectors as tbij
from gptools_tpu_torch.utils import priors as tpriors

torch.set_num_threads(1)

TIGHT = dict(rtol=1e-12, atol=1e-13)


def _points(rng, n=9, lo=0.05, hi=0.95):
    X = np.sort(rng.uniform(lo, hi, n))
    X[3] = X[2]  # a repeated x, as a value and a slope at one point
    nid = np.zeros(n, int)
    nid[[2, 6]] = 1
    return X, nid


@pytest.mark.parametrize("name", ["se", "matern52"])
def test_stationary_builders_match_jax(rng, name):
    X, nid = _points(rng)
    thetaT = rng.uniform(0.3, 1.5, (2, 5))
    jb = getattr(jfused, f"{name}_cov_fused_soa_sym")
    tb = getattr(tfused, f"{name}_cov_fused_soa_sym")
    K_j = jb(jnp.asarray(X), jnp.asarray(nid), jnp.asarray(thetaT))
    K_t = tb(torch.tensor(X), torch.tensor(nid), torch.tensor(thetaT))
    np.testing.assert_allclose(K_t.numpy(), np.asarray(K_j), **TIGHT)


@pytest.mark.parametrize("base", ["se", "matern52"])
@pytest.mark.parametrize("warp", ["beta", "linear"])
def test_warped_builder_and_gradient_match_jax(rng, base, warp):
    X, nid = _points(rng)
    jw, tw, extra = {
        "beta": (jkernels.BetaWarp(), tkernels.BetaWarp(), 2),
        "linear": (jkernels.LinearWarp(-0.1, 1.3), tkernels.LinearWarp(-0.1, 1.3), 0),
    }[warp]
    thetaT = rng.uniform(0.3, 2.5, (2 + extra, 5))
    ct = rng.standard_normal((X.shape[0], X.shape[0], 5))
    K_j, pull = jax.vjp(
        lambda t: jfused.warped_cov_fused_soa_sym(base, jw, jnp.asarray(X), nid, t),
        jnp.asarray(thetaT),
    )
    t = torch.tensor(thetaT, requires_grad=True)
    K_t = tfused.warped_cov_fused_soa_sym(base, tw, torch.tensor(X), torch.tensor(nid), t)
    (g,) = torch.autograd.grad(K_t, t, torch.tensor(ct))
    np.testing.assert_allclose(K_t.detach().numpy(), np.asarray(K_j), **TIGHT)
    np.testing.assert_allclose(g.numpy(), np.asarray(pull(jnp.asarray(ct))[0]),
                               rtol=1e-11, atol=1e-12)


def test_flagship_cov_soa_and_classifier_match_jax(rng):
    X, nid = _points(rng)
    mis = ((0,), (1,))
    pairs = [
        (jkernels.SquaredExponentialKernel(), tkernels.SquaredExponentialKernel()),
        (jkernels.Matern52Kernel(), tkernels.Matern52Kernel()),
        (jkernels.GibbsKernel1dTanh(), tkernels.GibbsKernel1dTanh()),
        (jkernels.WarpedKernel(jkernels.Matern52Kernel(), jkernels.BetaWarp()),
         tkernels.WarpedKernel(tkernels.Matern52Kernel(), tkernels.BetaWarp())),
    ]
    for jk, tk in pairs:
        jc, tc = jfused.classify_flagship(jk), tfused.classify_flagship(tk)
        assert jc[:2] == tc[:2] and type(jc[2]).__name__ == type(tc[2]).__name__
        thetaT = rng.uniform(0.3, 1.2, (jk.num_params, 4))
        K_j = jfused.flagship_cov_soa(jk, jnp.asarray(thetaT), jnp.asarray(X[:, None]),
                                      jnp.asarray(nid), mis)
        K_t = tfused.flagship_cov_soa(tk, torch.tensor(thetaT), torch.tensor(X[:, None]),
                                      torch.tensor(nid), mis)
        np.testing.assert_allclose(K_t.numpy(), np.asarray(K_j), **TIGHT)
    assert tfused.classify_flagship(tkernels.MaternKernel(2.5, num_dim=2)) is None


@pytest.mark.parametrize("symmetric", [None, True, False])
@pytest.mark.parametrize("name", ["se", "matern52", "gibbs_tanh"])
def test_flagship_cov_soa_symmetric_switch_matches_jax(rng, name, symmetric):
    """``flagship_cov_soa(symmetric=...)``: the full-matrix and symmetric
    builders against the reference's with the same switch (1e-12), and
    against each other (1e-12). None is each side's default: the reference
    reads its `SOA_SYMMETRIC` (True), and the port's default is True."""
    assert jfused.SOA_SYMMETRIC is True
    X, nid = _points(rng)
    mis = ((0,), (1,))
    jk, tk = {
        "se": (jkernels.SquaredExponentialKernel(), tkernels.SquaredExponentialKernel()),
        "matern52": (jkernels.Matern52Kernel(), tkernels.Matern52Kernel()),
        "gibbs_tanh": (jkernels.GibbsKernel1dTanh(), tkernels.GibbsKernel1dTanh()),
    }[name]
    thetaT = rng.uniform(0.3, 1.2, (jk.num_params, 4))
    args_t = (torch.tensor(thetaT), torch.tensor(X[:, None]), torch.tensor(nid), mis)
    K_j = jfused.flagship_cov_soa(jk, jnp.asarray(thetaT), jnp.asarray(X[:, None]),
                                  jnp.asarray(nid), mis, symmetric=symmetric)
    K_t = tfused.flagship_cov_soa(tk, *args_t,
                                  **({} if symmetric is None else {"symmetric": symmetric}))
    np.testing.assert_allclose(K_t.numpy(), np.asarray(K_j), **TIGHT)
    other = tfused.flagship_cov_soa(tk, *args_t, symmetric=symmetric is False)
    np.testing.assert_allclose(K_t.numpy(), other.numpy(), **TIGHT)


@pytest.mark.parametrize("warp", ["beta", "linear"])
@pytest.mark.parametrize("chains_minor", [True, False])
def test_warp_coords_matches_jax(rng, warp, chains_minor):
    """`warp_coords` in both layouts: (N, C) for (C,) parameter rows, (N,)
    for scalars (the reference's LinearWarp keeps (N, 1) chains-minor; the
    port broadcasts it to (N, C))."""
    jw, tw, P = {
        "beta": (jkernels.BetaWarp(), tkernels.BetaWarp(), 2),
        "linear": (jkernels.LinearWarp(-0.1, 1.3), tkernels.LinearWarp(-0.1, 1.3), 0),
    }[warp]
    X = np.sort(rng.uniform(0.05, 0.95, 7))
    th = rng.uniform(0.5, 2.5, (P, 3)) if chains_minor else rng.uniform(0.5, 2.5, P)
    w_j, wp_j = jfused.warp_coords(jw, jnp.asarray(X), jnp.asarray(th), True, chains_minor)
    w_t, wp_t = tfused.warp_coords(tw, torch.tensor(X), torch.tensor(th), True,
                                   chains_minor=chains_minor)
    shape = (7, 3) if chains_minor else (7,)
    assert w_t.shape == wp_t.shape == shape
    np.testing.assert_allclose(w_t.numpy(), np.broadcast_to(np.asarray(w_j), shape), **TIGHT)
    np.testing.assert_allclose(wp_t.numpy(), np.broadcast_to(np.asarray(wp_j), shape), **TIGHT)


def test_betainc_value_and_gradient_match_jax(rng):
    a = rng.uniform(0.3, 3.0, 6)
    b = rng.uniform(0.3, 3.0, 6)
    x = np.concatenate([[0.0, 1.0, 1e-13], rng.uniform(0.01, 0.99, 5)])
    ct = rng.standard_normal((8, 6))
    f_j, pull = jax.vjp(jspecial.betainc_dd, jnp.asarray(a), jnp.asarray(b),
                        jnp.asarray(x)[:, None])
    ga_j, gb_j, gx_j = pull(jnp.asarray(ct))
    ta, tb, tx = (torch.tensor(v, requires_grad=True) for v in (a, b, x[:, None]))
    f_t = tspecial.betainc_dd(ta, tb, tx)
    ga, gb, gx = torch.autograd.grad(f_t, (ta, tb, tx), torch.tensor(ct))
    np.testing.assert_allclose(f_t.detach().numpy(), np.asarray(f_j), **TIGHT)
    for got, want in ((ga, ga_j), (gb, gb_j), (gx, gx_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-11, atol=1e-12)
    assert f_t[0].eq(0).all() and f_t[1].eq(1).all()  # exact endpoints


def test_beta_warp_pdf_matches_jax(rng):
    a, b = rng.uniform(0.3, 3.0, 4), rng.uniform(0.3, 3.0, 4)
    x = rng.uniform(0.0, 1.0, (7, 1))
    np.testing.assert_allclose(
        tfused.beta_warp_pdf(torch.tensor(a), torch.tensor(b), torch.tensor(x)).numpy(),
        np.asarray(jfused.beta_warp_pdf(jnp.asarray(a), jnp.asarray(b), jnp.asarray(x))),
        **TIGHT,
    )


def test_normal_prior_and_identity_bijector_match_jax(rng):
    jp = jpriors.NormalJointPrior([0.0, -1.0], [2.0, 0.5])
    tp = tpriors.NormalJointPrior([0.0, -1.0], [2.0, 0.5])
    th = rng.standard_normal((6, 2)) * 3
    np.testing.assert_allclose(
        tp.log_prob(torch.tensor(th)).numpy(),
        np.asarray(jax.vmap(jp.log_prob)(jnp.asarray(th))), **TIGHT,
    )
    assert tp.bounds == jp.bounds == [(-math.inf, math.inf)] * 2
    tb = tp.bijector()
    assert all(isinstance(p, tbij.IdentityBijector) for p in tb.parts)
    assert all(isinstance(p, jbij.IdentityBijector) for p in jp.bijector().parts)
    u = torch.tensor(th)
    assert torch.equal(tb.forward(u), u) and torch.equal(tb.inverse(u), u)
    np.testing.assert_array_equal(tb.log_det_jac(u).numpy(), np.zeros(6))
    s = tp.sample(torch.Generator().manual_seed(0), (20000,), torch.float64)
    assert s.shape == (20000, 2)
    np.testing.assert_allclose(s.mean(0).numpy(), [0.0, -1.0], atol=0.05)
    np.testing.assert_allclose(s.std(0).numpy(), [2.0, 0.5], rtol=0.03)


@pytest.mark.parametrize("name", ["ConstantMeanFunction", "LinearMeanFunction",
                                  "MtanhMeanFunction1d"])
def test_mean_vector_orders_0_and_1_match_jax(rng, name):
    jm = getattr(jmean, name)()
    tm = getattr(tmean, name)()
    X = np.sort(rng.uniform(0.0, 1.2, 8))[:, None]
    nid = np.array([0, 1, 0, 0, 1, 0, 1, 0])
    mis = ((0,), (1,))
    thetas = rng.uniform(0.2, 1.5, (5, jm.num_params))
    ct = rng.standard_normal((8, 5))
    mu_j, pull = jax.vjp(
        lambda t: jax.vmap(
            lambda th: jassemble.mean_vector(jm, th, jnp.asarray(X), jnp.asarray(nid), mis),
            in_axes=0, out_axes=1,
        )(t),
        jnp.asarray(thetas),
    )
    t = torch.tensor(thetas.T.copy(), requires_grad=True)
    mu_t = tmean.mean_vector(tm, t, torch.tensor(X), torch.tensor(nid), mis)
    (g,) = torch.autograd.grad(mu_t, t, torch.tensor(ct))
    np.testing.assert_allclose(mu_t.detach().numpy(), np.asarray(mu_j), **TIGHT)
    np.testing.assert_allclose(g.numpy().T, np.asarray(pull(jnp.asarray(ct))[0]), **TIGHT)
    assert tm.param_names == jm.param_names
    assert tm.initial_params == jm.initial_params
    assert tm.param_bounds == jm.param_bounds


def check_config_against_jax(config):
    """Port-built and carried-across config ``config`` against the JAX
    package: data, parameters, sampler metadata, `log_marginal_batch` with
    its theta gradient against the reference's XLA path, and
    `log_posterior_u_batch` at unconstrained points near those thetas."""
    jp = jconfigs.ALL_CONFIGS[config](seed=3)
    tp = tconfigs.ALL_CONFIGS[config](seed=3, dtype=torch.float64, device="cpu")
    assert tp.model.param_names == jp.model.param_names
    assert tp.model.initial_params == jp.model.initial_params
    assert tp.model.fixed_params == jp.model.fixed_params
    assert list(tp.model.param_bounds) == list(jp.model.param_bounds)
    assert (tp.sampler, tp.sampler_kwargs) == (jp.sampler, jp.sampler_kwargs)
    for name in ("Xf", "nid", "y", "err_y"):
        np.testing.assert_array_equal(
            getattr(tp.data, name).numpy(), np.asarray(getattr(jp.data, name))
        )
    jm = JGPModel(jp.model.kernel, noise_kernel=jp.model.noise_kernel,
                  mean=jp.model.mean, evidence_backend="xla")
    cm = convert.model_from_jax(jp.model)
    assert cm.param_names == tp.model.param_names
    rng = np.random.default_rng(config)
    thetas = rng.uniform(0.5, 1.5, (6, jm.num_params))
    if config == 3:
        thetas[:, 2:4] = rng.uniform(0.4, 2.8, (6, 2))  # inside the warp prior
        thetas[:, 4:] = rng.standard_normal((6, 2))     # the mean's slope, offset
    us = np.asarray(jax.vmap(jm.u_of_theta)(jnp.asarray(thetas)))
    us = us + 0.1 * rng.standard_normal(us.shape)

    @jax.jit
    def f(t, u):
        ll, pull = jax.vjp(lambda s: jm.log_marginal_batch(s, jp.data), t)
        return ll, pull(jnp.ones_like(ll))[0], jm.log_posterior_u_batch(u, jp.data)

    ll_j, g_j, lp_j = f(jnp.asarray(thetas), jnp.asarray(us))
    for model in (tp.model, cm):
        t = torch.tensor(thetas, requires_grad=True)
        ll = model.log_marginal_batch(t, tp.data)
        (g,) = torch.autograd.grad(ll.sum(), t)
        np.testing.assert_allclose(ll.detach().numpy(), np.asarray(ll_j), rtol=1e-9)
        np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=1e-6, atol=1e-9)
        lp = model.log_posterior_u_batch(torch.tensor(us), tp.data)
        np.testing.assert_allclose(lp.numpy(), np.asarray(lp_j), rtol=1e-9)


def test_config2_matches_jax():
    """Config 2 (SE with slopes); config 3 is in test_torch_aux_evidence.py,
    so the two slow reference compiles run in different files."""
    check_config_against_jax(2)


def test_duplicate_row_noise_raises():
    """A DiagonalNoiseKernel on a repeated x couples the two rows off the
    diagonal: the evidence kernel does not apply, and the batch evidence
    takes the route, where it matches the reference (it used to raise)."""
    b = DatasetBuilder(1)
    X = np.array([0.1, 0.3, 0.3, 0.8])  # a repeated x: the noise couples rows
    b.add(X, np.sin(X), err_y=0.1)
    data = b.build(torch.float64, "cpu")
    m = TGPModel(tkernels.SquaredExponentialKernel(),
                 noise_kernel=tkernels.DiagonalNoiseKernel(n=0))
    assert m._evidence_plan(data) is None
    jb = jdataset.DatasetBuilder(1)
    jb.add(X, np.sin(X), err_y=0.1)
    jm = JGPModel(jkernels.SquaredExponentialKernel(),
                  noise_kernel=jkernels.DiagonalNoiseKernel(n=0))
    th = np.array([[1.0, 0.3, 0.2], [0.7, 0.5, 0.05]])
    np.testing.assert_allclose(
        m.log_marginal_batch(torch.tensor(th), data).numpy(),
        np.asarray(jm.log_marginal_batch(jnp.asarray(th), jb.build(dtype=jnp.float64))),
        rtol=1e-9,
    )


def test_unclassified_kernel_raises():
    """A kernel without an evidence-kernel kind takes the per-chain route,
    which needs the kernel's own scalar: the abstract `InputWarp` raises
    there, as does the Matern order the reference refuses (nu = 1/2)."""
    data = DatasetBuilder(1).add(np.linspace(0, 1, 4), np.zeros(4), err_y=0.1).build(
        torch.float64, "cpu")
    k = tkernels.WarpedKernel(tkernels.Matern52Kernel(), tkernels.InputWarp())
    with pytest.raises(NotImplementedError, match="defines no __call__"):
        TGPModel(k).log_marginal_batch(torch.ones(2, 2, dtype=torch.float64), data)
    with pytest.raises(NotImplementedError, match="nu = 1/2"):
        tkernels.MaternKernel(nu=0.5)


@pytest.mark.parametrize("config", [2, 3, 4])
def test_configs_default_to_the_card(config):
    build = tconfigs.ALL_CONFIGS[config]
    if torch.cuda.is_available():
        assert build().data.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
