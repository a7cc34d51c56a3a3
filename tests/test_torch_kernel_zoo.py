"""The rest of the reference's kernel zoo in the port, against the JAX
package, float64: the free-nu Matern (at and near coincidence, at the
series / quadrature switch and at nu = 2 +- 2e-6), the rational
quadratic, the Gauss, exp and interpolated Gibbs warps, the kernel algebra
(sum, product, scaled, 2-D masked, constant, zero, arbitrary, chain rule)
and an arbitrary input warp.

- derivative blocks (0,0), (0,1), (1,0), (1,1): within 1e-12 (relative,
  with 1e-12 of the block's largest entry as the absolute floor, for
  entries that vanish at coincidence); at nu = 2 +- 2e-6 within 1e-16 /
  |nu - 2| = 5e-11: below the switch the two series each carry a pole
  1 / |nu - 2| = 5e5 that cancels in their difference, so a one-ulp
  difference between the libraries' lgamma, sin and exp grows by that
  factor (measured: 2.3e-12 in the (1,1) block at u = 0.0099);
- metadata: names, bounds, initial and fixed values, the prior's bounds,
  the sums' delta terms and the per-entry cost;
- evidence: `log_marginal_batch` and its gradient at C = 8 against the
  reference's jitted ``vmap(value_and_grad(log_marginal))``: 1e-9
  (relative) and 1e-7 (relative) / 1e-9 (absolute);
- the per-chain route's chunks, and the free-nu Matern's nu-support
  warning (as tests/test_kernels.py holds the reference's).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptools_tpu.models.dataset import DatasetBuilder as JBuilder
from gptools_tpu.models.gp import GPModel as JGPModel
from gptools_tpu.ops import kernels as JK
from gptools_tpu.utils import priors as JP
from gptools_tpu_torch import convert
from gptools_tpu_torch.models import gp as tgp
from gptools_tpu_torch.models.dataset import DatasetBuilder as TBuilder
from gptools_tpu_torch.ops import evidence_cuda
from gptools_tpu_torch.ops import kernels as TK
from gptools_tpu_torch.utils import priors as TP

torch.set_num_threads(1)

KNOTS = [0.0, 0.5, 1.2, 2.0, 2.5, 3.0]


def _nu_prior(mod):
    mod = {JK: JP, TK: TP}.get(mod, mod)
    return (mod.LogNormalJointPrior([0.0], [0.75]) * mod.UniformJointPrior([1.05], [6.0])
            * mod.LogNormalJointPrior([-0.5], [0.75]))


def _chain_rule(mod, xp):
    return mod.ChainRuleKernel(
        lambda v, t: t[..., 0] ** 2 * xp.exp(v),
        lambda x1, x2, t: -0.5 * xp.sum((x1 - x2) ** 2, -1) / t[..., 1] ** 2,
        1, ("sigma_f", "l_1"))


def _arbitrary(mod, xp):
    return mod.ArbitraryKernel(
        lambda x1, x2, t: t[..., 0] ** 2 * xp.exp(-0.5 * xp.sum((x1 - x2) ** 2, -1)
                                                  / t[..., 1] ** 2),
        1, ("sigma_f", "l_1"))


def _warped(mod, xp):
    warp = mod.ArbitraryWarp(lambda x, t: xp.tanh(t[..., 0] * x), ("s",), ((0.1, 10.0),))
    return mod.WarpedKernel(mod.SquaredExponentialKernel(), warp)


# name -> (builder of (module, array module), theta, num_dim)
KERNELS = {
    "matern_general": (lambda m, xp: m.MaternGeneralKernel(hyperprior=_nu_prior(m)),
                       [1.1, 2.7, 0.8], 1),
    "matern_general_nu2_plus": (lambda m, xp: m.MaternGeneralKernel(), [1.1, 2 + 2e-6, 0.8], 1),
    "matern_general_nu2_minus": (lambda m, xp: m.MaternGeneralKernel(), [1.1, 2 - 2e-6, 0.8], 1),
    "matern_general_nu_half_integer": (lambda m, xp: m.MaternGeneralKernel(),
                                       [0.9, 3.5, 1.3], 1),
    "rational_quadratic": (lambda m, xp: m.RationalQuadraticKernel(), [1.1, 2.7, 0.8], 1),
    "gibbs_gauss": (lambda m, xp: m.GibbsKernel1dGauss(), [1.1, 0.5, 0.2, 0.4, 1.5], 1),
    "gibbs_exp": (lambda m, xp: m.GibbsKernel1dExp(), [1.1, 0.5, 2.0], 1),
    "gibbs_interpolated": (lambda m, xp: m.GibbsKernel(m.InterpolatedWarp(KNOTS)),
                           [1.1, 0.5, 0.3, 0.4, 0.6, 0.2, 0.8], 1),
    "sum": (lambda m, xp: m.SquaredExponentialKernel() + m.RationalQuadraticKernel(),
            [1.1, 0.5, 0.3, 2.0, 0.6], 1),
    "product": (lambda m, xp: m.SquaredExponentialKernel() * m.RationalQuadraticKernel(),
                [1.1, 0.5, 0.3, 2.0, 0.6], 1),
    "scaled": (lambda m, xp: 2.0 * m.SquaredExponentialKernel(), [1.1, 0.5], 1),
    "constant_plus_se": (lambda m, xp: m.ConstantKernel() + m.SquaredExponentialKernel(),
                         [0.3, 1.1, 0.5], 1),
    "zero_plus_se": (lambda m, xp: m.ZeroKernel() + m.SquaredExponentialKernel(), [1.1, 0.5], 1),
    "chain_rule": (_chain_rule, [1.1, 0.5], 1),
    "arbitrary": (_arbitrary, [1.1, 0.5], 1),
    "arbitrary_warp": (_warped, [1.1, 0.5, 0.7], 1),
    "masked_2d": (lambda m, xp: m.MaskedKernel(m.SquaredExponentialKernel(), 2, [0])
                  * m.MaskedKernel(m.RationalQuadraticKernel(), 2, [1]),
                  [1.1, 0.5, 0.8, 2.0, 0.6], 2),
}


def _pairs(rng, D, nu=2.7, ell=0.8):
    """Point pairs: coincident, near-coincident (r from 1e-12 to 1e-2),
    around the free-nu Matern's series / quadrature switch (u = 2 nu r^2 /
    l^2 at 1e-30, 1e-8, 0.5e-2, 0.99e-2, 1.01e-2, 2e-2) and generic."""
    u = np.array([1e-30, 1e-8, 0.5e-2, 0.99e-2, 1.01e-2, 2e-2, 1.0, 10.0])
    r = np.concatenate([np.zeros(3), np.logspace(-12, -2, 6), ell * np.sqrt(u / (2 * nu)),
                        rng.uniform(0.05, 2.0, 5)])
    x1 = rng.uniform(0.0, 3.0, (len(r), D))
    direction = rng.standard_normal((len(r), D))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    return x1, x1 + r[:, None] * direction


def _jax_blocks(jk, D, d):
    """The four blocks along dimension d, jitted once for the kernel."""
    e = tuple(int(i == d) for i in range(D))
    z = (0,) * D
    fns = [jk.block_fn(a, b) for a, b in ((z, z), (e, z), (z, e), (e, e))]
    return jax.jit(jax.vmap(lambda x1, x2, t: [f(x1, x2, t) for f in fns],
                            in_axes=(0, 0, None)))


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_blocks_match_jax(rng, name):
    build, theta, D = KERNELS[name]
    jk, tk = build(JK, jnp), build(TK, torch)
    nu = theta[1] if name.startswith("matern_general") else 2.7
    x1, x2 = _pairs(rng, D, nu=nu, ell=theta[-1])
    th = np.asarray(theta)
    near = abs(theta[1] - round(theta[1])) if name.startswith("matern_general") else 1.0
    rtol = 1e-12 if near > 1e-4 else 1e-16 / near
    for d in range(D):
        want = _jax_blocks(jk, D, d)(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(th))
        e = tuple(int(i == d) for i in range(D))
        z = (0,) * D
        for (a, b), w in zip(((z, z), (e, z), (z, e), (e, e)), want):
            got = tk.block_fn(a, b)(torch.tensor(x1), torch.tensor(x2), torch.tensor(th))
            w = np.asarray(w)
            np.testing.assert_allclose(got.numpy(), w, rtol=rtol,
                                       atol=rtol * np.abs(w).max(), err_msg=f"{a} {b}")


def test_blocks_broadcast_a_theta_batch(rng):
    """A theta batch (B, 1, P) against points (N, D) gives (B, N), each row
    the single-theta result (the port's broadcast convention; the
    interpolated warp gathers its knot values per entry)."""
    x1, x2 = _pairs(rng, 1)
    for name in ("gibbs_interpolated", "matern_general", "sum"):
        build, theta, _ = KERNELS[name]
        tk = build(TK, torch)
        thetas = np.asarray(theta) * rng.uniform(0.9, 1.1, (3, len(theta)))
        fn = tk.block_fn((1,), (1,))
        batch = fn(torch.tensor(x1), torch.tensor(x2), torch.tensor(thetas)[:, None, :])
        for i in range(3):
            one = fn(torch.tensor(x1), torch.tensor(x2), torch.tensor(thetas[i]))
            np.testing.assert_allclose(batch[i].numpy(), one.numpy(), rtol=1e-14, atol=1e-300)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_metadata_matches_jax(name):
    build, _, _ = KERNELS[name]
    jk, tk = build(JK, jnp), build(TK, torch)
    assert tk.param_names == jk.param_names
    assert tk.param_bounds == list(jk.param_bounds)
    assert tk.initial_params == jk.initial_params
    assert tk.fixed_params == jk.fixed_params
    assert tk.hyperprior.bounds == jk.hyperprior.bounds
    assert tk.num_dim == jk.num_dim and tk.has_smooth == jk.has_smooth


# the zoo above, the configs' kernels, the input warps and fixed parameters
FREE_PARAM_KERNELS = {
    **{name: build for name, (build, _, _) in KERNELS.items()},
    "se_sigma_fixed": lambda m, xp: m.SquaredExponentialKernel(fixed_params=[True, False]),
    "gibbs_tanh": lambda m, xp: m.GibbsKernel1dTanh(),
    "gibbs_tanh_x0_fixed": lambda m, xp: m.GibbsKernel1dTanh(
        fixed_params=[False, False, False, False, True]),
    "matern52": lambda m, xp: m.Matern52Kernel(),
    "beta_warped_matern52": lambda m, xp: m.WarpedKernel(m.Matern52Kernel(), m.BetaWarp()),
    "linear_warped_se": lambda m, xp: m.WarpedKernel(m.SquaredExponentialKernel(),
                                                     m.LinearWarp(0.0, 3.0)),
    "noise_fixed_in_sum": lambda m, xp: (
        m.SquaredExponentialKernel(fixed_params=[False, True])
        + m.DiagonalNoiseKernel(fixed_params=[True])),
    "product_fixed": lambda m, xp: (m.SquaredExponentialKernel()
                                    * m.RationalQuadraticKernel(fixed_params=[True, False,
                                                                              False])),
}


@pytest.mark.parametrize("name", sorted(FREE_PARAM_KERNELS))
def test_free_params_match_jax(name):
    """`Kernel.num_free_params` and `free_param_names` as the reference's."""
    build = FREE_PARAM_KERNELS[name]
    jk, tk = build(JK, jnp), build(TK, torch)
    assert tk.num_free_params == jk.num_free_params
    assert tk.free_param_names == jk.free_param_names
    assert tk.num_free_params == len(tk.free_param_names) == sum(not f for f in tk.fixed_params)


def test_delta_terms_and_costs():
    """Sums keep their parts' white noise at shifted offsets; products and
    scaled kernels refuse it; the per-entry cost adds up over the parts."""
    for mod in (JK, TK):
        noise = mod.DiagonalNoiseKernel()
        k = (mod.SquaredExponentialKernel() + noise) + (mod.RationalQuadraticKernel() + noise)
        assert [off for off, _ in k.delta_terms()] == [2, 6]
        assert k.param_names[:3] == ("k1.k1.sigma_f", "k1.k1.l_1", "k1.k2.sigma_n")
        assert (mod.DiagonalNoiseKernel() + mod.DiagonalNoiseKernel()).has_smooth is False
        with pytest.raises(ValueError, match="white-noise"):
            mod.SquaredExponentialKernel() * noise
        with pytest.raises(ValueError, match="delta"):
            2.0 * (mod.SquaredExponentialKernel() + noise)
    mg = TK.MaternGeneralKernel()
    assert mg.entry_cost == 768 and TK.SquaredExponentialKernel().entry_cost == 1
    assert (mg + TK.SquaredExponentialKernel()).entry_cost == 769
    assert (3.0 * TK.MaskedKernel(mg, 2, [1])).entry_cost == 768
    assert TK.MaternKernelArb is TK.MaternGeneralKernel
    assert mg.nu_max_order() == 30  # the default bounds' (0.51, 30)
    assert TK.MaternGeneralKernel(hyperprior=_nu_prior(TP)).nu_max_order() == 6
    assert TK.MaternGeneralKernel(
        hyperprior=TP.LogNormalJointPrior([0.0, 0.5, 0.0], [1.0, 1.0, 1.0])).nu_max_order() == 63


def test_half_integer_message_names_the_general_kernel():
    with pytest.raises(NotImplementedError, match="MaternGeneralKernel"):
        TK.MaternKernel(nu=2.0)


def _data_1d(mod_builder, **build_kw):
    b = mod_builder(1)
    x = np.linspace(0.0, 3.0, 6)
    b.add(x, np.sin(1.3 * x), err_y=0.1)
    b.add(np.array([0.0]), np.array([1.3]), err_y=0.05, n=1)
    return b.build(**build_kw)


def _data_2d(mod_builder, **build_kw):
    rng = np.random.default_rng(3)
    b = mod_builder(2)
    X = rng.uniform(0.0, 1.0, (6, 2))
    b.add(X, np.sin(3.0 * X[:, 0]) * np.cos(2.0 * X[:, 1]), err_y=0.1)
    b.add(np.array([[0.0, 0.4]]), np.array([3.0]), err_y=0.1, n=[1, 0])
    return b.build(**build_kw)


# name -> (kernel builder, theta center, data)
EVIDENCE = {
    "matern_general": (lambda m: m.MaternGeneralKernel(hyperprior=_nu_prior(m)),
                       [1.1, 2.7, 0.8], "1d"),
    "rational_quadratic": (lambda m: m.RationalQuadraticKernel(), [1.1, 2.7, 0.8], "1d"),
    "gibbs_gauss": (lambda m: m.GibbsKernel1dGauss(), [1.1, 0.5, 0.2, 0.4, 1.5], "1d"),
    "gibbs_exp": (lambda m: m.GibbsKernel1dExp(), [1.1, 0.5, 2.0], "1d"),
    "gibbs_interpolated": (lambda m: m.GibbsKernel(m.InterpolatedWarp(KNOTS)),
                           [1.1, 0.5, 0.3, 0.4, 0.6, 0.2, 0.8], "1d"),
    "sum_with_noise": (lambda m: (m.RationalQuadraticKernel() + m.SquaredExponentialKernel())
                       + m.DiagonalNoiseKernel(), [1.1, 2.0, 0.6, 0.5, 0.9, 0.05], "1d"),
    "scaled_product_masked_2d": (
        lambda m: 2.0 * (m.MaskedKernel(m.SquaredExponentialKernel(), 2, [0])
                         * m.MaskedKernel(m.RationalQuadraticKernel(), 2, [1])),
        [1.1, 0.5, 0.8, 2.0, 0.6], "2d"),
}


@pytest.mark.parametrize("name", sorted(EVIDENCE))
def test_log_marginal_batch_matches_jax(rng, name):
    make, center, kind = EVIDENCE[name]
    data_fn = _data_1d if kind == "1d" else _data_2d
    jm = JGPModel(make(JK))
    jd = data_fn(JBuilder, dtype=jnp.float64)
    tm = convert.model_from_jax(jm)
    td = convert.dataset_from_jax(jd, torch.float64, "cpu")
    th = np.asarray(center) * rng.uniform(0.85, 1.15, (8, len(center)))
    f = jax.jit(jax.vmap(jax.value_and_grad(lambda t: jm.log_marginal(t, jd))))
    want_ll, want_g = (np.asarray(v) for v in f(jnp.asarray(th)))
    evidence_cuda.reset_counts()
    t = torch.tensor(th, requires_grad=True)
    ll = tm.log_marginal_batch(t, td)
    (g,) = torch.autograd.grad(ll.sum(), t)
    assert evidence_cuda.ROUTE_CALLS["per_chain"] == 1
    np.testing.assert_allclose(ll.detach().numpy(), want_ll, rtol=1e-9)
    np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-7, atol=1e-9)


def test_chunked_route_equals_unchunked(monkeypatch, rng):
    """At a budget patched down to three chains' worth of the free-nu
    Matern's entries (Q^2 times its 768 node entries), C = 8 runs in three
    chunks with the unchunked value and gradient."""
    model = tgp.GPModel(TK.MaternGeneralKernel(hyperprior=_nu_prior(TP)))
    data = _data_1d(TBuilder, dtype=torch.float64, device="cpu")
    th = torch.tensor(np.asarray([1.1, 2.7, 0.8]) * rng.uniform(0.85, 1.15, (8, 3)))

    def vag():
        t = th.clone().requires_grad_(True)
        ll = model.log_marginal_batch(t, data)
        return ll.detach(), torch.autograd.grad(ll.sum(), t)[0]

    ll_one, g_one = vag()
    calls = []
    inner = model.log_marginal
    monkeypatch.setattr(model, "log_marginal", lambda t, d: calls.append(t.shape[0]) or inner(t, d))
    monkeypatch.setattr(tgp, "_PER_CHAIN_ENTRIES", 3 * 768 * data.num_latent**2)
    ll_chunked, g_chunked = vag()
    assert calls == [3, 3, 2]
    np.testing.assert_allclose(ll_chunked.numpy(), ll_one.numpy(), rtol=1e-13)
    np.testing.assert_allclose(g_chunked.numpy(), g_one.numpy(), rtol=1e-12, atol=1e-14)


def test_matern_general_deriv_obs_nu_support_warning():
    """A free-nu Matern model whose nu prior or bounds admit nu <= 1 warns
    once on derivative observations; value-only data and a nu-safe prior
    do not warn."""
    data_deriv = _data_1d(TBuilder, dtype=torch.float64, device="cpu")
    b = TBuilder(1)
    b.add(np.linspace(0, 1, 6), np.zeros(6), err_y=0.1)
    data_valonly = b.build(torch.float64, "cpu")
    loose = (TP.LogNormalJointPrior([0.0], [1.0]) * TP.LogNormalJointPrior([0.6], [0.5])
             * TP.LogNormalJointPrior([-0.5], [1.0]))
    theta = torch.tensor([[1.1, 1.7, 0.8]], dtype=torch.float64)
    with pytest.warns(UserWarning, match="nu > 1"):
        m = tgp.GPModel(TK.MaternGeneralKernel(hyperprior=loose))
        m.log_marginal_batch(theta, data_deriv)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        m.log_marginal_batch(theta, data_deriv)  # once per model
        m2 = tgp.GPModel(TK.MaternGeneralKernel(hyperprior=loose))
        m2.log_marginal_batch(theta, data_valonly)
    safe = (TP.LogNormalJointPrior([0.0], [1.0]) * TP.UniformJointPrior([1.01], [30.0])
            * TP.LogNormalJointPrior([-0.5], [1.0]))
    kern = TK.MaternGeneralKernel(hyperprior=safe)
    kern.param_bounds[1] = (1.01, 30.0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        m3 = tgp.GPModel(kern)
        m3.log_marginal_batch(theta, data_deriv)
        m3.log_marginal(theta[0], data_deriv)


def test_sum_mean_and_arbitrary_mean_match_jax(rng):
    """`SumMeanFunction` (through ``+``) and `ArbitraryMeanFunction` in the
    evidence, against the reference's."""
    from gptools_tpu.models import mean as jmean
    from gptools_tpu_torch.models import mean as tmean

    jm = JGPModel(JK.SquaredExponentialKernel(),
                  mean=jmean.LinearMeanFunction() + jmean.ConstantMeanFunction())
    jd = _data_1d(JBuilder, dtype=jnp.float64)
    tm = convert.model_from_jax(jm)
    assert type(tm.mean).__name__ == "SumMeanFunction"
    assert tm.param_names == tuple(f"k.{n}" for n in jm.kernel.param_names) + (
        "mu.m1.a_1", "mu.m1.b", "mu.m2.c")
    th = np.asarray([1.1, 0.8, 0.3, -0.2, 0.1]) + 0.05 * rng.standard_normal((8, 5))
    f = jax.jit(jax.vmap(jax.value_and_grad(lambda t: jm.log_marginal(t, jd))))
    want_ll, want_g = (np.asarray(v) for v in f(jnp.asarray(th)))
    td = convert.dataset_from_jax(jd, torch.float64, "cpu")
    t = torch.tensor(th, requires_grad=True)
    ll = tm.log_marginal_batch(t, td)
    (g,) = torch.autograd.grad(ll.sum(), t)
    np.testing.assert_allclose(ll.detach().numpy(), want_ll, rtol=1e-9)
    np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-7, atol=1e-9)
    # the same sum written as one torch callable
    arb = tmean.ArbitraryMeanFunction(
        lambda x, p: p[..., 0] * x[..., 0] + p[..., 1] + p[..., 2], 1, ("a", "b", "c"))
    ta = tgp.GPModel(tm.kernel, mean=arb)
    t2 = torch.tensor(th, requires_grad=True)
    ll2 = ta.log_marginal_batch(t2, td)
    (g2,) = torch.autograd.grad(ll2.sum(), t2)
    np.testing.assert_allclose(ll2.detach().numpy(), want_ll, rtol=1e-9)
    np.testing.assert_allclose(g2.numpy(), want_g, rtol=1e-7, atol=1e-9)


def test_kernel_without_parameters_in_a_sum(rng):
    """A zero kernel adds an empty block to the prior and the bijector: the
    sum's log posterior in u equals the SE's alone."""
    data = _data_1d(TBuilder, dtype=torch.float64, device="cpu")
    se = tgp.GPModel(TK.SquaredExponentialKernel(param_bounds=[(0.1, 3.0), (0.1, 3.0)]))
    both = tgp.GPModel(TK.ZeroKernel() + TK.SquaredExponentialKernel(
        param_bounds=[(0.1, 3.0), (0.1, 3.0)]))
    u = torch.tensor(rng.standard_normal((8, 2)))
    np.testing.assert_array_equal(both.theta_of_u(u).numpy(), se.theta_of_u(u).numpy())
    np.testing.assert_allclose(both.log_posterior_u_batch(u, data).numpy(),
                               se.log_posterior_u_batch(u, data).numpy(), rtol=1e-14)
