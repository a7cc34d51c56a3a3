"""Port priors and bijectors against the JAX package, batched, float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptools_tpu.utils import bijectors as jbij
from gptools_tpu.utils import priors as jpri
from gptools_tpu_torch.utils import bijectors as tbij
from gptools_tpu_torch.utils import priors as tpri

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)


def _config4_priors(mod):
    return (
        mod.LogNormalJointPrior([0.0], [0.75])
        * mod.LogNormalJointPrior([-1.0], [0.6])
        * mod.LogNormalJointPrior([-2.3], [0.6])
        * mod.LogNormalJointPrior([-2.3], [0.6])
        * mod.UniformJointPrior([0.6], [1.1])
    )


_BIJECTORS = {
    "softplus": lambda m: m.SoftplusBijector(0.0),
    "softplus_shifted": lambda m: m.SoftplusBijector(-0.5),
    "sigmoid": lambda m: m.SigmoidBijector(0.6, 1.1),
    "config4": lambda m: m.bijector_from_bounds(_config4_priors(
        jpri if m is jbij else tpri).bounds),
}


@pytest.mark.parametrize("name", sorted(_BIJECTORS))
def test_bijector_matches_jax(rng, name):
    jb, tb = _BIJECTORS[name](jbij), _BIJECTORS[name](tbij)
    assert type(jb).__name__ == type(tb).__name__
    u = 3.0 * rng.standard_normal((64, jb.dim))
    x_j = np.asarray(jax.vmap(jb.forward)(jnp.asarray(u)))
    x_t = tb.forward(torch.tensor(u)).numpy()
    np.testing.assert_allclose(x_t, x_j, **TOL)
    np.testing.assert_allclose(
        tb.inverse(torch.tensor(x_j)).numpy(),
        np.asarray(jax.vmap(jb.inverse)(jnp.asarray(x_j))), **TOL
    )
    np.testing.assert_allclose(
        tb.log_det_jac(torch.tensor(u)).numpy(),
        np.asarray(jax.vmap(jb.log_det_jac)(jnp.asarray(u))), **TOL
    )


def test_config4_bijector_is_softplus_and_sigmoid():
    """The log-normal parts' support (0, inf) maps to softplus (not exp)."""
    b = _config4_priors(tpri).bijector()
    leaves = [type(q).__name__ for p in b.parts for q in p.parts]
    assert leaves == ["SoftplusBijector"] * 4 + ["SigmoidBijector"]


def _theta_draws(rng, n=48):
    mu = np.array([0.0, -1.0, -2.3, -2.3])
    sg = np.array([0.75, 0.6, 0.6, 0.6])
    th = np.concatenate(
        [np.exp(mu + sg * rng.standard_normal((n, 4))), rng.uniform(0.6, 1.1, (n, 1))],
        axis=1,
    )
    # out-of-support rows: non-positive scales, x0 outside its box
    th[0, 0] = -0.3
    th[1, 3] = 0.0
    th[2, 4] = 1.3
    th[3, 4] = 0.2
    return th


@pytest.mark.parametrize("part", [None, 0, 4])
def test_log_prob_matches_jax(rng, part):
    """Product prior (part=None) and single parts, with out-of-support draws:
    -inf in both, finite gradient in the port."""
    jp, tp = _config4_priors(jpri), _config4_priors(tpri)
    th = _theta_draws(rng)
    if part is not None:
        jp, tp = jp.parts[part], tp.parts[part]
        th = th[:, part : part + 1]
    lp_j = np.asarray(jax.vmap(jp.log_prob)(jnp.asarray(th)))
    t = torch.tensor(th, requires_grad=True)
    lp_t = tp.log_prob(t)
    np.testing.assert_array_equal(np.isinf(lp_t.detach().numpy()), np.isinf(lp_j))
    fin = np.isfinite(lp_j)
    assert (~fin).any() and fin.any()
    np.testing.assert_allclose(lp_t.detach().numpy()[fin], lp_j[fin], **TOL)
    if lp_t.requires_grad:
        (g,) = torch.autograd.grad(lp_t.sum(), t)
    else:  # a uniform density is flat in theta
        g = torch.zeros_like(t)
    assert torch.isfinite(g).all()
    g_j = np.asarray(jax.vmap(jax.grad(jp.log_prob))(jnp.asarray(th)))
    np.testing.assert_allclose(g.numpy()[fin], g_j[fin], **TOL)


def test_sample_shapes_and_support():
    tp = _config4_priors(tpri)
    gen = torch.Generator().manual_seed(0)
    draws = tp.sample(gen, (4096,), torch.float64)
    assert draws.shape == (4096, 5) and draws.dtype == torch.float64
    assert torch.isfinite(tp.log_prob(draws)).all()
    # log-normal parts: mean of log matches mu within 4 standard errors
    logs = torch.log(draws[:, :4]).mean(0).numpy()
    se = np.array([0.75, 0.6, 0.6, 0.6]) / np.sqrt(4096)
    assert np.all(np.abs(logs - np.array([0.0, -1.0, -2.3, -2.3])) < 4 * se)
    assert float(draws[:, 4].min()) >= 0.6 and float(draws[:, 4].max()) <= 1.1


def test_log_prob_constants_follow_dtype(rng):
    """A prior keeps its constants per (dtype, device): calls alternating
    float64 and float32 on one prior give each dtype's values, equal to a
    fresh prior's."""
    tp = _config4_priors(tpri)
    th = _theta_draws(rng)[4:]
    for dtype in (torch.float64, torch.float32, torch.float64, torch.float32):
        t = torch.tensor(th, dtype=dtype)
        lp = tp.log_prob(t)
        assert lp.dtype == dtype
        np.testing.assert_array_equal(lp.numpy(), _config4_priors(tpri).log_prob(t).numpy())
        draws = tp.sample(torch.Generator().manual_seed(1), (8,), dtype)
        assert draws.dtype == dtype
        np.testing.assert_array_equal(
            draws.numpy(),
            _config4_priors(tpri).sample(torch.Generator().manual_seed(1), (8,), dtype).numpy())


# the rest of the reference's priors: name -> builder of the module's prior
_ZOO_PRIORS = {
    "gamma": lambda m: m.GammaJointPrior([2.0, 0.5], [1.5, 3.0]),
    "gamma_alt": lambda m: m.GammaJointPriorAlt([1.0, 2.0], [0.5, 1.0]),
    "exponential": lambda m: m.ExponentialJointPrior([2.0, 0.3]),
    "sorted_uniform": lambda m: m.SortedUniformJointPrior(3, 0.0, 2.0),
    "core_edge": lambda m: m.CoreEdgeJointPrior(2, 0.1, 1.5),
    "independent": lambda m: m.IndependentJointPrior(
        [m.Uniform(0.0, 1.0), m.Normal(0.5, 2.0), m.LogNormal(0.1, 0.5), m.Gamma(2.0, 1.0),
         m.Exponential(3.0)]),
}


@pytest.mark.parametrize("name", sorted(_ZOO_PRIORS))
def test_zoo_prior_log_prob_matches_jax(rng, name):
    """log_prob within 1e-12 inside the support and the same -inf outside
    it (draws straddle every support edge), with a finite gradient; the
    bounds and the bijector's type as the reference's."""
    jp, tp = _ZOO_PRIORS[name](jpri), _ZOO_PRIORS[name](tpri)
    th = rng.uniform(-0.2, 2.1, (256, jp.dim))
    lp_j = np.asarray(jax.vmap(jp.log_prob)(jnp.asarray(th)))
    t = torch.tensor(th, requires_grad=True)
    lp_t = tp.log_prob(t)
    np.testing.assert_array_equal(np.isinf(lp_t.detach().numpy()), np.isinf(lp_j))
    fin = np.isfinite(lp_j)
    assert fin.any() and (~fin).any()
    np.testing.assert_allclose(lp_t.detach().numpy()[fin], lp_j[fin], **TOL)
    if lp_t.requires_grad:
        assert torch.isfinite(torch.autograd.grad(lp_t.sum(), t)[0]).all()
    assert tp.bounds == jp.bounds
    assert type(tp.bijector()).__name__ == type(jp.bijector()).__name__
    draws = tp.sample(torch.Generator().manual_seed(0), (512,), torch.float64)
    assert draws.shape == (512, jp.dim) and torch.isfinite(tp.log_prob(draws)).all()


_ZOO_BIJECTORS = {
    "exp": lambda m: m.ExpBijector(0.3),
    "neg_exp": lambda m: m.NegExpBijector(1.5),
    "upper_bounded": lambda m: m.interval_bijector(None, 2.0),
    "ordered": lambda m: m.OrderedIntervalBijector(-0.5, 2.0, 4),
}


@pytest.mark.parametrize("name", sorted(_ZOO_BIJECTORS))
def test_zoo_bijector_matches_jax(rng, name):
    """forward, inverse and log-det against the reference within 1e-12; a
    (64, dim) batch at once (the ordered bijector in closed form)."""
    jb, tb = _ZOO_BIJECTORS[name](jbij), _ZOO_BIJECTORS[name](tbij)
    assert type(jb).__name__ == type(tb).__name__
    u = 3.0 * rng.standard_normal((64, jb.dim))
    x_j = np.asarray(jax.vmap(jb.forward)(jnp.asarray(u)))
    np.testing.assert_allclose(tb.forward(torch.tensor(u)).numpy(), x_j, **TOL)
    np.testing.assert_allclose(
        tb.inverse(torch.tensor(x_j)).numpy(),
        np.asarray(jax.vmap(jb.inverse)(jnp.asarray(x_j))), **TOL)
    np.testing.assert_allclose(
        tb.log_det_jac(torch.tensor(u)).numpy(),
        np.asarray(jax.vmap(jb.log_det_jac)(jnp.asarray(u))), **TOL)


def test_ordered_bijector_log_det_is_the_jacobian(rng):
    """The closed-form log-det equals log|det| of the forward map's
    autograd Jacobian, and the forward map is ordered inside (lo, hi)."""
    b = tbij.OrderedIntervalBijector(0.2, 1.7, 4)
    u = torch.tensor(rng.standard_normal(4))
    J = torch.autograd.functional.jacobian(b.forward, u)
    np.testing.assert_allclose(float(b.log_det_jac(u)), float(torch.slogdet(J)[1]), rtol=1e-12)
    x = b.forward(torch.tensor(2.0 * rng.standard_normal((32, 4))))
    assert bool((torch.diff(x, dim=-1) > 0).all()) and 0.2 < float(x.min()) < float(x.max()) < 1.7


@pytest.mark.parametrize("a", [0.3, 1.0, 2.5])
def test_gamma_sampler_ks_and_bits(a):
    """Marsaglia-Tsang from the generator's own draws: a KS test against
    scipy's gamma at 4000 draws (p > 1e-3), and the same bits from the
    same generator seed."""
    from scipy import stats

    shape = torch.full((4000,), a, dtype=torch.float64)
    x = tpri.standard_gamma(torch.Generator().manual_seed(11), shape)
    assert bool((x > 0).all())
    assert stats.kstest(x.numpy(), stats.gamma(a).cdf).pvalue > 1e-3
    again = tpri.standard_gamma(torch.Generator().manual_seed(11), shape)
    assert torch.equal(x, again)
    scaled = tpri.GammaJointPrior([a], [2.0]).sample(torch.Generator().manual_seed(5), (4000,),
                                                   torch.float64)
    assert stats.kstest(scaled[:, 0].numpy(), stats.gamma(a, scale=2.0).cdf).pvalue > 1e-3
