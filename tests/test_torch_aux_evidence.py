"""The port's GPModel with means, diagonal noise and input warps against
the JAX package, float64.

Each model of the reference's widened fused-evidence set
(`tests/test_evidence_pallas.py::_model_variants`: Matern-5/2 with slopes,
Gibbs-tanh with an mtanh mean, SE with diagonal noise, BetaWarp-ed
Matern-5/2 with a linear mean, BetaWarp-ed SE with slopes) is rebuilt from
a numpy seed in the JAX package and carried across with `convert`. The
port's `log_marginal_batch` is held to JAX's ``evidence_backend="xla"``
path (which `test_widened_pallas_paths_match_xla` ties to the Pallas
kernel): ll rtol 1e-9, the full theta gradient rtol 1e-6 / atol 1e-9 (that
test's tolerances), `log_posterior_u_batch` and its gradient at 1e-9; config 3 the same way.
The aux cotangents of the kernel's plain version are held to the Pallas
kernel itself in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptools_tpu.models.dataset import DatasetBuilder
from gptools_tpu.models.gp import GPModel as JGPModel
from gptools_tpu.models.mean import LinearMeanFunction, MtanhMeanFunction1d
from gptools_tpu.ops import evidence_pallas
from gptools_tpu.ops.kernels import (
    BetaWarp,
    DiagonalNoiseKernel,
    GibbsKernel1dTanh,
    Matern52Kernel,
    SquaredExponentialKernel,
    WarpedKernel,
)
from gptools_tpu_torch import convert
from gptools_tpu_torch.ops import evidence_cuda
from test_torch_kinds import check_config_against_jax

torch.set_num_threads(1)

LL_TOL = dict(rtol=1e-9, atol=0.0)
GRAD_TOL = dict(rtol=1e-6, atol=1e-9)


def _data(rng, lo=0.0, hi=1.2, n_val=7, deriv=True):
    b = DatasetBuilder(1)
    X = np.sort(rng.uniform(lo, hi, n_val))
    b.add(X, np.sin(X), err_y=0.1)
    if deriv:
        b.add(np.array([lo, hi]), np.zeros(2), err_y=0.05, n=1)
    return b.build()


VARIANTS = {
    "matern52_deriv": (lambda: JGPModel(Matern52Kernel(), evidence_backend="xla"), {}),
    "gibbs_mtanh_mean": (
        lambda: JGPModel(GibbsKernel1dTanh(), mean=MtanhMeanFunction1d(),
                         evidence_backend="xla"), {}),
    "se_noise": (
        lambda: JGPModel(SquaredExponentialKernel(),
                         noise_kernel=DiagonalNoiseKernel(n=0), evidence_backend="xla"),
        {}),
    "config3_warped_matern_mean": (
        lambda: JGPModel(WarpedKernel(Matern52Kernel(), BetaWarp()),
                         mean=LinearMeanFunction(), evidence_backend="xla"),
        dict(lo=0.05, hi=0.95, deriv=False)),
    "warped_se_deriv": (
        lambda: JGPModel(WarpedKernel(SquaredExponentialKernel(), BetaWarp()),
                         evidence_backend="xla"),
        dict(lo=0.05, hi=0.95, deriv=True)),
}


def _port_model(jm):
    """The port's model of a variant on its evidence kernel (the plain
    version on the CPU): the reference models ask for ``"xla"``, the path
    the kernel is held to, and `convert` carries that choice across."""
    tm = convert.model_from_jax(jm)
    assert tm.evidence_backend == "xla"
    tm.evidence_backend = "auto"
    return tm


def _jax_reference(jm, data, thetas, us):
    """ll and its theta gradient, the u-space log posterior and its
    gradient, in one compiled call."""

    @jax.jit
    def f(t, u):
        ll, pull = jax.vjp(lambda s: jm.log_marginal_batch(s, data), t)
        lp, pull_u = jax.vjp(lambda v: jm.log_posterior_u_batch(v, data), u)
        return ll, pull(jnp.ones_like(ll))[0], lp, pull_u(jnp.ones_like(lp))[0]

    return [np.asarray(a) for a in f(jnp.asarray(thetas), jnp.asarray(us))]


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_matches_jax(name):
    mk, kw = VARIANTS[name]
    rng = np.random.default_rng(list(VARIANTS).index(name))
    jm, data = mk(), _data(rng, **kw)
    tm = _port_model(jm)
    td = convert.dataset_from_jax(data, torch.float64, "cpu")
    assert tm.param_names == jm.param_names
    thetas = np.abs(rng.uniform(0.4, 1.2, (6, jm.num_params)))
    us = np.asarray(jax.vmap(jm.u_of_theta)(jnp.asarray(thetas)))
    us = us + 0.1 * rng.standard_normal(us.shape)
    ll_j, g_j, lp_j, gu_j = _jax_reference(jm, data, thetas, us)

    t = torch.tensor(thetas, requires_grad=True)
    ll = tm.log_marginal_batch(t, td)
    (g,) = torch.autograd.grad(ll.sum(), t)
    np.testing.assert_allclose(ll.detach().numpy(), ll_j, **LL_TOL)
    np.testing.assert_allclose(g.numpy(), g_j, **GRAD_TOL)

    u = torch.tensor(us, requires_grad=True)
    lp = tm.log_posterior_u_batch(u, td)
    (gu,) = torch.autograd.grad(lp.sum(), u)
    np.testing.assert_allclose(lp.detach().numpy(), lp_j, rtol=1e-9)
    np.testing.assert_allclose(gu.numpy(), gu_j, rtol=1e-9, atol=1e-9)


def test_config3_matches_jax():
    """Config 3 (BetaWarp-ed Matern-5/2 with a linear mean), as
    test_torch_kinds.py holds config 2."""
    check_config_against_jax(3)


def test_variant_aux_channels(rng):
    """Each model hands the kernel the aux set the reference builds."""
    want = {
        "matern52_deriv": [],
        "gibbs_mtanh_mean": ["mu"],
        "se_noise": ["nd"],
        "config3_warped_matern_mean": ["mu", "w"],
        "warped_se_deriv": ["w", "wp"],
    }
    for name, (mk, kw) in VARIANTS.items():
        jm, data = mk(), _data(rng, **kw)
        tm = _port_model(jm)
        td = convert.dataset_from_jax(data, torch.float64, "cpu")
        th = torch.tensor(np.abs(rng.uniform(0.4, 1.2, (3, jm.num_params))))
        thT, ev, aux = tm._evidence_inputs(th.T, td)
        assert sorted(aux) == want[name], name
        assert thT.shape == (evidence_cuda.KINDS[ev.kind], 3)
        assert all(a.shape == (ev.n, 3) for a in aux.values())


@pytest.mark.parametrize("kind", ["se", "matern52"])
def test_plain_aux_cotangents_match_pallas_kernel(rng, kind):
    """The plain version's gradients into theta and into every aux channel
    against the reference's Pallas kernel (interpret mode) on the same aux
    inputs: slopes interleaved, mean, noise and a monotone warp."""
    n = 7
    X = np.sort(rng.uniform(0.05, 0.95, n))
    nid = np.array([0, 1, 0, 0, 1, 0, 0])
    y = rng.standard_normal(n)
    err2 = np.full(n, 0.01)
    C = 5
    thetaT = np.stack([rng.uniform(0.5, 2.0, C), rng.uniform(0.2, 1.0, C)])
    p = rng.uniform(0.7, 1.5, C)[None, :]
    aux = {
        "mu": 0.3 * rng.standard_normal((n, C)),
        "nd": rng.uniform(0.001, 0.05, (n, C)),
        "w": X[:, None] ** p,
        "wp": p * X[:, None] ** (p - 1.0),
    }
    vag = evidence_pallas.build_loglik_vag(
        kind, X, nid, y, err2, 1e2, interpret=True,
        has_mean=True, has_noise=True, warped=True,
    )
    ll_p, g_p, ga_p = vag(jnp.asarray(thetaT), {k: jnp.asarray(v) for k, v in aux.items()})
    ev = evidence_cuda.make_data(X, nid, y, err2, 1e2, "cpu", kind)
    ll, g, ga = evidence_cuda.loglik_vag_plain(
        torch.tensor(thetaT), ev, {k: torch.tensor(v) for k, v in aux.items()}
    )
    np.testing.assert_allclose(ll.numpy(), np.asarray(ll_p), **LL_TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_p), rtol=1e-7, atol=1e-9)
    for k in aux:
        np.testing.assert_allclose(ga[k].numpy(), np.asarray(ga_p[k]), rtol=1e-7,
                                   atol=1e-9, err_msg=k)


def test_autograd_chains_aux_cotangents(rng):
    """`evidence_cuda.loglik` returns g * gaux for each aux input, so a
    cotangent on ll reaches whatever produced the aux channels."""
    n, C = 6, 4
    X = np.sort(rng.uniform(0.05, 0.95, n))
    ev = evidence_cuda.make_data(X, np.zeros(n), rng.standard_normal(n),
                                 np.full(n, 0.02), 1e2, "cpu", "se")
    thetaT = torch.tensor(np.stack([rng.uniform(0.5, 2.0, C), rng.uniform(0.2, 1.0, C)]),
                          requires_grad=True)
    mu = torch.tensor(0.2 * rng.standard_normal((n, C)), requires_grad=True)
    ct = torch.tensor(rng.uniform(0.5, 2.0, C))
    ll = evidence_cuda.loglik(thetaT, ev, {"mu": mu})
    g_th, g_mu = torch.autograd.grad(ll, (thetaT, mu), ct)
    _, grad, gaux = evidence_cuda.loglik_vag_plain(thetaT.detach(), ev, {"mu": mu.detach()})
    np.testing.assert_allclose(g_th.numpy(), (ct * grad).numpy(), rtol=1e-12)
    np.testing.assert_allclose(g_mu.numpy(), (ct * gaux["mu"]).numpy(), rtol=1e-12)


def test_aux_set_is_checked():
    n = 4
    X = np.linspace(0.1, 0.9, n)
    ev = evidence_cuda.make_data(X, [0, 1, 0, 0], np.zeros(n), np.full(n, 0.01),
                                 1e2, "cpu", "se")
    th = torch.ones(2, 3, dtype=torch.float64)
    w = torch.ones(n, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match="wp"):
        evidence_cuda.vag(th, ev, {"w": w})  # slope rows need the warp slope
    with pytest.raises(ValueError, match="unknown aux"):
        evidence_cuda.vag(th, ev, {"sigma": w})
    with pytest.raises(ValueError, match="aux mu"):
        evidence_cuda.vag(th, ev, {"mu": w[:, :2]})
    gev = evidence_cuda.make_data(X, [0, 1, 0, 0], np.zeros(n), np.full(n, 0.01), 1e2, "cpu")
    with pytest.raises(ValueError, match="input-warped"):
        evidence_cuda.vag(torch.ones(5, 3, dtype=torch.float64), gev, {"w": w, "wp": w})
    with pytest.raises(ValueError, match="unknown evidence kind"):
        evidence_cuda.make_data(X, np.zeros(n), np.zeros(n), np.full(n, 0.01), 1e2,
                                "cpu", "rq")
    assert evidence_cuda._LIB is None  # nothing was built
