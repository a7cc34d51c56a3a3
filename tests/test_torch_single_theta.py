"""The port's single-theta GP surface against the JAX package, float64.

- the covariance kernel's plain version (`cov_cuda.se_cov` /
  `gibbs_tanh_cov` on CPU tensors) against the reference's Pallas kernel in
  interpret mode, at N = 22 with slopes and N = 150 (the reference's 2 x 2
  tile grid), one theta and a batch of 4, with ids outside {0, 1}: K rtol
  1e-12 (atol 1e-14 max|K| for entries near zero);
- the VJPs' backward against ``jax.vjp`` of the fused builders, rtol 1e-10;
- `assemble.cov_matrix` / `delta_matrix` against the reference's, 1e-12;
- configs 4 and 2 and the ``se_noise`` model through the port's
  ``generic``, ``fused`` and ``pallas`` backends against the reference's
  ``fused`` backend, and the ll against its ``generic`` one too (the
  reference's ``pallas`` backend runs only on a TPU; its forward is the
  fused formula and its backward exactly the fused builder's): `compute_K_L_alpha_ll` (L, alpha, ll) 1e-10; `log_marginal`
  and its gradient 1e-9 / atol 1e-10; `log_posterior_u` 1e-9;
  `predict` at 50 stars for n = 0 and 1, with and without ``noise`` and
  with an ``output_transform``: mean, std and cov 1e-9 (atol 1e-12);
- star orders the data lack (n = 2 stars on config 2, n = 1 stars on the
  value-only se_noise data), and a theta batch against the single-theta
  calls.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptools_tpu import configs as jconfigs
from gptools_tpu.models.dataset import DatasetBuilder as JBuilder
from gptools_tpu.models.gp import GPModel as JGPModel
from gptools_tpu.ops import assemble as jassemble
from gptools_tpu.ops import evidence as jevidence
from gptools_tpu.ops import fused as jfused
from gptools_tpu.ops import kernels as jk
from gptools_tpu.ops import pallas_cov
from gptools_tpu_torch import convert
from gptools_tpu_torch.ops import assemble, cov_cuda, kernels
from gptools_tpu_torch.ops.kernels import GibbsKernel, LengthScaleWarp

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
RTOL_K = 1e-12
NSTAR = 50


def _golden_mean(config):
    with open(os.path.join(HERE, f"golden_config{config}.json")) as f:
        return np.asarray(json.load(f)["mean"])


def _points(rng, n, slopes):
    X = np.sort(rng.uniform(0.0, 1.2, n))
    nid = np.zeros(n, np.int32)
    if slopes:
        nid[rng.choice(n, n // 4, replace=False)] = 1
    return X, nid


_KIND = {
    "se": (pallas_cov.se_cov, cov_cuda.se_cov, jfused.se_cov_fused, cov_cuda.se_cov_vjp,
           (0.4, 1.6)),
    "gibbs_tanh": (pallas_cov.gibbs_tanh_cov, cov_cuda.gibbs_tanh_cov,
                   jfused.gibbs_tanh_cov_fused, cov_cuda.gibbs_tanh_cov_vjp, (0.15, 1.1)),
}


def _thetas(rng, kind, B):
    lo, hi = _KIND[kind][4]
    th = rng.uniform(lo, hi, (B, 2 if kind == "se" else 5))
    if kind == "gibbs_tanh":
        th[:, 3] = rng.uniform(0.05, 0.2, B)  # transition width
        th[:, 4] = rng.uniform(0.7, 1.0, B)  # transition location
    return th


def _assert_k(a, b):
    np.testing.assert_allclose(a, b, rtol=RTOL_K, atol=1e-14 * np.abs(b).max())


@pytest.mark.parametrize("kind", ["se", "gibbs_tanh"])
@pytest.mark.parametrize("n, slopes", [(22, True), (150, True)], ids=["n22", "n150"])
def test_plain_cov_matches_interpreted_pallas(kind, n, slopes):
    rng = np.random.default_rng([n, kind == "se"])
    X, nid = _points(rng, n, slopes)
    nid[[3, n - 2]] = [-1, 2]  # ids outside {0, 1}: exact zeros
    pallas_fn, port_fn, _, _, _ = _KIND[kind]
    thetas = _thetas(rng, kind, 4)
    K_port = port_fn(torch.tensor(X), torch.tensor(nid), torch.tensor(thetas)).numpy()
    assert K_port.shape == (4, n, n)
    for b in range(4) if n == 22 else (0,):
        K_ref = np.asarray(pallas_fn(jnp.asarray(X), jnp.asarray(nid),
                                     jnp.asarray(thetas[b]), interpret=True))
        _assert_k(K_port[b], K_ref)
    one = port_fn(torch.tensor(X), torch.tensor(nid), torch.tensor(thetas[1])).numpy()
    np.testing.assert_array_equal(one, K_port[1])
    for bad in (3, n - 2):
        assert (K_port[:, bad, :] == 0).all() and (K_port[:, :, bad] == 0).all()


@pytest.mark.parametrize("kind", ["se", "gibbs_tanh"])
def test_cov_vjp_backward_matches_jax(kind):
    rng = np.random.default_rng(5)
    X, nid = _points(rng, 17, True)
    _, _, fused_fn, vjp_fn, _ = _KIND[kind]
    gK = rng.standard_normal((3, 17, 17))
    thetas = _thetas(rng, kind, 3)
    th = torch.tensor(thetas, requires_grad=True)
    K = vjp_fn(torch.tensor(X), torch.tensor(nid), th)
    (g,) = torch.autograd.grad(K, th, torch.tensor(gK))
    for b in range(3):
        _, pull = jax.vjp(lambda t: fused_fn(jnp.asarray(X), jnp.asarray(nid), t),
                          jnp.asarray(thetas[b]))
        (g_ref,) = pull(jnp.asarray(gK[b]))
        np.testing.assert_allclose(g[b].numpy(), np.asarray(g_ref), rtol=1e-10, atol=1e-12)


def _kernel_pair(name):
    if name == "se":
        return jk.SquaredExponentialKernel(), kernels.SquaredExponentialKernel(), [1.3, 0.45]
    if name == "gibbs_tanh":
        return jk.GibbsKernel1dTanh(), kernels.GibbsKernel1dTanh(), [1.1, 0.5, 0.1, 0.12, 0.8]
    return jk.DiagonalNoiseKernel(n=0), kernels.DiagonalNoiseKernel(n=0), [0.3]


@pytest.mark.parametrize("name", ["se", "gibbs_tanh", "noise"])
def test_assemble_matches_jax(name):
    """Mixed orders on both sides ({0, 1, 2}; {0, 1} for Gibbs, whose
    fourth derivatives the reference compiles slowly), repeated points
    across the sets (the noise couples them), a theta batch of 2."""
    jker, tker, theta = _kernel_pair(name)
    rng = np.random.default_rng(7)
    X1 = np.sort(rng.uniform(0.0, 1.2, 9))[:, None]
    X2 = np.concatenate([X1[::2], rng.uniform(0.0, 1.2, (4, 1))])
    table = ((0,), (1,)) if name == "gibbs_tanh" else ((0,), (1,), (2,))
    n1 = rng.integers(0, len(table), 9).astype(np.int32)
    n2 = np.concatenate([n1[::2], rng.integers(0, len(table), 4)]).astype(np.int32)
    thetas = np.stack([theta, np.asarray(theta) * 1.1])
    args_j = (jnp.asarray(X1), jnp.asarray(n1), jnp.asarray(X2), jnp.asarray(n2), table)
    args_t = (torch.tensor(X1), torch.tensor(n1), torch.tensor(X2), torch.tensor(n2), table)
    K_t = assemble.cov_matrix(tker, torch.tensor(thetas), *args_t).numpy()
    D_t = assemble.delta_matrix(tker, torch.tensor(thetas), *args_t).numpy()
    for b in range(2):
        K_j = np.asarray(jassemble.cov_matrix(jker, jnp.asarray(thetas[b]), *args_j))
        D_j = np.asarray(jassemble.delta_matrix(jker, jnp.asarray(thetas[b]), *args_j))
        np.testing.assert_allclose(K_t[b], K_j, rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(D_t[b], D_j, rtol=1e-12, atol=0)
    K_one = assemble.cov_matrix(tker, torch.tensor(thetas[0]), *args_t).numpy()
    np.testing.assert_array_equal(K_one, K_t[0])


def test_kernel_call_and_scalars():
    """The reference's per-pair entry, ``k(x1, x2, theta, ni, nj)``."""
    for name in ("se", "gibbs_tanh"):
        jker, tker, theta = _kernel_pair(name)
        for ni, nj in ((0, 0), (1, 0), (0, 1), (1, 1)):
            a = float(tker([0.3], [0.55], torch.tensor(theta, dtype=torch.float64), ni, nj))
            b = float(jker(jnp.asarray([0.3]), jnp.asarray([0.55]), jnp.asarray(theta), ni, nj))
            assert abs(a - b) <= 1e-13 * max(1.0, abs(b))
    assert kernels.DiagonalNoiseKernel().has_smooth is False
    for ni, nj in ((0, 0), (1, 1)):  # the Matern scalar, now ported
        a = float(kernels.Matern52Kernel()([0.3], [0.55],
                                           torch.tensor([1.1, 0.4], dtype=torch.float64), ni, nj))
        b = float(jk.Matern52Kernel()(jnp.asarray([0.3]), jnp.asarray([0.55]),
                                      jnp.asarray([1.1, 0.4]), ni, nj))
        assert abs(a - b) <= 1e-13 * max(1.0, abs(b))

    class OtherWarp(LengthScaleWarp):
        param_names = ("l0",)
        default_bounds = ((0.1, 1.0),)

    with pytest.raises(ValueError, match="TanhWarp"):
        cov_cuda.cov_matrix_flagship(GibbsKernel(OtherWarp()), torch.ones(2), None)
    data = convert.dataset_from_jax(_se_noise_data(), torch.float64, "cpu")
    assert cov_cuda.cov_supported(kernels.SquaredExponentialKernel(), data)
    assert cov_cuda.cov_supported(kernels.GibbsKernel1dTanh(), data)
    assert not cov_cuda.cov_supported(kernels.Matern52Kernel(), data)
    assert not cov_cuda.cov_supported(GibbsKernel(OtherWarp()), data)
    K = cov_cuda.cov_matrix_flagship(kernels.SquaredExponentialKernel(),
                                     torch.tensor([1.2, 0.4]), data)
    np.testing.assert_array_equal(K.numpy(), cov_cuda.se_cov(
        data.Xf[:, 0], data.nid, torch.tensor([1.2, 0.4])).numpy())


# ---- the GP surface, per model and backend ---------------------------------


def _se_noise_data():
    """Values only: slope stars are an order the data lack."""
    rng = np.random.default_rng(5)
    b = JBuilder(1)
    X = np.sort(rng.uniform(0.0, 1.2, 9))
    b.add(X, np.sin(X), err_y=0.1)
    return b.build(dtype=jnp.float64)


def _problem(name):
    """(JAX model with the fused backend, JAX data, theta)."""
    if name == "config4":
        p = jconfigs.config4_gibbs_smc()
        return JGPModel(p.model.kernel, cov_backend="fused"), p.data, _golden_mean(4)
    if name == "config2":
        p = jconfigs.config2_se_deriv_nuts()
        return JGPModel(p.model.kernel, cov_backend="fused"), p.data, _golden_mean(2)
    model = JGPModel(jk.SquaredExponentialKernel(), noise_kernel=jk.DiagonalNoiseKernel(n=0),
                     cov_backend="fused")
    return model, _se_noise_data(), np.array([1.1, 0.45, 0.2])


# per model, (star orders, noise, output_transform?): "mixed" is the 50
# stars at n = 0 followed by the same 50 at n = 1; noise only where the
# model has a noise kernel; n = 2 on config 2 is an order its data lack, as
# n = 1 is on the value-only se_noise data
_CASES = {
    "config4": [("mixed", False, False), (1, False, True)],
    "config2": [("mixed", False, False), (2, False, True)],
    "se_noise": [("mixed", False, False), ("mixed", True, True)],
}


def _stars(xs, n):
    if n == "mixed":
        return np.concatenate([xs, xs]), np.repeat([0, 1], xs.shape[0])
    return xs, n


@pytest.fixture(scope="module", params=["config4", "config2", "se_noise"])
def surface(request):
    """The reference's values for one model, computed once (jitted)."""
    name = request.param
    jm, jdata, theta = _problem(name)
    rng = np.random.default_rng(3)
    xs = np.linspace(-0.1, float(np.asarray(jdata.Xf).max()) + 0.1, NSTAR)
    O = {k: rng.standard_normal((6, k)) for k in (NSTAR, 2 * NSTAR)}
    th = jnp.asarray(theta)
    u = jm.u_of_theta(th)
    state = jax.jit(lambda t: jm.compute_K_L_alpha_ll(t, jdata))(th)
    jg = JGPModel(jm.kernel, noise_kernel=jm.noise_kernel, cov_backend="generic")
    ll_generic = jax.jit(lambda t: jg.compute_K_L_alpha_ll(t, jdata).ll)(th)
    lm, g = jax.jit(jax.value_and_grad(lambda t: jm.log_marginal(t, jdata)))(th)
    # log_posterior_u from its parts (ll + log prior + log|det J|), so the
    # reference compiles its factorization twice, not three times
    lpu = lm + jm.log_prior(th) + jm.bijector.log_det_jac(u)
    preds = {}
    for n, noise, with_o in _CASES[name]:
        x, nn = _stars(xs, n)
        pj = jax.jit(lambda t, s: jm.predict(
            t, jdata, x, n=nn, noise=noise, return_std=True, return_cov=True,
            output_transform=O[x.shape[0]] if with_o else None, state=s))(th, state)
        preds[(n, noise, with_o)] = tuple(np.asarray(a) for a in pj)
    ref = dict(L=state.L, alpha=state.alpha, ll=state.ll, lm=lm, g=g, u=u, lpu=lpu,
               ll_generic=ll_generic)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    ref["preds"] = preds
    return dict(name=name, jm=jm, jdata=jdata, theta=theta, xs=xs, O=O, ref=ref,
                tdata=convert.dataset_from_jax(jdata, torch.float64, "cpu"))


@pytest.mark.parametrize("backend", ["generic", "fused", "pallas"])
def test_surface_matches_jax(surface, backend):
    s, ref = surface, surface["ref"]
    tm = convert.model_from_jax(s["jm"])
    tm.cov_backend = backend
    data = s["tdata"]
    n0 = dict(cov_cuda.PLAIN_CALLS)
    st = tm.compute_K_L_alpha_ll(torch.tensor(s["theta"]), data)
    np.testing.assert_allclose(st.L.numpy(), ref["L"], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(st.alpha.numpy(), ref["alpha"], rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(float(st.ll), ref["ll"], rtol=1e-10)
    np.testing.assert_allclose(float(st.ll), ref["ll_generic"], rtol=1e-10)
    assert bool(st.ok)
    if backend == "pallas":  # the kernel's route, here its plain version
        assert sum(cov_cuda.PLAIN_CALLS.values()) == sum(n0.values()) + 1

    th = torch.tensor(s["theta"], requires_grad=True)
    lm = tm.log_marginal(th, data)
    (g,) = torch.autograd.grad(lm, th)
    np.testing.assert_allclose(float(lm.detach()), ref["lm"], rtol=1e-9)
    np.testing.assert_allclose(g.numpy(), ref["g"], rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(float(tm.log_posterior_u(torch.tensor(ref["u"]), data)),
                               ref["lpu"], rtol=1e-9)

    for (n, noise, with_o), pj in ref["preds"].items():
        x, nn = _stars(s["xs"], n)
        pt = tm.predict(torch.tensor(s["theta"]), data, x, n=nn, noise=noise,
                        return_std=True, return_cov=True,
                        output_transform=s["O"][x.shape[0]] if with_o else None, state=st)
        for a, b in zip((pt.mean, pt.std, pt.cov), pj):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-9, atol=1e-12,
                                       err_msg=f"{s['name']} {backend} n={n}")


@pytest.mark.parametrize("config", [4, 2])
def test_pallas_backend_makes_points_once_per_dataset(config):
    """A `GPModel` on the "pallas" backend makes the covariance kernel's
    points of its dataset once: every covariance of the same `Dataset`
    (a batch and a single theta) reuses them, another `Dataset` gets its
    own, and K is the fused backend's at 1e-12."""
    from gptools_tpu_torch import configs
    from gptools_tpu_torch.models.gp import GPModel

    prob = configs.ALL_CONFIGS[config](dtype=torch.float64, device="cpu")
    model = GPModel(prob.model.kernel, cov_backend="pallas")
    fused_model = GPModel(prob.model.kernel, cov_backend="fused")
    th = torch.tensor(model.initial_params, dtype=torch.float64)
    K1 = model._latent_cov(th, prob.data, False)
    data, pts = model._points_cache
    assert data is prob.data and pts.n == prob.data.num_obs
    K2 = model._latent_cov(torch.stack([th, th]), prob.data, False)
    assert model._points_cache[1] is pts
    ref = fused_model._latent_cov(th, prob.data, False)
    np.testing.assert_allclose(K1.numpy(), ref.numpy(), rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(K2[1].numpy(), K1.numpy())
    other = configs.ALL_CONFIGS[config](dtype=torch.float64, device="cpu").data
    model._latent_cov(th, other, False)
    assert model._points_cache[0] is other and model._points_cache[1] is not pts


def test_theta_batch_matches_single_theta(surface):
    """A (3, P) theta batch, where the reference vmaps: one batched call of
    each method equals the single-theta calls (themselves held to the
    reference above)."""
    s = surface
    tm = convert.model_from_jax(s["jm"])
    tm.cov_backend = "pallas"
    data, x = s["tdata"], s["xs"][::5]
    th = torch.tensor(s["theta"] * np.array([[1.0], [1.05], [0.95]]))
    st = tm.compute_K_L_alpha_ll(th, data)
    pt = tm.predict(th, data, x, n=[0, 1] * 5, state=st, return_cov=True)
    lm = tm.log_marginal(th, data)
    for b in range(3):
        one = tm.predict(th[b], data, x, n=[0, 1] * 5, return_cov=True)
        np.testing.assert_allclose(float(lm[b]), float(tm.log_marginal(th[b], data)), rtol=1e-13)
        for a, c in ((pt.mean[b], one.mean), (pt.std[b], one.std), (pt.cov[b], one.cov)):
            np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-12, atol=1e-14)


def test_config3_single_theta_matches_batch_evidence():
    """Config 3 (warped Matern-5/2 with a linear mean) takes the fused
    single-theta build: its ll equals the batch evidence path's (held to
    the reference in test_torch_aux_evidence.py); its prediction, through
    the Matern and warped scalars, is held to the reference in
    test_torch_warped_matern.py and is finite here on both backends."""
    from gptools_tpu_torch import configs

    prob = configs.config3_matern_mean_warp_hmc(device="cpu")
    theta = torch.tensor(_golden_mean(3))
    for backend in ("fused", "pallas"):
        prob.model.cov_backend = backend
        st = prob.model.compute_K_L_alpha_ll(theta, prob.data)
        lb = prob.model.log_marginal_batch(theta[None], prob.data)
        np.testing.assert_allclose(float(st.ll), float(lb[0]), rtol=1e-11)
        pred = prob.model.predict(theta, prob.data, [0.2, 0.5], n=1)
        assert bool(torch.isfinite(pred.mean).all()) and bool((pred.std > 0).all())


def test_failed_factor_contract():
    """A factor that fails gives NaN in L, ok False, ll = -inf and a zero
    cotangent; a batch fails only where its matrix does."""
    from gptools_tpu_torch.ops import evidence

    good = torch.tensor([[2.0, 0.5], [0.5, 1.0]], dtype=torch.float64)
    bad = torch.tensor([[1.0, 2.0], [2.0, 1.0]], dtype=torch.float64)
    K = torch.stack([good, bad]).requires_grad_(True)
    r = torch.tensor([[0.3, -0.2], [0.1, 0.4]], dtype=torch.float64, requires_grad=True)
    st = evidence.gaussian_loglik(K.detach(), r.detach())
    assert st.ok.tolist() == [True, False] and float(st.ll[1]) == -np.inf
    assert bool(torch.isnan(st.L[1]).all()) and bool(torch.isfinite(st.L[0]).all())
    ll = evidence.loglik(K, r)
    gK, gr = torch.autograd.grad(ll.sum(), (K, r))
    assert float(ll[1].detach()) == -np.inf and bool((gK[1] == 0).all())
    assert bool((gr[1] == 0).all())
    ref = jax.grad(lambda k, v: jnp.sum(jax.vmap(
        jevidence.loglik)(k, v)),
        argnums=(0, 1))(jnp.asarray(K.detach().numpy()), jnp.asarray(r.detach().numpy()))
    np.testing.assert_allclose(gK.numpy(), np.asarray(ref[0]), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(gr.numpy(), np.asarray(ref[1]), rtol=1e-12, atol=1e-14)
