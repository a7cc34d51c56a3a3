"""The port's batch evidence past its kernel against the JAX package,
float64 on the CPU.

- the route past N_MAX: config 4 at 60 points (N = 62) takes the
  chains-minor route (counted in ``evidence_cuda.ROUTE_CALLS``, not in
  ``PLAIN_CALLS``) and matches the reference's ``log_marginal_batch`` and
  its gradient at rtol 1e-9;
- ``evidence_backend``: each of "auto", "xla", "fused_pallas" is accepted,
  takes the kernel's plain version or the route as the reference's rules
  say, gives the same numbers, and survives `convert`; anything else
  raises ``ValueError``;
- the reference's other routes: a 2-D SE model and a mean at derivative
  order 2 (the per-chain route), an SE noise kernel and a
  `DiagonalNoiseKernel` on a repeated (x, order) row (the chains-minor
  route's noise term), and ``solve_dtype=float64`` on float32 data: ll and
  gradient of ``log_marginal_batch``, `compute_K_L_alpha_ll` (L, alpha,
  ll) and the gradient of `log_marginal` at rtol 1e-9 (the float32 case
  at rtol 1e-5 and within 1e-4 of the largest component: the two
  float32 covariance builds differ by their roundings; its factorization
  in float64 is checked exactly);
- the per-chain route in chunks gives the unchunked values and gradients;
- the single-point surface of the means (`MeanFunction.scalar`, `block_fn`
  and ``__call__(x, theta, n)`` at orders 0, 1 and 2 for every mean),
  `ops.assemble.mean_vector` (one theta and a batch),
  `ops.derivs.normalize_multi_index` (values and refusals) and
  `Dataset.has_transform` / `astype` against the reference's: 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptools_tpu import configs as jconfigs
from gptools_tpu.models import mean as jmean
from gptools_tpu.models.dataset import DatasetBuilder as JBuilder
from gptools_tpu.models.gp import GPModel as JGPModel
from gptools_tpu.ops import kernels as jk
from gptools_tpu_torch import configs as tconfigs
from gptools_tpu_torch import convert
from gptools_tpu_torch.models import gp as tgp
from gptools_tpu_torch.models import mean as tmean
from gptools_tpu_torch.ops import assemble as tassemble
from gptools_tpu_torch.ops import derivs as tderivs
from gptools_tpu_torch.ops import evidence, evidence_cuda

torch.set_num_threads(1)

GOLD_MEAN = np.array([0.6053, 1.0609, 0.2892, 0.0413, 0.9208])
GOLD_STD = np.array([0.2216, 0.2118, 0.1234, 0.0181, 0.0272])


def _config4_draws(C, seed):
    rng = np.random.default_rng(seed)
    return GOLD_MEAN + GOLD_STD * rng.uniform(-1.0, 1.0, (C, 5))


def _jax_ll_grad(jm, jd, th, w):
    """The reference's ``log_marginal_batch`` and the gradient of its
    w-weighted sum, in one compiled call."""

    @jax.jit
    def f(t):
        ll, pull = jax.vjp(lambda s: jm.log_marginal_batch(s, jd), t)
        return ll, pull(jnp.asarray(w, ll.dtype))[0]

    return tuple(np.asarray(a) for a in f(jnp.asarray(th)))


def _port_ll_grad(tm, td, th, w):
    t = torch.tensor(th, requires_grad=True)
    ll = tm.log_marginal_batch(t, td)
    (g,) = torch.autograd.grad((ll * torch.as_tensor(w, dtype=ll.dtype)).sum(), t)
    return ll.detach().numpy(), g.numpy()


def test_route_past_kernel_n62():
    """Config 4 at N = 62: the reference computes it (its Pallas kernel
    stops at 48); the port takes its chains-minor route there."""
    jp = jconfigs.config4_gibbs_smc(n_points=60)
    tp = tconfigs.config4_gibbs_smc(n_points=60, dtype=torch.float64, device="cpu")
    assert tp.data.num_obs == 62 > evidence_cuda.N_MAX
    assert tp.model._evidence_plan(tp.data) is None
    th = _config4_draws(8, seed=62)
    w = np.linspace(0.5, 2.0, 8)
    evidence_cuda.reset_counts()
    ll, g = _port_ll_grad(tp.model, tp.data, th, w)
    assert evidence_cuda.ROUTE_CALLS == {"chains_minor": 1, "per_chain": 0}
    assert sum(evidence_cuda.PLAIN_CALLS.values()) == 0
    # the reference's vmap(log_marginal), which its log_marginal_batch
    # equals (gp.py), compiles in a fraction of the chains-minor path's time
    jm = JGPModel(jp.model.kernel, evidence_backend="xla")
    f = jax.jit(jax.vmap(jax.value_and_grad(lambda t: jm.log_marginal(t, jp.data))))
    ll_j, g_j = (np.asarray(a) for a in f(jnp.asarray(th)))
    np.testing.assert_allclose(ll, ll_j, rtol=1e-9)
    np.testing.assert_allclose(g, w[:, None] * g_j, rtol=1e-9, atol=1e-9)


@pytest.fixture(scope="module")
def config4_reference():
    """Config 4's reference ll and gradient at six draws (compiled once)."""
    jp = jconfigs.config4_gibbs_smc()
    th, w = _config4_draws(6, seed=3), np.arange(1.0, 7.0)
    jm = JGPModel(jp.model.kernel, evidence_backend="xla")
    return jp, th, w, _jax_ll_grad(jm, jp.data, th, w)


@pytest.mark.parametrize("backend", ["auto", "xla", "fused_pallas"])
def test_evidence_backend(backend, config4_reference):
    """Each backend on config 4 (N = 27, where the kernel applies): "xla"
    takes the route, the others the kernel's plain version; the same ll and
    gradient as the reference's XLA path; carried by `convert`."""
    jp, th, w, (ll_j, g_j) = config4_reference
    tm = tgp.GPModel(tconfigs.config4_gibbs_smc(device="cpu").model.kernel,
                     evidence_backend=backend)
    assert tm.evidence_backend == backend
    td = convert.dataset_from_jax(jp.data, torch.float64, "cpu")
    evidence_cuda.reset_counts()
    ll, g = _port_ll_grad(tm, td, th, w)
    if backend == "xla":
        assert evidence_cuda.ROUTE_CALLS["chains_minor"] == 1
        assert sum(evidence_cuda.PLAIN_CALLS.values()) == 0
    else:
        assert evidence_cuda.PLAIN_CALLS["gibbs_tanh"] == 1
        assert sum(evidence_cuda.ROUTE_CALLS.values()) == 0
    np.testing.assert_allclose(ll, ll_j, rtol=1e-9)
    np.testing.assert_allclose(g, g_j, rtol=1e-9, atol=1e-9)
    jm = JGPModel(jp.model.kernel, evidence_backend=backend)
    assert convert.model_from_jax(jm).evidence_backend == backend
    with pytest.raises(ValueError, match="evidence_backend"):
        tgp.GPModel(jk.SquaredExponentialKernel(), evidence_backend="pallas")


def _values_1d(rng, repeat=False, order2=False):
    b = JBuilder(1)
    X = np.sort(rng.uniform(0.0, 1.2, 9))
    if repeat:
        X[4] = X[3]  # a repeated (x, order) row: the diagonal noise couples it
    b.add(X, np.sin(X), err_y=0.1)
    b.add(np.array([0.0, 1.2]), np.zeros(2), err_y=0.05, n=1)
    if order2:
        b.add(np.array([0.6]), np.array([-0.5]), err_y=0.2, n=2)
    return b


def _values_2d(rng):
    b = JBuilder(2)
    X = rng.uniform(0.0, 1.0, (10, 2))
    b.add(X, np.sin(X.sum(1)), err_y=0.1)
    return b


def _thetas(rng, name, C):
    if name == "gibbs_solve_dtype":
        return _config4_draws(C, seed=11)
    P = {"se_2d": 3, "se_noise_kernel": 4, "diag_noise_repeated": 3, "mean_order2": 7}[name]
    th = rng.uniform(0.3, 1.1, (C, P))
    if name == "mean_order2":  # mtanh (x0, delta, alpha, ped, off) near a pedestal
        th[:, 2:] = [0.9, 0.1, 0.2, 1.0, 0.0] + 0.05 * rng.standard_normal((C, 5))
    return th


# name -> (reference model, data builder, the port's route, dtype)
CASES = {
    "se_2d": (lambda: JGPModel(jk.SquaredExponentialKernel(num_dim=2)), _values_2d,
              "per_chain", np.float64),
    "se_noise_kernel": (
        lambda: JGPModel(jk.SquaredExponentialKernel(),
                         noise_kernel=jk.SquaredExponentialKernel()),
        _values_1d, "chains_minor", np.float64),
    "diag_noise_repeated": (
        lambda: JGPModel(jk.SquaredExponentialKernel(),
                         noise_kernel=jk.DiagonalNoiseKernel(n=0)),
        lambda rng: _values_1d(rng, repeat=True), "chains_minor", np.float64),
    "gibbs_solve_dtype": (lambda: JGPModel(jk.GibbsKernel1dTanh(), solve_dtype=jnp.float64),
                          _values_1d, "chains_minor", np.float32),
    "mean_order2": (
        lambda: JGPModel(jk.SquaredExponentialKernel(), mean=jmean.MtanhMeanFunction1d()),
        lambda rng: _values_1d(rng, order2=True), "per_chain", np.float64),
}


@pytest.mark.parametrize("name", list(CASES))
def test_reference_routes(name):
    mk, data_fn, route, dt = CASES[name]
    rng = np.random.default_rng(list(CASES).index(name))
    f32 = dt == np.float32
    jm, jd = mk(), data_fn(rng).build(dtype=jnp.float32 if f32 else jnp.float64)
    tm = convert.model_from_jax(jm)
    td = convert.dataset_from_jax(jd, torch.float32 if f32 else torch.float64, "cpu")
    assert tm._evidence_plan(td) is None
    th = _thetas(rng, name, 6).astype(dt)
    w = np.arange(1.0, 7.0).astype(dt)
    tol = dict(rtol=1e-5, atol=1e-6) if f32 else dict(rtol=1e-9, atol=1e-9)

    evidence_cuda.reset_counts()
    ll, g = _port_ll_grad(tm, td, th, w)
    assert evidence_cuda.ROUTE_CALLS[route] == 1 and sum(evidence_cuda.ROUTE_CALLS.values()) == 1
    ll_j, g_j = _jax_ll_grad(jm, jd, th, w)
    assert ll.dtype == ll_j.dtype == np.float64
    np.testing.assert_allclose(ll, ll_j, rtol=tol["rtol"])
    if f32:  # float32 gradients: within 1e-4 of the largest component
        tol = dict(rtol=1e-5, atol=1e-4 * np.abs(g_j).max())
    np.testing.assert_allclose(g, g_j, **tol)

    st = tm.compute_K_L_alpha_ll(torch.tensor(th[0]), td)
    t0 = torch.tensor(th[0], requires_grad=True)
    (g1,) = torch.autograd.grad(tm.log_marginal(t0, td), t0)

    @jax.jit
    def single(t):
        s = jm.compute_K_L_alpha_ll(t, jd)
        return s.L, s.alpha, s.ll, jax.grad(lambda u: jm.log_marginal(u, jd))(t)

    L_j, alpha_j, ll1_j, g1_j = (np.asarray(a) for a in single(jnp.asarray(th[0])))
    for a, b in ((st.L, L_j), (st.alpha, alpha_j), (st.ll, ll1_j), (g1, g1_j)):
        atol = 1e-4 * np.abs(b).max() if f32 else 1e-12
        np.testing.assert_allclose(a.numpy(), b, rtol=tol["rtol"], atol=atol)
    if f32:  # the factorization runs in float64 on the float32 covariance
        Kobs, r = tm.obs_cov_and_resid(torch.tensor(th[0]), td)
        assert Kobs.dtype == torch.float32 and st.L.dtype == torch.float64
        want = evidence.gaussian_loglik(Kobs.double(), r.double(), tm.diag_factor)
        assert float(st.ll) == float(want.ll)


def test_per_chain_route_in_chunks(monkeypatch):
    """A chunk budget of 3 chains gives the one-chunk values and gradients
    bit for bit (each chunk is the same batched single-theta call)."""
    rng = np.random.default_rng(9)
    jm, jd = CASES["se_2d"][0](), _values_2d(rng).build(dtype=jnp.float64)
    tm = convert.model_from_jax(jm)
    td = convert.dataset_from_jax(jd, torch.float64, "cpu")
    th = _thetas(rng, "se_2d", 8)
    w = np.arange(1.0, 9.0)
    whole = _port_ll_grad(tm, td, th, w)
    monkeypatch.setattr(tgp, "_PER_CHAIN_ENTRIES", 3 * td.num_latent**2)
    chunked = _port_ll_grad(tm, td, th, w)
    with torch.no_grad():
        no_grad = tm.log_marginal_batch(torch.tensor(th), td).numpy()
    for a, b in zip(chunked, whole):
        np.testing.assert_allclose(a, b, rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(no_grad, whole[0], rtol=1e-14)


def _means(mod, xp):
    """name -> (mean, theta) for every mean of the reference."""
    return {
        "constant": (mod.ConstantMeanFunction(), [0.7]),
        "linear": (mod.LinearMeanFunction(), [1.3, -0.4]),
        "linear_2d": (mod.LinearMeanFunction(2), [1.3, -0.4, 0.2]),
        "mtanh": (mod.MtanhMeanFunction1d(), [0.9, 0.05, 0.3, 1.0, 0.1]),
        "sum": (mod.MtanhMeanFunction1d() + mod.ConstantMeanFunction(),
                [0.9, 0.05, 0.3, 1.0, 0.1, -0.2]),
        "arbitrary": (mod.ArbitraryMeanFunction(
            lambda x, p: p[..., 0] * xp.sin(2.0 * x[..., 0]) + p[..., 1] * x[..., 0] ** 3,
            1, ("a", "b")), [0.8, -0.3]),
    }


_MEAN_ORDERS = {1: [0, 1, 2], 2: [(0, 0), (1, 0), (0, 2)]}


@pytest.mark.parametrize("name", ["constant", "linear", "linear_2d", "mtanh", "sum",
                                  "arbitrary"])
@pytest.mark.parametrize("order", [0, 1, 2])
def test_mean_function_calls_match_jax(rng, name, order):
    jm, th = _means(jmean, jnp)[name]
    tm, _ = _means(tmean, torch)[name]
    D = jm.num_dim
    n = _MEAN_ORDERS[D][order]
    X = rng.uniform(0.0, 1.5, (6, D))
    a = _jax_multi_index(n, D)
    want = np.asarray(jax.vmap(jm.block_fn(a), in_axes=(0, None))(jnp.asarray(X),
                                                                    jnp.asarray(th)))
    got = tm.block_fn(a)(torch.tensor(X), torch.tensor(th, dtype=torch.float64))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-13)
    for i in range(2):
        one = tm(X[i], th, n=n)
        np.testing.assert_allclose(float(one), float(jm(X[i], th, n=n)), rtol=1e-12,
                                   atol=1e-13)
    if order == 0:
        np.testing.assert_allclose(tm.scalar(torch.tensor(X[0]),
                                             torch.tensor(th, dtype=torch.float64)).item(),
                                   float(jm.scalar(jnp.asarray(X[0]), jnp.asarray(th))),
                                   rtol=1e-12)


def _jax_multi_index(n, D):
    from gptools_tpu.ops.derivs import normalize_multi_index

    return normalize_multi_index(n, D)


@pytest.mark.parametrize("batch", [False, True])
def test_assemble_mean_vector_matches_jax(rng, batch):
    from gptools_tpu.ops import assemble as jassemble

    jm, th = _means(jmean, jnp)["sum"]
    tm, _ = _means(tmean, torch)["sum"]
    X = rng.uniform(0.0, 1.5, (9, 1))
    nid = np.array([0, 1, 2, 0, 0, 1, 2, 2, 0])
    mis = ((0,), (1,), (2,))
    thetas = np.asarray(th) + 0.05 * rng.standard_normal((3, len(th)))
    want = np.stack([np.asarray(jassemble.mean_vector(jm, jnp.asarray(t), jnp.asarray(X),
                                                      jnp.asarray(nid), mis)) for t in thetas])
    arg = thetas if batch else thetas[0]
    got = tassemble.mean_vector(tm, torch.tensor(arg), torch.tensor(X), torch.tensor(nid), mis)
    np.testing.assert_allclose(got.numpy(), want if batch else want[0], rtol=1e-12,
                               atol=1e-13)


_MULTI_INDEX_CASES = [(0, 1), (2, 1), (0, 3), ((1, 0), 2), ((0, 2, 1), 3), (-1, 1), (1, 2),
                      ((1,), 2), ((-1, 0), 2)]


@pytest.mark.parametrize("case", range(len(_MULTI_INDEX_CASES)))
def test_normalize_multi_index_matches_jax(case):
    from gptools_tpu.ops import derivs as jderivs

    n, D = _MULTI_INDEX_CASES[case]
    try:
        want = jderivs.normalize_multi_index(n, D)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:20]):
            tderivs.normalize_multi_index(n, D)
        return
    got = tderivs.normalize_multi_index(n, D)
    assert got == want and type(got) is tuple


@pytest.mark.parametrize("config", [4, 5])
def test_dataset_has_transform_and_astype_match_jax(config):
    jd = jconfigs.ALL_CONFIGS[config]().data
    td = tconfigs.ALL_CONFIGS[config](device="cpu").data
    assert td.has_transform == jd.has_transform == (config == 5)
    j32, t32 = jd.astype(jnp.float32), td.astype(torch.float32)
    for a in ("Xf", "y", "err_y") + (("T",) if config == 5 else ()):
        assert getattr(t32, a).dtype == torch.float32
        np.testing.assert_array_equal(getattr(t32, a).numpy(), np.asarray(getattr(j32, a)))
    np.testing.assert_array_equal(t32.nid.numpy(), np.asarray(j32.nid))
    assert t32.multi_indices == j32.multi_indices and t32.device == td.device
