"""The evidence kernel's plain version (`evidence_cuda.loglik_vag_plain`,
the port's CPU route) against the JAX package, float64.

- at config 4 against `GPModel.log_marginal_batch(evidence_backend="xla")`
  and its VJP (ll rtol 1e-9; grad rtol 1e-7, atol 1e-9: the tolerances of
  tests/test_evidence_pallas.py);
- at N = 8 against the Pallas kernel itself (`build_loglik_vag`, interpret
  mode), as tests/test_evidence_pallas.py runs it;
- the covariance build and the batched evidence's backward piece by piece;
- the -inf contract and the wrapper's input checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptools_tpu import configs as jconfigs
from gptools_tpu.models.gp import GPModel as JGPModel
from gptools_tpu.ops import evidence as jevidence
from gptools_tpu.ops import evidence_pallas, fused as jfused
from gptools_tpu_torch import convert
from gptools_tpu_torch.ops import evidence as tevidence
from gptools_tpu_torch.ops import evidence_cuda, fused as tfused

torch.set_num_threads(1)

LL_TOL = dict(rtol=1e-9, atol=0.0)
GRAD_TOL = dict(rtol=1e-7, atol=1e-9)
GOLD_MEAN = np.array([0.6053, 1.0609, 0.2892, 0.0413, 0.9208])
GOLD_STD = np.array([0.2216, 0.2118, 0.1234, 0.0181, 0.0272])


def config4_thetas(rng, n_prior=8, n_post=8):
    """Prior draws (numpy) plus golden-region draws, (C, 5)."""
    mu = np.array([0.0, -1.0, -2.3, -2.3])
    sg = np.array([0.75, 0.6, 0.6, 0.6])
    prior = np.concatenate(
        [np.exp(mu + sg * rng.standard_normal((n_prior, 4))),
         rng.uniform(0.6, 1.1, (n_prior, 1))],
        axis=1,
    )
    post = GOLD_MEAN + GOLD_STD * rng.uniform(-1.0, 1.0, (n_post, 5))
    return np.concatenate([prior, post], axis=0)


@pytest.fixture(scope="module")
def problem():
    prob = jconfigs.config4_gibbs_smc()
    jmodel = JGPModel(prob.model.kernel, evidence_backend="xla")
    tmodel = convert.model_from_jax(prob.model)
    tdata = convert.dataset_from_jax(prob.data, torch.float64, "cpu")
    return prob, jmodel, tmodel, tdata


@pytest.fixture(scope="module")
def jax_reference(problem):
    """ll and dll/dtheta of the JAX chains-minor XLA path (one compile)."""
    prob, jmodel, _, _ = problem
    thetas = config4_thetas(np.random.default_rng(3))

    @jax.jit
    def vag(t):
        ll, pull = jax.vjp(lambda s: jmodel.log_marginal_batch(s, prob.data), t)
        return ll, pull(jnp.ones_like(ll))[0]

    ll, g = vag(jnp.asarray(thetas))
    return thetas, np.asarray(ll), np.asarray(g)


def test_plain_matches_jax_at_config4(problem, jax_reference):
    _, _, tmodel, tdata = problem
    thetas, ll_j, g_j = jax_reference
    ev = tmodel._evidence_data(tdata)
    before = evidence_cuda.PLAIN_CALLS
    ll, grad = evidence_cuda.vag(torch.tensor(thetas.T.copy()), ev)
    assert evidence_cuda.PLAIN_CALLS == before + 1 and evidence_cuda.LAUNCHES == 0
    assert np.isfinite(ll_j).all()
    np.testing.assert_allclose(ll.numpy(), ll_j, **LL_TOL)
    np.testing.assert_allclose(grad.numpy().T, g_j, **GRAD_TOL)


def test_model_autograd_matches_jax(problem, jax_reference):
    """The same through GPModel and the autograd Function (backward is
    g * grad), with a non-unit cotangent."""
    _, _, tmodel, tdata = problem
    thetas, ll_j, g_j = jax_reference
    t = torch.tensor(thetas, requires_grad=True)
    ll = tmodel.log_marginal_batch(t, tdata)
    ct = torch.linspace(0.5, 2.0, ll.shape[0], dtype=torch.float64)
    (g,) = torch.autograd.grad(ll, t, ct)
    np.testing.assert_allclose(ll.detach().numpy(), ll_j, **LL_TOL)
    np.testing.assert_allclose(g.numpy(), ct.numpy()[:, None] * g_j, **GRAD_TOL)


def _small_problem(rng, slopes_last):
    n_val, n_slope = 6, 2
    N = n_val + n_slope
    X = np.sort(rng.uniform(0, 1.2, N))
    nid = np.array([0] * n_val + [1] * n_slope)
    if not slopes_last:
        nid = rng.permutation(nid)  # every derivative-block selector occurs
    y = rng.standard_normal(N)
    err2 = np.full(N, 0.01)
    return X, nid, y, err2


def test_plain_matches_pallas_kernel(rng):
    """Slopes interleaved with values, so every derivative block occurs."""
    X, nid, y, err2 = _small_problem(rng, slopes_last=False)
    C = 8
    thetaT = rng.uniform(0.3, 1.4, (5, C))
    vag = evidence_pallas.build_loglik_vag(
        "gibbs_tanh", X, nid, y, err2, 1e2, interpret=True
    )
    ll_p, grad_p = vag(jnp.asarray(thetaT))
    ev = evidence_cuda.make_data(X, nid, y, err2, 1e2, "cpu")
    ll, grad = evidence_cuda.loglik_vag_plain(torch.tensor(thetaT), ev)
    np.testing.assert_allclose(ll.numpy(), np.asarray(ll_p), **LL_TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(grad_p), **GRAD_TOL)


@pytest.mark.parametrize("slopes_last", [True, False])
def test_cov_build_matches_jax(rng, slopes_last):
    """The block-grouped build equals the reference's assembled one."""
    X, nid, _, _ = _small_problem(rng, slopes_last)
    thetaT = rng.uniform(0.3, 1.4, (5, 6))
    K_j = jfused.gibbs_tanh_cov_fused_soa_sym(
        jnp.asarray(X), jnp.asarray(nid), jnp.asarray(thetaT)
    )
    K_t = tfused.gibbs_tanh_cov_fused_soa_sym(
        torch.tensor(X), torch.tensor(nid), torch.tensor(thetaT)
    )
    np.testing.assert_allclose(K_t.numpy(), np.asarray(K_j), rtol=1e-12, atol=1e-14)


def test_loglik_b_value_and_backward_match_jax(rng):
    """Batched evidence on SPD matrices with scale > 1 (so the jitter's
    trace term is live), value and VJP with a random cotangent."""
    N, C = 6, 5
    A = rng.standard_normal((C, N, N))
    K = np.einsum("cij,ckj->ikc", A, A) + 2.0 * np.eye(N)[:, :, None]
    r = rng.standard_normal((N, C))
    ct = rng.standard_normal(C)
    ll_j, pull = jax.vjp(
        lambda k, rr: jevidence.loglik_b(k, rr, 1e2), jnp.asarray(K), jnp.asarray(r)
    )
    Kb_j, rb_j = pull(jnp.asarray(ct))
    Kt = torch.tensor(K, requires_grad=True)
    rt = torch.tensor(r, requires_grad=True)
    ll = tevidence.loglik_b(Kt, rt, 1e2)
    Kb, rb = torch.autograd.grad(ll, (Kt, rt), torch.tensor(ct))
    np.testing.assert_allclose(ll.detach().numpy(), np.asarray(ll_j), rtol=1e-12)
    np.testing.assert_allclose(Kb.numpy(), np.asarray(Kb_j), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(rb.numpy(), np.asarray(rb_j), rtol=1e-9, atol=1e-12)


def test_nan_column_gives_neg_inf_and_zero_gradient(problem):
    _, _, tmodel, tdata = problem
    thetas = config4_thetas(np.random.default_rng(5), n_prior=2, n_post=2)
    thetas[1, 2] = np.nan
    ev = tmodel._evidence_data(tdata)
    ll, grad = evidence_cuda.loglik_vag_plain(torch.tensor(thetas.T.copy()), ev)
    assert float(ll[1]) == -np.inf
    np.testing.assert_array_equal(grad[:, 1].numpy(), 0.0)
    assert torch.isfinite(ll[[0, 2, 3]]).all() and torch.isfinite(grad).all()
    # and through the model's autograd path
    t = torch.tensor(thetas, requires_grad=True)
    (g,) = torch.autograd.grad(tmodel.log_marginal_batch(t, tdata).sum(), t)
    np.testing.assert_array_equal(g[1].numpy(), 0.0)


def test_non_pd_gives_neg_inf(rng):
    """A non-positive pivot (negative noise variance) also maps to -inf
    with a zero gradient."""
    X, nid, y, _ = _small_problem(rng, True)
    ev = evidence_cuda.make_data(X, nid, y, np.full(8, -5.0), 1e2, "cpu")
    ll, grad = evidence_cuda.loglik_vag_plain(
        torch.tensor(rng.uniform(0.3, 1.4, (5, 3))), ev
    )
    assert (ll == -np.inf).all()
    assert (grad == 0).all()


def test_cuda_route_checks_inputs_before_building():
    ev = evidence_cuda.make_data(np.linspace(0, 1, 4), np.zeros(4), np.zeros(4),
                                 np.full(4, 0.01), 1e2, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        evidence_cuda.loglik_vag_cuda(torch.ones(5, 3, dtype=torch.float64), ev)
    with pytest.raises(TypeError):
        evidence_cuda.loglik_vag_cuda(torch.ones(5, 3, dtype=torch.int32), ev)
    with pytest.raises(ValueError, match=r"\(5, C\)"):
        evidence_cuda.vag(torch.ones(4, 3, dtype=torch.float64), ev)
    big = evidence_cuda.make_data(np.linspace(0, 1, 49), np.zeros(49), np.zeros(49),
                                  np.full(49, 0.01), 1e2, "cpu")
    with pytest.raises(ValueError, match="N = 49"):
        evidence_cuda.loglik_vag_cuda(torch.ones(5, 3, dtype=torch.float64), big)
    with pytest.raises(ValueError, match="no evidence route"):
        evidence_cuda.vag(torch.ones(5, 3, dtype=torch.float64, device="meta"), ev)
    # the kernel reads N doubles (ints for nid) from each data pointer
    with pytest.raises(ValueError, match="evidence data X"):
        evidence_cuda.loglik_vag_cuda(torch.ones(5, 3, dtype=torch.float64),
                                      ev._replace(X=ev.X.float()))
    with pytest.raises(ValueError, match="evidence data y"):
        evidence_cuda.loglik_vag_cuda(torch.ones(5, 3, dtype=torch.float64),
                                      ev._replace(y=ev.y[:3]))
    with pytest.raises(ValueError, match="same length"):
        evidence_cuda.make_data(np.linspace(0, 1, 4), np.zeros(4), np.zeros(3),
                                np.full(4, 0.01), 1e2, "cpu")
    with pytest.raises(ValueError, match="ids 0 or 1"):
        evidence_cuda.make_data(np.linspace(0, 1, 4), np.array([0, 1, 2, 0]),
                                np.zeros(4), np.full(4, 0.01), 1e2, "cpu")
    assert evidence_cuda._LIB is None  # nothing was built
