"""Config 5 (a line-integral observation through the matrix T) against the
JAX package, float64 on the CPU.

- the dataset: the port's config 5 and the reference's carried across by
  `convert` hold the same Xf, nid, y, err_y and T (M = 32 observations of
  Q = 47 latent points, T block-diagonal with identity blocks), exactly;
  ``GaussianProcess.add_data(..., T=...)`` builds the same T;
- ``log_marginal_batch`` at C = 8 and its gradient (the chains-minor
  route: T present) at rtol 1e-9;
- `compute_K_L_alpha_ll` (L, alpha, ll) at rtol 1e-10 on the fused and the
  pallas backends (the covariance kernel's plain version here);
- ``predict`` with std at n = 0 and 1 (the star block ``K_sf T^T``) at
  rtol 1e-9, and the frozen predictors on the T dataset against
  ``predict``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptools_tpu import configs as jconfigs
from gptools_tpu_torch import configs as tconfigs
from gptools_tpu_torch import convert
from gptools_tpu_torch.models.gp import GaussianProcess
from gptools_tpu_torch.models.serve import FrozenMCMCPredictor, FrozenPredictor
from gptools_tpu_torch.ops import evidence_cuda
from gptools_tpu_torch.ops.kernels import GibbsKernel1dTanh

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def config5():
    with open(os.path.join(HERE, "golden_config5.json")) as f:
        gold = json.load(f)
    jp = jconfigs.config5_multihost_profile()
    tp = tconfigs.config5_multihost_profile(dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(5)
    th = np.asarray(gold["mean"]) + np.asarray(gold["std"]) * rng.uniform(-1, 1, (8, 5))
    return jp, tp, th


def test_dataset_matches_jax(config5):
    jp, tp, _ = config5
    conv = convert.dataset_from_jax(jp.data, torch.float64, "cpu")
    assert (tp.data.num_obs, tp.data.num_latent) == (32, 47)
    for d in (tp.data, conv):
        for name in ("Xf", "nid", "y", "err_y", "T"):
            np.testing.assert_array_equal(getattr(d, name).numpy(),
                                          np.asarray(getattr(jp.data, name)))
        assert d.multi_indices == jp.data.multi_indices
    T = tp.data.T.numpy()
    np.testing.assert_array_equal(T[:31, :31], np.eye(31))
    np.testing.assert_array_equal(T[31, 31:], np.full(16, 1.2 / 16))
    gp = GaussianProcess(GibbsKernel1dTanh(), device="cpu")
    xq = np.linspace(0.0, 1.2, 16)
    gp.add_data(np.linspace(0.0, 1.2, 30), np.zeros(30), err_y=0.03)
    gp.add_data(0.0, 0.0, err_y=0.01, n=1)
    gp.add_data(xq, [0.5], err_y=0.02, T=np.full((1, 16), 1.2 / 16))
    np.testing.assert_array_equal(gp.T.numpy(), T)


def test_log_marginal_batch_matches_jax(config5):
    jp, tp, th = config5
    evidence_cuda.reset_counts()
    t = torch.tensor(th, requires_grad=True)
    ll = tp.model.log_marginal_batch(t, tp.data)
    (g,) = torch.autograd.grad((ll * torch.arange(1.0, 9.0, dtype=ll.dtype)).sum(), t)
    assert evidence_cuda.ROUTE_CALLS == {"chains_minor": 1, "per_chain": 0}

    @jax.jit
    def ref(s):
        v, pull = jax.vjp(lambda u: jp.model.log_marginal_batch(u, jp.data), s)
        return v, pull(jnp.arange(1.0, 9.0))[0]

    ll_j, g_j = (np.asarray(a) for a in ref(jnp.asarray(th)))
    np.testing.assert_allclose(ll.detach().numpy(), ll_j, rtol=1e-9)
    np.testing.assert_allclose(g.numpy(), g_j, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("backend", ["fused", "pallas"])
def test_factor_and_predict_match_jax(config5, backend):
    jp, tp, th = config5
    tp.model.cov_backend = backend
    theta = torch.tensor(th[0])
    st = tp.model.compute_K_L_alpha_ll(theta, tp.data)
    xs = np.linspace(0.0, 1.2, 21)

    @jax.jit
    def ref(t):
        s = jp.model.compute_K_L_alpha_ll(t, jp.data)
        preds = [jp.model.predict(t, jp.data, jnp.asarray(xs), n=n, state=s) for n in (0, 1)]
        return s.L, s.alpha, s.ll, [(p.mean, p.std) for p in preds]

    L_j, alpha_j, ll_j, preds_j = ref(jnp.asarray(th[0]))
    for a, b in ((st.L, L_j), (st.alpha, alpha_j), (st.ll, ll_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-13)
    for n, (mean_j, std_j) in zip((0, 1), preds_j):
        pred = tp.model.predict(theta, tp.data, xs, n=n, state=st)
        np.testing.assert_allclose(pred.mean.numpy(), np.asarray(mean_j), rtol=1e-9,
                                   atol=1e-12)
        np.testing.assert_allclose(pred.std.numpy(), np.asarray(std_j), rtol=1e-9)


def test_frozen_predictors_on_t_data(config5):
    _, tp, th = config5
    tp.model.cov_backend = "auto"
    xs = np.linspace(0.0, 1.2, 13)
    mcmc = FrozenMCMCPredictor(tp.model, tp.data, torch.tensor(th), max_samples=8)
    mean, std = mcmc(xs, n=1)
    preds = tp.model.predict(torch.tensor(th), tp.data, xs, n=1)
    np.testing.assert_allclose(mean.numpy(), preds.mean.mean(0).numpy(), rtol=1e-12)
    var = (preds.std**2 + preds.mean**2).mean(0) - preds.mean.mean(0) ** 2
    np.testing.assert_allclose(std.numpy(), var.sqrt().numpy(), rtol=1e-10)
    point = FrozenPredictor(tp.model, tp.data, th[0])
    m0, s0 = point(xs)
    one = tp.model.predict(torch.tensor(th[0]), tp.data, xs)
    np.testing.assert_allclose(m0.numpy(), one.mean.numpy(), rtol=1e-12)
    np.testing.assert_allclose(s0.numpy(), one.std.numpy(), rtol=1e-12)
