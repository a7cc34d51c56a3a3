"""The port's Matern and warped scalars against the JAX package, float64.

- `MaternKernel` at p = 1, 2, 3 (nu = 3/2, 5/2, 7/2): its {value, slope}
  covariance blocks through `assemble.cov_matrix` on points with a
  repeated x (the (1, 1) block at coincident points goes through the
  Taylor branch below ``_U_SWITCH``), one theta and a batch of three, at
  rtol 1e-12; the coincident (1, 1) entry finite and equal to the
  closed-form limit; the batch evidence of a p = 1 and p = 3 model (the
  per-chain route) at rtol 1e-9;
- `WarpedKernel` under a BetaWarp and a LinearWarp: its derivative blocks,
  jvp towers through `special.betainc_dd`, at rtol 1e-11;
- config 3 (BetaWarp-ed Matern-5/2 with a linear mean): ``predict`` at its
  golden mean for n = 0 and 1, mean and std at rtol 1e-9.
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
from gptools_tpu.ops import kernels as jk
from gptools_tpu_torch import convert
from gptools_tpu_torch.ops import assemble, evidence_cuda
from gptools_tpu_torch.ops import kernels as tk

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
# values at 0.1 .. 1.1 with one x repeated, and slopes at a repeated x and
# at a value's x: coincident pairs in every block
X = np.array([0.1, 0.25, 0.25, 0.4, 0.7, 1.1, 0.0, 0.4, 0.4])
NID = np.array([0, 0, 0, 0, 0, 0, 1, 1, 1], np.int32)
MI = ((0,), (1,))


def _cov_pair(jker, tker, thetas, X1=X, N1=NID):
    Xc = X1[:, None]
    K_t = assemble.cov_matrix(tker, torch.tensor(thetas), torch.tensor(Xc), torch.tensor(N1),
                              torch.tensor(Xc), torch.tensor(N1), MI).numpy()

    @jax.jit
    def ref(t):
        return jax.vmap(lambda s: jassemble.cov_matrix(
            jker, s, jnp.asarray(Xc), jnp.asarray(N1), jnp.asarray(Xc), jnp.asarray(N1),
            MI))(t)

    return K_t, np.asarray(ref(jnp.asarray(thetas)))


@pytest.mark.parametrize("nu", [1.5, 2.5, 3.5])
def test_matern_blocks_match_jax(nu):
    thetas = np.array([[1.1, 0.35], [0.6, 0.8], [1.4, 0.2]])
    K_t, K_j = _cov_pair(jk.MaternKernel(nu=nu), tk.MaternKernel(nu=nu), thetas)
    np.testing.assert_allclose(K_t, K_j, rtol=1e-12, atol=1e-14 * np.abs(K_j).max())
    # the (1, 1) block at coincident slopes (x = 0.4 twice): the limit
    # sigma_f^2 * 2 nu / ((2 nu - 2) l^2) of -d^2/dr^2 of the shape at 0
    sf, ell = thetas[:, 0], thetas[:, 1]
    limit = sf**2 * 2 * nu / ((2 * nu - 2) * ell**2)
    assert np.isfinite(K_t).all()
    np.testing.assert_allclose(K_t[:, 7, 8], limit, rtol=1e-12)
    np.testing.assert_allclose(K_t[:, 7, 7], limit, rtol=1e-12)
    one = assemble.cov_matrix(tk.MaternKernel(nu=nu), torch.tensor(thetas[1]),
                              torch.tensor(X[:, None]), torch.tensor(NID),
                              torch.tensor(X[:, None]), torch.tensor(NID), MI).numpy()
    np.testing.assert_allclose(one, K_t[1], rtol=1e-14, atol=0)


@pytest.mark.parametrize("nu", [1.5, 3.5])
def test_matern_evidence_per_chain_route(nu):
    """p = 1 and 3 have no fused builder: the batch evidence takes the
    per-chain route, with the reference's ll and gradient."""
    b = JBuilder(1)
    b.add(X[:6], np.sin(X[:6]), err_y=0.1)
    b.add(X[6:], np.cos(X[6:]), err_y=0.05, n=1)
    jd = b.build(dtype=jnp.float64)
    jm = JGPModel(jk.MaternKernel(nu=nu))
    tm = convert.model_from_jax(jm)
    td = convert.dataset_from_jax(jd, torch.float64, "cpu")
    th = np.array([[1.1, 0.35], [0.6, 0.8], [1.4, 0.5]])
    evidence_cuda.reset_counts()
    t = torch.tensor(th, requires_grad=True)
    ll = tm.log_marginal_batch(t, td)
    (g,) = torch.autograd.grad(ll.sum(), t)
    assert evidence_cuda.ROUTE_CALLS["per_chain"] == 1

    @jax.jit
    def ref(s):
        v, pull = jax.vjp(lambda u: jm.log_marginal_batch(u, jd), s)
        return v, pull(jnp.ones_like(v))[0]

    ll_j, g_j = (np.asarray(a) for a in ref(jnp.asarray(th)))
    np.testing.assert_allclose(ll.detach().numpy(), ll_j, rtol=1e-9)
    np.testing.assert_allclose(g.numpy(), g_j, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("warp", ["beta", "linear"])
def test_warped_blocks_match_jax(warp):
    """Derivative blocks of a warped Matern-5/2 on [0, 1] (the betainc
    quadrature's jvp towers for the BetaWarp)."""
    if warp == "beta":
        jker = jk.WarpedKernel(jk.Matern52Kernel(), jk.BetaWarp())
        tker = tk.WarpedKernel(tk.Matern52Kernel(), tk.BetaWarp())
        thetas = np.array([[1.1, 0.35, 1.3, 0.7], [0.6, 0.8, 0.5, 2.2]])
    else:
        jker = jk.WarpedKernel(jk.Matern52Kernel(), jk.LinearWarp(-0.2, 1.3))
        tker = tk.WarpedKernel(tk.Matern52Kernel(), tk.LinearWarp(-0.2, 1.3))
        thetas = np.array([[1.1, 0.35], [0.6, 0.8]])
    Xw = X / 1.2 + 0.02
    K_t, K_j = _cov_pair(jker, tker, thetas, X1=Xw)
    np.testing.assert_allclose(K_t, K_j, rtol=1e-11, atol=1e-13 * np.abs(K_j).max())


@pytest.mark.parametrize("n", [0, 1])
def test_config3_predict_matches_jax(n):
    """Config 3's predict at its golden mean, 25 stars, values and
    slopes: mean and std at rtol 1e-9."""
    with open(os.path.join(HERE, "golden_config3.json")) as f:
        theta = np.asarray(json.load(f)["mean"])
    jp = jconfigs.config3_matern_mean_warp_hmc()
    tm = convert.model_from_jax(jp.model)
    td = convert.dataset_from_jax(jp.data, torch.float64, "cpu")
    xs = np.linspace(0.03, 0.97, 25)
    pred = tm.predict(torch.tensor(theta), td, xs, n=n)

    @jax.jit
    def ref(t):
        p = jp.model.predict(t, jp.data, jnp.asarray(xs), n=n)
        return p.mean, p.std

    mean_j, std_j = (np.asarray(a) for a in ref(jnp.asarray(theta)))
    np.testing.assert_allclose(pred.mean.numpy(), mean_j, rtol=1e-9,
                               atol=1e-12 * np.abs(mean_j).max())
    np.testing.assert_allclose(pred.std.numpy(), std_j, rtol=1e-9)
