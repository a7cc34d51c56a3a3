"""Port samplers and diagnostics against the JAX package, float64.

Deterministic pieces agree at 1e-12; random ones are held statistically,
since the two packages draw different streams: systematic resampling
counts, and the whole config-4 pipeline against tests/golden_config4.json
by the rule of scripts/f32_parity.py.
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptools_tpu.infer import chees as jchees
from gptools_tpu.infer import hmc as jhmc
from gptools_tpu.infer import smc as jsmc
from gptools_tpu.utils import diagnostics as jdiag
from gptools_tpu_torch import configs as tconfigs
from gptools_tpu_torch.infer import chees as tchees
from gptools_tpu_torch.infer import hmc as thmc
from gptools_tpu_torch.infer import smc as tsmc
from gptools_tpu_torch.infer.pipeline import smc_then_chees
from gptools_tpu_torch.ops import evidence_cuda
from gptools_tpu_torch.utils import diagnostics as tdiag

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden_config4.json")


@pytest.mark.parametrize("scale", [0.1, 3.0, 40.0])
def test_ess_fraction_and_next_beta(rng, scale):
    log_like = scale * rng.standard_normal(200) - 5.0
    np.testing.assert_allclose(
        float(tsmc._ess_fraction(torch.tensor(log_like))),
        float(jsmc._ess_fraction(jnp.asarray(log_like))), **TOL,
    )
    for beta in (0.0, 0.3):
        b_t = tsmc._next_beta(
            torch.tensor(log_like), torch.tensor(beta, dtype=torch.float64), 0.5
        )
        b_j = jsmc._next_beta(jnp.asarray(log_like), jnp.asarray(beta), 0.5)
        np.testing.assert_allclose(float(b_t), float(b_j), **TOL)


def test_da_update_sequence():
    st_t = thmc.da_init(torch.tensor(0.3, dtype=torch.float64))
    st_j = jhmc.da_init(jnp.asarray(0.3))
    for a in np.linspace(0.1, 0.95, 25):
        st_t = thmc.da_update(st_t, torch.tensor(a, dtype=torch.float64), target=0.75)
        st_j = jhmc.da_update(st_j, jnp.asarray(a), target=0.75)
    for f in st_t._fields:
        np.testing.assert_allclose(
            float(getattr(st_t, f)), float(getattr(st_j, f)), **TOL
        )


def test_halton_matches_jax():
    got = np.array([float(tchees._halton(i)) for i in range(64)], np.float32)
    want = np.array([float(jchees._halton(jnp.asarray(i))) for i in range(64)], np.float32)
    np.testing.assert_array_equal(got, want)


def _ar1_chains(rng, m=4, n=301, d=3, rho=0.7):
    x = np.zeros((m, n, d))
    x[:, 0] = rng.standard_normal((m, d))
    for t in range(1, n):
        x[:, t] = rho * x[:, t - 1] + rng.standard_normal((m, d))
    return x + 0.1 * np.arange(m)[:, None, None]  # some between-chain spread


def test_ess_and_split_rhat_match_jax(rng):
    x = _ar1_chains(rng)
    for i in range(x.shape[-1]):
        np.testing.assert_allclose(
            float(tdiag.ess(torch.tensor(x[:, :, i]))),
            float(jdiag.ess(jnp.asarray(x[:, :, i]))), **TOL,
        )
    np.testing.assert_allclose(
        tdiag._split_rhat_core(torch.tensor(x)).numpy(),
        np.asarray(jdiag._split_rhat_core(jnp.asarray(x))), **TOL,
    )
    e, r = tdiag.ess_and_rhat(torch.tensor(x))
    np.testing.assert_allclose(e, np.asarray(jax.vmap(jdiag.ess, in_axes=2)(jnp.asarray(x))), **TOL)
    assert r.shape == (3,)


def test_systematic_resample_counts(rng):
    n = 1000
    w = rng.dirichlet(np.full(n, 0.3))
    gen = torch.Generator().manual_seed(1)
    for _ in range(5):
        idx = tsmc._systematic_resample(gen, torch.tensor(np.log(w)), n)
        counts = np.bincount(idx.numpy(), minlength=n)
        assert counts.sum() == n
        assert np.all(np.abs(counts - n * w) <= 1.0 + 1e-9)


def test_smc_then_chees_matches_golden():
    """The whole pipeline on CPU (the plain evidence route) at the golden's
    warmup/sample/particle shape with 256 chains (512 in the golden run;
    the rule's standard errors come from the measured ESS)."""
    prob = tconfigs.config4_gibbs_smc(dtype=torch.float64, device="cpu")
    gen = torch.Generator().manual_seed(7)
    plain0, launches0 = evidence_cuda.PLAIN_CALLS, evidence_cuda.LAUNCHES
    t0 = time.perf_counter()
    res = smc_then_chees(
        prob.model, prob.data, gen, num_chains=256, num_warmup=75,
        num_samples=300, num_particles=1024,
    )
    wall = time.perf_counter() - t0
    assert evidence_cuda.LAUNCHES == launches0
    assert evidence_cuda.PLAIN_CALLS > plain0
    th = res.thetas
    assert th.shape == (256, 300, 5) and torch.isfinite(th).all()
    ess, rhat = tdiag.ess_and_rhat(th)
    assert rhat.max() <= 1.1
    assert int(res.diagnostics["divergences"]) <= 1e-3 * 256 * 300
    with open(GOLDEN) as f:
        gold = json.load(f)
    flat = th.reshape(-1, 5).numpy()
    m, s = flat.mean(0), flat.std(0, ddof=1)
    gm, gs, ge = (np.asarray(gold[k]) for k in ("mean", "std", "ess"))
    se = np.sqrt(s**2 / ess + gs**2 / ge)
    z = (m - gm) / se
    assert np.all(np.abs(z) <= 4.0), (z, wall)
    assert np.all(np.abs(s - gs) <= 0.15 * gs + 4.0 * se), ((s - gs) / gs, wall)
