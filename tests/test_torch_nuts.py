"""The port's NUTS (`infer.nuts`, all chains in masked lockstep) against the
JAX package, float64 on the CPU.

- `_uturn` on random inputs against the reference's (1e-12: the same
  booleans);
- the checkpointed U-turn indexing (slot popcount(a) for an even leaf a,
  the slots `_uturn_slots(i)` for the blocks ending at leaf i) against a
  brute-force enumeration of balanced subtrees, for subtrees up to 2^7
  leaves (this file carries its own copy of the oracle);
- a chain that diverges keeps its state bit for bit while the others move;
- NUTS recovers a correlated 2-D Gaussian's moments within 4 Monte Carlo
  standard errors, with no divergence.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gptools_tpu.infer import nuts as jnuts
from gptools_tpu_torch.infer import hmc, nuts
from gptools_tpu_torch.utils.diagnostics import ess_and_rhat

torch.set_num_threads(1)

MEAN = np.array([1.0, -2.0])
COV = np.array([[1.0, 0.8], [0.8, 1.0]])


def gauss_logp(u):
    prec = torch.tensor(np.linalg.inv(COV), dtype=u.dtype)
    d = u - torch.tensor(MEAN, dtype=u.dtype)
    return -0.5 * ((d @ prec) * d).sum(-1)


def test_uturn_matches_jax(rng):
    dz, pa, pb = (rng.standard_normal((500, 3)) for _ in range(3))
    inv_mass = rng.uniform(0.2, 2.0, 3)
    got = nuts._uturn(torch.tensor(dz), torch.tensor(pa), torch.tensor(pb),
                      torch.tensor(inv_mass)).numpy()
    want = jax.vmap(lambda a, b, c: jnuts._uturn(a, b, c, jnp.asarray(inv_mass)))(
        jnp.asarray(dz), jnp.asarray(pa), jnp.asarray(pb))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert 0 < got.sum() < got.size


def test_uturn_checkpoint_indexing_matches_bruteforce():
    """The port's slots generate exactly the balanced-subtree U-turn checks
    of recursive NUTS (Hoffman & Gelman 2014; Betancourt 2017)."""
    for depth in range(1, 8):
        n = 1 << depth
        # oracle: every balanced block [a, b], a = m 2^k, b = a + 2^k - 1, k >= 1
        want = set()
        for k in range(1, depth + 1):
            size = 1 << k
            for a in range(0, n, size):
                want.add((a, a + size - 1))
        got, store = set(), {}
        for i in range(n):
            if i % 2 == 0:
                store[bin(i).count("1")] = i
            for s in nuts._uturn_slots(i):
                got.add((store[s], i))
        assert got == want, (depth, got ^ want)


def test_diverging_chain_keeps_its_state_bitwise():
    """Row 0 targets N(0, 1e-8 I) and diverges at eps = 1 on its first leaf;
    row 1 targets N(0, I) and moves."""
    scale = torch.tensor([1e8, 1.0], dtype=torch.float64)

    def logp(u):
        return -0.5 * scale * (u * u).sum(-1)

    q = torch.tensor([[1e-4, -2e-4], [0.3, -0.4]], dtype=torch.float64)
    vg = hmc.value_and_grad(logp)
    lp, g = vg(q)
    gen = torch.Generator().manual_seed(0)
    moved = False
    for _ in range(5):
        qn, lpn, gn, st = nuts._nuts_transition(vg, q, lp, g, gen, torch.tensor(1.0),
                                                torch.ones(2, dtype=torch.float64),
                                                max_depth=6)
        assert bool(st["diverged"][0]) and not bool(st["diverged"][1])
        assert torch.equal(qn[0], q[0]) and torch.equal(lpn[0], lp[0])
        assert torch.equal(gn[0], g[0])
        assert int(st["num_leapfrog"][0]) == 1 and int(st["tree_depth"][0]) == 1
        assert int(st["num_leapfrog"][1]) > 1
        np.testing.assert_allclose(lpn[1].item(), logp(qn)[1].item(), rtol=1e-14)
        moved |= not torch.equal(qn[1], q[1])
        q, lp, g = qn, lpn, gn
    assert moved


def test_nuts_recovers_gaussian():
    gen = torch.Generator().manual_seed(5)
    u0 = torch.randn((8, 2), generator=gen, dtype=torch.float64)
    res = nuts.sample(gauss_logp, u0, gen, num_warmup=300, num_samples=600)
    d = res.diagnostics
    assert res.u.shape == (8, 600, 2) and int(d["divergences"]) == 0
    assert int(d["num_leapfrog_total"]) > 8 * 600  # more than one leapfrog a transition
    assert 1.0 <= float(d["mean_tree_depth"]) <= 10.0 and d["host_syncs"] > 900
    ess, rhat = ess_and_rhat(res.u)
    ess = np.asarray(ess, dtype=float)
    assert float(np.max(np.asarray(rhat, dtype=float))) <= 1.1
    flat = res.u.reshape(-1, 2).numpy()
    m, c = flat.mean(0), np.cov(flat.T)
    sd = np.sqrt(np.diag(COV))
    assert np.all(np.abs(m - MEAN) <= 4.0 * sd / np.sqrt(ess)), (m, ess)
    assert np.all(np.abs(np.diag(c) - np.diag(COV))
                  <= 4.0 * np.diag(COV) * np.sqrt(2.0 / ess)), (c, ess)
    se_cov = sd[0] * sd[1] * np.sqrt(1.64 / ess.min())
    assert abs(c[0, 1] - COV[0, 1]) <= 4.0 * se_cov, (c, ess)
