"""A chain's log density and gradient do not depend on the batch it is in.

The contract that lets `gptools_tpu_torch.parallel.mesh.ShardedDensity`
repeat the unsharded run's draws (its module docstring names the sites
that hold it). For each model, float64 and float32 on the CPU with one
thread:
`log_posterior_u_batch`'s value and gradient at C = 64 chains (u from a
numpy seed) in one call, against the same chains in blocks of 32 + 32,
1 + 63 and 63 + 1 (a call each), and against the first and the last chain
alone (C = 1); every comparison `torch.equal`. The models cover every path
of the batch evidence:

- configs 1-5 (config 3: the evidence kernel's plain version with the aux
  channels mu and w; config 5: the chains-minor route);
- se_noise (aux nd), warped_se_deriv (aux w and wp) and the N = 48
  se_noise, the variants of the reference's test_evidence_pallas.py;
- the kernel zoo's per-chain route: a free-nu Matern on small slope data
  and an RQ + SE sum on config 1's data;
- config 3's warped Matern and linear mean with a diagonal noise kernel
  through the chains-minor route (``evidence_backend="xla"``).

The JAX package's config 3 (jitted, float64, at 8 points) is the
control: the reference's value and gradient are the same bits for the
blocks 1 + 63 and 63 + 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptools_tpu import configs as jconfigs
from gptools_tpu_torch import configs
from gptools_tpu_torch.models.dataset import DatasetBuilder
from gptools_tpu_torch.models import gp as tgp
from gptools_tpu_torch.models.gp import GPModel
from gptools_tpu_torch.ops import evidence_cuda
from gptools_tpu_torch.ops import kernels as K
from gptools_tpu_torch.utils.priors import (
    GammaJointPrior,
    LogNormalJointPrior,
    UniformJointPrior,
)

torch.set_num_threads(1)

F64 = torch.float64
C = 64
SPLITS = ((32, 32), (1, 63), (63, 1))


def _variant_data(rng, lo, hi, n, dtype):
    b = DatasetBuilder(1)
    X = np.sort(rng.uniform(lo, hi, n))
    b.add(X, np.sin(X), err_y=0.1)
    b.add(np.array([lo, hi]), np.zeros(2), err_y=0.05, n=1)
    return b.build(dtype, "cpu")


def _config(k, dtype=F64):
    prob = configs.ALL_CONFIGS[k](dtype=dtype, device="cpu")
    return prob.model, prob.data


def _se_noise(n, dtype):
    model = GPModel(K.SquaredExponentialKernel(), noise_kernel=K.DiagonalNoiseKernel(n=0))
    return model, _variant_data(np.random.default_rng(1), 0.0, 1.2, n, dtype)


def _warped_se_deriv(dtype):
    model = GPModel(K.WarpedKernel(K.SquaredExponentialKernel(), K.BetaWarp()))
    return model, _variant_data(np.random.default_rng(2), 0.05, 0.95, 7, dtype)


def _free_nu(dtype):
    prior = (LogNormalJointPrior([0.0], [0.75]) * UniformJointPrior([1.05], [6.0])
             * LogNormalJointPrior([-0.5], [0.75]))
    data = configs.config2_se_deriv_nuts(n_points=6, dtype=dtype, device="cpu").data
    return GPModel(K.MaternGeneralKernel(hyperprior=prior)), data


def _rq_se(dtype):
    rq = K.RationalQuadraticKernel(hyperprior=LogNormalJointPrior([0.0], [0.75])
                                   * GammaJointPrior([2.0], [1.0])
                                   * LogNormalJointPrior([-0.5], [0.75]))
    se = K.SquaredExponentialKernel(hyperprior=LogNormalJointPrior([-1.0], [0.75])
                                    * LogNormalJointPrior([0.0], [0.75]))
    return GPModel(rq + se), _config(1, dtype)[1]


def _minor_mean_noise(dtype):
    model, data = _config(3, dtype)
    return GPModel(model.kernel, mean=model.mean, noise_kernel=K.DiagonalNoiseKernel(),
                   evidence_backend="xla"), data


# model -> (builder of dtype, the path of its batch evidence: "plain" the
# evidence kernel's plain version, else the route)
MODELS = {
    **{f"config{k}": (lambda dtype, k=k: _config(k, dtype),
                      "chains_minor" if k == 5 else "plain") for k in (1, 2, 3, 4, 5)},
    "se_noise": (lambda dtype: _se_noise(7, dtype), "plain"),
    "warped_se_deriv": (_warped_se_deriv, "plain"),
    "se_noise_n48": (lambda dtype: _se_noise(46, dtype), "plain"),
    "free_nu_per_chain": (_free_nu, "per_chain"),
    "rq_se_per_chain": (_rq_se, "per_chain"),
    "mean_noise_chains_minor": (_minor_mean_noise, "chains_minor"),
}
# float32 too, but for the free-nu Matern, whose Bessel quadrature is not
# finite in float32 at these draws
CASES = [(name, F64) for name in MODELS] + [
    (name, torch.float32) for name in MODELS if name != "free_nu_per_chain"]


def _value_grad(model, data, u):
    u = u.clone().requires_grad_(True)
    v = model.log_posterior_u_batch(u, data)
    (g,) = torch.autograd.grad(v.sum(), u)
    return v.detach(), g


def _largest(a, b):
    return float(torch.where(a == b, 0.0, a - b).abs().max())


@pytest.mark.parametrize("name, dtype", CASES, ids=[f"{n}-{str(d)[6:]}" for n, d in CASES])
def test_chain_independent_of_batch(name, dtype):
    build, path = MODELS[name]
    model, data = build(dtype)
    u = torch.tensor(0.4 * np.random.default_rng(3).standard_normal((C, model.num_free_params)),
                     dtype=dtype)
    evidence_cuda.reset_counts()
    v, g = _value_grad(model, data, u)
    if path == "plain":
        assert sum(evidence_cuda.PLAIN_CALLS.values()) == 1
    else:
        assert evidence_cuda.ROUTE_CALLS[path] == 1
    assert torch.isfinite(v).all() and torch.isfinite(g).all()
    blocks = {split: [_value_grad(model, data, b) for b in u.split(list(split))]
              for split in SPLITS}
    blocks["first alone"] = [_value_grad(model, data, u[:1])]
    blocks["last alone"] = [_value_grad(model, data, u[-1:])]
    where = {"first alone": slice(0, 1), "last alone": slice(C - 1, C)}
    for split, parts in blocks.items():
        vb = torch.cat([p[0] for p in parts])
        gb = torch.cat([p[1] for p in parts])
        rows = where.get(split, slice(None))
        assert torch.equal(vb, v[rows]) and torch.equal(gb, g[rows]), (
            f"{name}, blocks {split}: largest value difference {_largest(vb, v[rows]):.3e}, "
            f"gradient {_largest(gb, g[rows]):.3e}")


def test_reference_config3_independent_of_batch():
    """The control: the JAX package's config 3 (at 8 points, and only the
    blocks with a chain alone, to keep its compiles short: one per shape)
    gives each chain the same bits in every block."""
    prob = jconfigs.config3_matern_mean_warp_hmc(n_points=8)
    model, data = prob.model, prob.data

    def total(u):
        v = model.log_posterior_u_batch(u, data)
        return v.sum(), v

    f = jax.jit(jax.value_and_grad(total, has_aux=True))
    u = jnp.asarray(0.4 * np.random.default_rng(3).standard_normal((C, model.num_free_params)))
    (_, v), g = f(u)
    v, g = np.asarray(v), np.asarray(g)
    for split in ((1, 63), (63, 1)):
        parts = [f(b) for b in jnp.split(u, np.cumsum(split)[:-1])]
        vb = np.concatenate([np.asarray(p[0][1]) for p in parts])
        gb = np.concatenate([np.asarray(p[1]) for p in parts])
        assert np.array_equal(vb, v) and np.array_equal(gb, g), split


@pytest.mark.parametrize("C", [1, 3, 64])
def test_pad_rows_gives_each_chain_its_own_result(C):
    """`gp._pad_rows`, which the routes apply on the card below
    `gp._ROUTE_MIN_CHAINS` chains, computes the padded batch and returns
    each chain's own value and gradient (the pad is detached)."""
    model, data = _config(5)
    u = torch.tensor(0.4 * np.random.default_rng(4).standard_normal((C, model.num_free_params)),
                     dtype=F64)
    width = tgp._ROUTE_MIN_CHAINS
    assert width == 64
    calls = []

    def fn(t):
        calls.append(t.shape[0])
        return model.log_posterior_u_batch(t, data)

    t = u.clone().requires_grad_(True)
    v = tgp._pad_rows(fn, t, width)
    (g,) = torch.autograd.grad(v.sum(), t)
    assert calls == [max(C, width)]
    v0, g0 = _value_grad(model, data, u)
    assert v.shape == (C,) and torch.equal(v.detach(), v0) and torch.equal(g, g0)
