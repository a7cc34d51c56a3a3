"""`GPModel`'s free/fixed embedding, float32 and float64, on an all-free
model (config 4) and on config 2's SE kernel with its length scale fixed:

- `log_posterior_u_batch` (value and gradient), `theta_of_u`,
  `embed_free` and `extract_free` equal, bit for bit, an embedding built
  from ``torch.tensor(model.initial_params)`` at every call;
- the fixed parameters' tensors are made once a (dtype, device): over 10
  calls of each, ``HOST_SYNCS["model.initial_params"]`` grows by 0 on the
  all-free model and by 1 per dtype on the fixed one;
- reassigning ``model.initial_params`` changes the filled values at the
  next call.
"""

import numpy as np
import pytest
import torch

from gptools_tpu_torch import configs
from gptools_tpu_torch.models.gp import GPModel
from gptools_tpu_torch.ops.kernels import SquaredExponentialKernel
from gptools_tpu_torch.utils import metrics
from gptools_tpu_torch.utils.priors import LogNormalJointPrior

torch.set_num_threads(1)

DTYPES = [torch.float32, torch.float64]
KINDS = ["all_free", "fixed"]
SITE = "model.initial_params"


def _problem(kind, dtype):
    if kind == "all_free":
        prob = configs.config4_gibbs_smc(dtype=dtype, device="cpu")
        return prob.model, prob.data
    prob = configs.config2_se_deriv_nuts(dtype=dtype, device="cpu")
    kernel = SquaredExponentialKernel(
        hyperprior=LogNormalJointPrior([0.0, -0.5], [0.75, 0.75]),
        fixed_params=[False, True], initial_params=[1.0, 0.7],
    )
    return GPModel(kernel), prob.data


def _old_full(model, free, fill):
    """The embedding as it was built before the tensors were kept."""
    if model.num_free_params == model.num_params:
        return free
    out = fill.expand(free.shape[:-1] + (model.num_params,)).clone()
    out[..., list(model.free_idx)] = free
    return out


def _old_initial(model, dtype):
    return torch.tensor(model.initial_params, dtype=dtype)


def _old_log_posterior_u_batch(model, us, data):
    u_full = _old_full(model, us, model.bijector.inverse(_old_initial(model, us.dtype)))
    thetas = model.bijector.forward(u_full)
    return model.log_posterior_batch(thetas, data) + model.bijector.log_det_jac(u_full)


def _value_and_grad(fn, us):
    u = us.clone().requires_grad_(True)
    lp = fn(u)
    (g,) = torch.autograd.grad(lp.sum(), u)
    return lp.detach(), g


def _us(model, dtype, C=6, seed=3):
    rng = np.random.default_rng(seed)
    return torch.tensor(0.3 * rng.standard_normal((C, model.num_free_params)), dtype=dtype)


def _assert_same_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b), (a - b).abs().max()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_embedding_has_the_bits_of_a_fresh_initial_vector(kind, dtype):
    model, data = _problem(kind, dtype)
    us = _us(model, dtype)
    lp, g = _value_and_grad(lambda u: model.log_posterior_u_batch(u, data), us)
    lp0, g0 = _value_and_grad(lambda u: _old_log_posterior_u_batch(model, u, data), us)
    _assert_same_bits(lp, lp0)
    _assert_same_bits(g, g0)
    assert torch.isfinite(lp).all()

    u0 = model.bijector.inverse(_old_initial(model, dtype))
    _assert_same_bits(model.theta_of_u(us),
                      model.bijector.forward(_old_full(model, us, u0)))
    free = model.bijector.forward(us)
    full = model.embed_free(free)
    _assert_same_bits(full, _old_full(model, free, _old_initial(model, dtype)))
    _assert_same_bits(model.extract_free(full), full[..., list(model.free_idx)])
    _assert_same_bits(model.extract_free(full), free)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_fixed_tensors_are_copied_once(kind, dtype):
    model, data = _problem(kind, dtype)
    us = _us(model, dtype)
    before = metrics.HOST_SYNCS[SITE]
    for _ in range(10):
        model.log_posterior_u_batch(us, data)
        full = model.theta_of_u(us)
        model.embed_free(model.extract_free(full))
    assert metrics.HOST_SYNCS[SITE] - before == (0 if kind == "all_free" else 1)


def test_fixed_tensors_are_kept_per_dtype():
    model, _ = _problem("fixed", torch.float64)
    before = metrics.HOST_SYNCS[SITE]
    outs = {}
    for _ in range(10):
        for dtype in DTYPES:
            outs[dtype] = model.theta_of_u(_us(model, dtype))
    assert metrics.HOST_SYNCS[SITE] - before == len(DTYPES)
    for dtype in DTYPES:
        assert outs[dtype].dtype == dtype
        assert outs[dtype][:, 1].eq(torch.tensor(0.7, dtype=dtype)).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_reassigned_initial_params_are_filled(dtype):
    model, data = _problem("fixed", dtype)
    us = _us(model, dtype)
    free = torch.ones((3, 1), dtype=dtype)
    lp_a = model.log_posterior_u_batch(us, data)
    assert model.embed_free(free)[:, 1].eq(torch.tensor(0.7, dtype=dtype)).all()
    before = metrics.HOST_SYNCS[SITE]
    model.initial_params = (1.0, 0.4)
    full = model.embed_free(free)
    assert full[:, 1].eq(torch.tensor(0.4, dtype=dtype)).all()
    u0 = model.bijector.inverse(_old_initial(model, dtype))
    _assert_same_bits(model.theta_of_u(us), model.bijector.forward(_old_full(model, us, u0)))
    lp_b = model.log_posterior_u_batch(us, data)
    _assert_same_bits(lp_b, _old_log_posterior_u_batch(model, us, data))
    assert not torch.equal(lp_a, lp_b)
    assert metrics.HOST_SYNCS[SITE] - before == 1
