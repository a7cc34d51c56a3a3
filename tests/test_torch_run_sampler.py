"""The port's `run_sampler` routes and the wrapper's inference entry points
against the JAX package, float64 on the CPU.

- every sampler name of the reference's `run_sampler` (and the SMC
  pipelines with ``whiten=False``) runs on config 2 at
  ``n_points=6`` (2 chains, 3 samples, no warmup) and returns the
  reference's shapes of ``u``, ``thetas`` and ``log_prob`` and its
  diagnostics keys with the same shapes (the SMC beta schedule's length
  depends on the draws); the only keys the port adds are NUTS's
  ``mean_tree_depth`` and ``host_syncs`` and parallel tempering's
  ``divergences_by_rung``;
- ``GaussianProcess.sample_hyperparameter_posterior()`` with no argument
  runs NUTS (8 chains, 500 + 1000) and ``optimize_hyperparameters()``
  leaves the wrapper at a point where the reference's gradient of
  ``log_posterior_u`` vanishes (1e-6) and its value equals the result's
  (1e-9).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptools_tpu import configs as jconfigs
from gptools_tpu.infer import run_sampler as jrun_sampler
from gptools_tpu_torch import convert
from gptools_tpu_torch.infer import run_sampler
from gptools_tpu_torch.models.gp import GaussianProcess

torch.set_num_threads(1)

ROUTES = {
    "nuts": ("nuts", {}), "hmc": ("hmc", dict(num_steps=4)), "chees": ("chees", {}),
    "pt": ("pt", dict(num_temps=3, num_steps=4)),
    "tempered": ("tempered", dict(num_temps=3, num_steps=4)),
    "advi": ("advi", dict(num_steps=5)), "smc": ("smc", dict(num_particles=64)),
    "smc+nuts": ("smc+nuts", dict(num_particles=64)),
    "smc-nuts": ("smc-nuts", dict(num_particles=64)),
    "smc+nuts-unwhitened": ("smc+nuts", dict(num_particles=64, whiten=False)),
    "smc+chees": ("smc+chees", dict(num_particles=64)),
    "smc-chees": ("smc-chees", dict(num_particles=64)),
    "smc+chees-unwhitened": ("smc+chees", dict(num_particles=64, whiten=False)),
}
PORT_ONLY = {"mean_tree_depth", "host_syncs", "divergences_by_rung"}
DRAW_DEPENDENT = {"beta_schedule"}


@pytest.fixture(scope="module")
def config2():
    jp = jconfigs.config2_se_deriv_nuts(n_points=6)
    return jp, convert.model_from_jax(jp.model), convert.dataset_from_jax(
        jp.data, torch.float64, "cpu")


def _shapes(res):
    return (np.shape(res.u), np.shape(res.thetas), np.shape(res.log_prob))


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_matches_reference_shapes_and_keys(config2, route):
    jp, model, data = config2
    sampler, extra = ROUTES[route]
    kw = dict(num_chains=2, num_samples=3, num_warmup=0, **extra)
    ref = jrun_sampler(jp.model, jp.data, jax.random.PRNGKey(0), sampler=sampler, **kw)
    res = run_sampler(model, data, torch.Generator().manual_seed(0), sampler=sampler, **kw)
    assert _shapes(res) == _shapes(ref)
    assert bool(torch.isfinite(res.thetas).all()) and bool(torch.isfinite(res.log_prob).all())
    assert set(ref.diagnostics) <= set(res.diagnostics)
    assert set(res.diagnostics) - set(ref.diagnostics) <= PORT_ONLY
    for k, v in ref.diagnostics.items():
        if k not in DRAW_DEPENDENT:
            assert np.shape(res.diagnostics[k]) == np.shape(v), k


def test_unknown_sampler_raises(config2):
    _, model, data = config2
    with pytest.raises(ValueError, match="unknown sampler"):
        run_sampler(model, data, torch.Generator(), sampler="emcee")


def _wrapper(jp):
    gp = GaussianProcess(convert.model_from_jax(jp.model).kernel, device="cpu")
    data = convert.dataset_from_jax(jp.data, torch.float64, "cpu")
    nid = data.nid.numpy()
    for order in (0, 1):
        sel = nid == order
        gp.add_data(data.Xf.numpy()[sel, 0], data.y.numpy()[sel], err_y=data.err_y.numpy()[sel],
                    n=order)
    return gp


def test_sample_hyperparameter_posterior_defaults(config2):
    jp, _, _ = config2
    gp = _wrapper(jp)
    res = gp.sample_hyperparameter_posterior()
    assert res.thetas.shape == (8, 1000, 2) and gp.sample_result is res
    assert bool(torch.isfinite(res.thetas).all())
    assert int(res.diagnostics["divergences"]) <= 8
    assert float(res.diagnostics["mean_tree_depth"]) >= 1.0


def test_optimize_hyperparameters_moves_the_wrapper(config2):
    jp, _, _ = config2
    gp = _wrapper(jp)
    theta0 = gp.theta.clone()
    res = gp.optimize_hyperparameters()
    assert res.all_thetas.shape == (9, 2)
    assert torch.equal(gp.theta, res.theta) and not torch.equal(gp.theta, theta0)
    assert gp._state is None
    vg = jax.jit(jax.value_and_grad(lambda u: jp.model.log_posterior_u(u, jp.data)))
    value, grad = vg(jnp.asarray(res.u.numpy()))
    assert float(jnp.linalg.norm(grad)) <= 1e-6
    np.testing.assert_allclose(float(res.log_posterior), float(value), rtol=1e-9)
    np.testing.assert_allclose(float(-gp.update_hyperparameters(gp.theta)),
                               float(jp.model.log_posterior(jnp.asarray(gp.theta.numpy()),
                                                            jp.data)), rtol=1e-9)
