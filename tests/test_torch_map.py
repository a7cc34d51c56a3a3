"""The port's MAP fit (`infer.map_fit`, a batched L-BFGS) against the JAX
package, float64 on the CPU.

- the batched L-BFGS on a batch of shifted quadratics and Rosenbrocks with
  one row at -inf: every finite row reaches its own minimum (1e-6 in x),
  the -inf row stays put and reports unconverged, and no row is NaN;
- config 1 (SE, 40 points, MAP only): the port's `map_fit.optimize` on the
  model carried across by `convert` reaches `tests/golden_config1.json`
  (theta within 1e-6 relative), and at the port's optimum the reference's
  ``value_and_grad(model.log_posterior_u)`` has a gradient norm <= 1e-6
  and the same value (1e-9); the port's `configs.config1_se_map` builds the
  same data and density as the converted reference;
- the golden itself: the reference's gradient vanishes at the stored u;
  the test marked slow regenerates it (the reference's `map_fit.optimize`,
  seed 0, PRNGKey(0), 8 starts, 200 steps, float64, CPU; with
  ``GOLDEN_CONFIG1_WRITE=1`` it writes the file).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptools_tpu import configs as jconfigs
from gptools_tpu.infer import map_fit as jmap
from gptools_tpu_torch import configs as tconfigs
from gptools_tpu_torch import convert
from gptools_tpu_torch.infer import map_fit, model_logp

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden_config1.json")


def _golden():
    with open(GOLDEN) as f:
        return json.load(f)


def _rosen(u, shift):
    x, y = u[:, 0] - shift, u[:, 1] - shift
    return -((1.0 - x) ** 2 + 100.0 * (y - x * x) ** 2)


def test_batched_lbfgs_rows_independent():
    """Rows 0-2: quadratics centred at c_i with curvatures (1, 10);
    rows 3-4: Rosenbrocks shifted by s_i (minimum at 1 + s_i); row 5: a
    density that is -inf everywhere (zero gradient, the kernel's contract)."""
    centres = torch.tensor([[0.5, -1.0], [3.0, 2.0], [-4.0, 0.25]], dtype=torch.float64)
    shifts = torch.tensor([0.0, -0.5], dtype=torch.float64)

    def logp(u):
        q = -0.5 * (((u[:3] - centres) ** 2) * torch.tensor([1.0, 10.0],
                                                           dtype=torch.float64)).sum(-1)
        r = _rosen(u[3:5], shifts)
        dead = u[5:, 0] * 0.0 - float("inf")
        return torch.cat([q, r, dead])

    u0 = torch.tensor([[0.0, 0.0], [1.0, 1.0], [0.0, 0.0], [-1.2, 1.0], [-1.0, -1.5],
                       [0.3, 0.3]], dtype=torch.float64)
    us, lps, stats = map_fit.minimize(logp, u0, num_steps=200)
    assert not torch.isnan(us).any() and not torch.isnan(lps).any()
    want = torch.cat([centres, (1.0 + shifts)[:, None].expand(2, 2)])
    np.testing.assert_allclose(us[:5].numpy(), want.numpy(), atol=1e-6)
    assert bool(torch.isfinite(lps[:5]).all()) and lps[5] == -float("inf")
    np.testing.assert_array_equal(us[5].numpy(), u0[5].numpy())
    # alone, each finite row goes where it went in the batch
    for i in range(5):
        def one(u, i=i):
            out = logp(torch.cat([torch.zeros((i, 2), dtype=torch.float64), u,
                                  torch.zeros((5 - i, 2), dtype=torch.float64)]))
            return out[i:i + 1]
        ui, _, _ = map_fit.minimize(one, u0[i:i + 1], num_steps=200)
        np.testing.assert_allclose(ui[0].numpy(), us[i].numpy(), atol=1e-6)
    assert stats["density_calls"] > 200


@pytest.fixture(scope="module")
def config1():
    jp = jconfigs.config1_se_map(seed=0)
    model = convert.model_from_jax(jp.model)
    data = convert.dataset_from_jax(jp.data, torch.float64, "cpu")
    vg = jax.jit(jax.value_and_grad(lambda u: jp.model.log_posterior_u(u, jp.data)))
    return jp, model, data, vg


def test_config1_matches_converted_reference(config1):
    jp, model, data, vg = config1
    tp = tconfigs.config1_se_map(dtype=torch.float64, device="cpu")
    for name in ("Xf", "nid", "y", "err_y"):
        np.testing.assert_array_equal(getattr(tp.data, name).numpy(),
                                      np.asarray(getattr(jp.data, name)))
    assert tp.sampler is None and tp.sampler_kwargs == dict(random_starts=8)
    assert type(model.kernel).__name__ == "SquaredExponentialKernel"
    us = torch.tensor(np.random.default_rng(1).normal(0.0, 1.0, (6, 2)))
    np.testing.assert_allclose(tp.model.log_posterior_u_batch(us, tp.data).numpy(),
                               model.log_posterior_u_batch(us, data).numpy(), rtol=1e-12)
    want = np.array([float(vg(jnp.asarray(u))[0]) for u in us.numpy()])
    np.testing.assert_allclose(model.log_posterior_u_batch(us, data).numpy(), want, rtol=1e-9)


def test_config1_map_reaches_golden(config1):
    _, model, data, vg = config1
    gold = _golden()
    res = map_fit.optimize(model, data, torch.Generator().manual_seed(0), random_starts=8,
                           num_steps=200)
    assert res.all_thetas.shape == (9, 2) and bool(res.converged.all())
    np.testing.assert_allclose(res.theta.numpy(), gold["theta"], rtol=1e-6)
    value, grad = vg(jnp.asarray(res.u.numpy()))
    assert float(jnp.linalg.norm(grad)) <= 1e-6
    np.testing.assert_allclose(float(res.log_posterior), float(value), rtol=1e-9)
    # the wrapper's value at the optimum is the same density
    np.testing.assert_allclose(
        float(model_logp(model, data)(res.u[None])[0]), float(value), rtol=1e-12)


def test_golden_config1_is_stationary(config1):
    _, _, _, vg = config1
    gold = _golden()
    value, grad = vg(jnp.asarray(gold["u"]))
    assert float(jnp.linalg.norm(grad)) <= 1e-6
    np.testing.assert_allclose(float(value), gold["log_posterior"], rtol=1e-9)


@pytest.mark.slow
def test_generate_golden_config1():
    """The reference's MAP on config 1 (about 2 minutes on a CPU)."""
    jp = jconfigs.config1_se_map(seed=0)
    res = jmap.optimize(jp.model, jp.data, jax.random.PRNGKey(0), random_starts=8,
                        num_steps=200)
    out = {
        "params": list(jp.model.param_names),
        "theta": np.asarray(res.theta).tolist(),
        "u": np.asarray(res.u).tolist(),
        "log_posterior": float(res.log_posterior),
        "all_log_posteriors": np.asarray(res.all_log_posteriors).tolist(),
        "dtype": "float64",
        "kwargs": {"seed": 0, "key": "PRNGKey(0)", "random_starts": 8, "num_steps": 200,
                   "method": "lbfgs", "include_current": True},
    }
    if os.environ.get("GOLDEN_CONFIG1_WRITE") == "1":
        with open(GOLDEN, "w") as f:
            json.dump(out, f, indent=1)
    gold = _golden()
    np.testing.assert_allclose(out["theta"], gold["theta"], rtol=1e-10)
    np.testing.assert_allclose(out["log_posterior"], gold["log_posterior"], rtol=1e-12)
