"""The port's entry points (`gptools_tpu_torch.examples`) on the CPU,
float64, against the JAX package.

- ``run_config 1 --cpu`` at full size: theta within 1e-6 of
  `tests/golden_config1.json`; ``--plot`` writes the fit to the current
  directory; without ``--cpu`` and without a card it raises;
- ``run_config 2-5 --cpu`` with each config's ``sampler_kwargs`` cut to a
  few chains and transitions: each runs and prints one line per parameter
  name of the reference's config; ``--mesh`` on config 4 at world size 1
  (gloo) gives the unsharded run's draws, and on config 2 (NUTS) prints the
  reference's warning;
- the sine example with its NUTS run cut to 20 + 20: its MAP theta within 1e-5
  of `tests/golden_sine_map.json`, the reference `GaussianProcess`'s MAP on
  the same data (the test marked slow regenerates it, about a minute; with
  ``GOLDEN_SINE_WRITE=1`` it writes the file); the reference's gradient
  vanishes at the golden's u;
- ``multimodal_pt --cpu --chains 4 --warmup 10 --samples 10`` runs, on config
  4's model and data, which are the reference bench's
  (``bench._flagship_problem``).
"""

import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from gptools_tpu import configs as jconfigs
from gptools_tpu_torch import configs as tconfigs
from gptools_tpu_torch.examples import multimodal_pt, run_config, sine_derivative_constraint

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN1 = os.path.join(HERE, "golden_config1.json")
GOLDEN_SINE = os.path.join(HERE, "golden_sine_map.json")

# each config's sampler_kwargs cut to a few chains and transitions
SMALL = {
    2: dict(num_chains=2, num_warmup=10, num_samples=10),
    3: dict(num_chains=2, num_warmup=10, num_samples=10, num_steps=4),
    4: dict(num_particles=64, num_mutations=2),
    5: dict(num_chains=4, num_warmup=5, num_samples=5, num_particles=64),
}


def _load(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture
def small_configs(monkeypatch):
    for n, kw in SMALL.items():
        build = tconfigs.ALL_CONFIGS[n]

        def cut(*a, _build=build, _kw=kw, **k):
            return dataclasses.replace(_build(*a, **k), sampler_kwargs=dict(_kw))

        monkeypatch.setitem(tconfigs.ALL_CONFIGS, n, cut)


def test_run_config1_golden(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    res = run_config.main(["1", "--cpu", "--plot"])
    gold = _load(GOLDEN1)
    np.testing.assert_allclose(res.theta.numpy(), gold["theta"], rtol=1e-6)
    out = capsys.readouterr().out
    for name, val in zip(gold["params"], gold["theta"]):
        assert f"{name:>12s} = {val:.4f}" in out
    assert f"MAP log posterior: {gold['log_posterior']:.3f}" in out
    assert (tmp_path / "config1_se_map_fit.png").stat().st_size > 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without a card")
def test_run_config_needs_card_or_cpu_flag():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_config.main(["4"])


@pytest.mark.parametrize("config", [2, 3, 4, 5])
def test_run_config_samplers(config, small_configs, capsys):
    res = run_config.main([str(config), "--cpu"])
    assert bool(torch.isfinite(res.thetas).all())
    out = capsys.readouterr().out
    names = jconfigs.ALL_CONFIGS[config]().model.param_names  # the reference's names
    for name in names:
        lines = [ln for ln in out.splitlines() if re.match(rf"\s+{re.escape(name)} = ", ln)]
        assert len(lines) == 1, (name, out)
        assert "ESS" in lines[0] and "Rhat" in lines[0]
    assert f"sampler: {tconfigs.ALL_CONFIGS[config](device='cpu').sampler}; wall:" in out


def test_run_config_mesh(small_configs, capsys):
    """--mesh at world size 1 (gloo): config 4's SMC gives the unsharded
    draws bitwise; config 2's NUTS ignores it with the reference's warning."""
    plain = run_config.main(["4", "--cpu"])
    try:
        sharded = run_config.main(["4", "--cpu", "--mesh"])
        out = capsys.readouterr().out
        assert "mesh: 1 devices over axis ('chains',)" in out
        assert torch.equal(sharded.thetas, plain.thetas)
        run_config.main(["2", "--cpu", "--mesh"])
        assert "WARNING: --mesh ignored" in capsys.readouterr().out
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_sine_example_map(capsys, monkeypatch):
    from gptools_tpu_torch import GaussianProcess

    sample = GaussianProcess.sample_hyperparameter_posterior

    def short(self, nsamp, burn, **kw):
        assert (nsamp, burn) == (500, 300)  # the reference's
        return sample(self, nsamp=20, burn=20, **kw)

    monkeypatch.setattr(GaussianProcess, "sample_hyperparameter_posterior", short)
    res = sine_derivative_constraint.main(["--cpu"])
    gold = _load(GOLDEN_SINE)
    gp = res["gp"]
    np.testing.assert_allclose(gp.theta.numpy(), gold["theta"], rtol=1e-5)
    np.testing.assert_allclose(float(res["map"].log_posterior), gold["log_posterior"],
                               rtol=1e-9)
    assert res["posterior"].thetas.shape == (8, 20, 2)
    out = capsys.readouterr().out
    assert out.startswith("MAP fit: ")
    assert "fully-Bayesian prediction:" in out
    slope = re.search(r"predicted slope at x=1: (\S+) \(true (\S+)\)", out)
    assert slope and float(slope.group(2)) == round(2 * np.cos(2.0), 3)
    assert np.isfinite(res["slope"]) and res["slope_std"] > 0


def _reference_sine_gp():
    from gptools_tpu import GaussianProcess, SquaredExponentialKernel
    from gptools_tpu.utils.priors import LogNormalJointPrior

    rng = np.random.default_rng(0)
    X = np.linspace(0, 3, 25)
    y = np.sin(2 * X) + 0.1 * rng.standard_normal(25)
    gp = GaussianProcess(SquaredExponentialKernel(
        hyperprior=LogNormalJointPrior([0.0, -0.7], [0.8, 0.8])))
    gp.add_data(X, y, err_y=0.1)
    gp.add_data(0.0, 2.0, n=1, err_y=0.05)
    return gp


def test_sine_golden_is_the_reference_optimum():
    """The reference's log posterior at the golden's u has the golden's
    value and a vanishing gradient."""
    gold = _load(GOLDEN_SINE)
    gp = _reference_sine_gp()
    data = gp.data
    vg = jax.jit(jax.value_and_grad(lambda u: gp.model.log_posterior_u(u, data)))
    val, grad = vg(jnp.asarray(gold["u"]))
    np.testing.assert_allclose(float(val), gold["log_posterior"], rtol=1e-12)
    assert float(jnp.linalg.norm(grad)) <= 1e-6


@pytest.mark.slow
def test_generate_golden_sine_map():
    """The reference `GaussianProcess`'s MAP on the sine example (8 random
    starts, PRNGKey(0) by default; about a minute on a CPU)."""
    gp = _reference_sine_gp()
    res = gp.optimize_hyperparameters(random_starts=8)
    out = {
        "params": list(gp.model.param_names),
        "theta": np.asarray(gp.theta).tolist(),
        "u": np.asarray(res.u).tolist(),
        "log_posterior": float(res.log_posterior),
        "dtype": "float64",
        "kwargs": {"random_starts": 8, "key": "GaussianProcess default"},
    }
    if os.environ.get("GOLDEN_SINE_WRITE") == "1":
        with open(GOLDEN_SINE, "w") as f:
            json.dump(out, f, indent=1)
    gold = _load(GOLDEN_SINE)
    np.testing.assert_allclose(out["theta"], gold["theta"], rtol=1e-10)


def test_multimodal_pt(capsys):
    res = multimodal_pt.main(["--cpu", "--chains", "4", "--warmup", "10", "--samples", "10"])
    assert res["nuts"].thetas.shape == (4, 10, 5)
    assert res["pt"].diagnostics["swap_accept"].shape == (5,)
    for r in res.values():
        assert bool(torch.isfinite(r.thetas).all())
    out = capsys.readouterr().out
    assert out.count("max split R-hat:") == 3
    assert "swap acceptance along ladder:" in out


def test_multimodal_model_is_the_bench_problem():
    """The reference example's model and data (``bench._flagship_problem``)
    are config 4's: the same observations and the same prior density."""
    from bench import _flagship_problem

    model, data = _flagship_problem()
    ref4 = jconfigs.config4_gibbs_smc()
    for a in ("Xf", "nid", "y", "err_y"):
        np.testing.assert_array_equal(np.asarray(getattr(data, a)),
                                      np.asarray(getattr(ref4.data, a)))
    assert data.multi_indices == ref4.data.multi_indices
    assert model.param_names == ref4.model.param_names
    thetas = np.random.default_rng(0).uniform(0.05, 1.0, (8, 5))
    for th in thetas:
        assert float(model.log_prior(jnp.asarray(th))) == float(
            ref4.model.log_prior(jnp.asarray(th)))
    port4 = tconfigs.config4_gibbs_smc(device="cpu")
    np.testing.assert_array_equal(port4.data.y.numpy(), np.asarray(data.y))
    np.testing.assert_array_equal(port4.data.Xf.numpy(), np.asarray(data.Xf))
