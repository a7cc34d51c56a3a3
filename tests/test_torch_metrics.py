"""The port's `utils.metrics` (`MetricsLogger`, `trace`) and the samplers'
``metrics=``: the window records of `infer.hmc.sample` (HMC and NUTS) and
`infer.pt.sample` carry the reference's keys, phases, lengths and window
counts (the reference's samplers run beside them with its own logger), the
final record holds ESS and split R-hat as `diagnostics.ess_and_rhat`
computes them, and the JSONL file holds one line per record."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gptools_tpu.infer import hmc as jhmc
from gptools_tpu.infer import pt as jpt
from gptools_tpu.models.dataset import DatasetBuilder as JBuilder
from gptools_tpu.models.gp import GPModel as JGPModel
from gptools_tpu.ops import kernels as JK
from gptools_tpu.utils.metrics import MetricsLogger as JLogger
from gptools_tpu_torch import convert
from gptools_tpu_torch.infer import hmc, nuts, pt
from gptools_tpu_torch.utils import diagnostics
from gptools_tpu_torch.utils.metrics import MetricsLogger, trace

torch.set_num_threads(1)


def _windows(log):
    return [r for r in log.records if r["event"] == "window"]


def _same_windows(port_log, ref_log):
    got, want = _windows(port_log), _windows(ref_log)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert (g["phase"], g["length"]) == (w["phase"], w["length"])
        assert np.shape(g["step_size"]) == np.shape(w["step_size"])
        assert 0.0 <= g["mean_accept"] <= 1.0 and g["divergences"] >= 0


def test_hmc_and_nuts_windows_match_the_reference(tmp_path):
    """A standard normal in 3 dimensions, 4 chains, 150 warmup (the
    reference's schedule: 4 windows) + 20 samples."""
    def logp_t(u):
        return -0.5 * (u * u).sum(-1)

    def logp_j(u):
        return -0.5 * jnp.sum(u * u)

    u0 = np.random.default_rng(0).standard_normal((4, 3))
    for transition in ("hmc", "nuts"):
        log = MetricsLogger(path=str(tmp_path / f"{transition}.jsonl"), run_name=transition)
        gen = torch.Generator().manual_seed(0)
        if transition == "hmc":
            res = hmc.sample(logp_t, torch.tensor(u0), gen, num_warmup=150, num_samples=20,
                             num_steps=8, metrics=log)
            spec = None
        else:
            res = nuts.sample(logp_t, torch.tensor(u0), gen, num_warmup=150, num_samples=20,
                              max_depth=5, metrics=log)
            spec = ("nuts", 5, 1000.0)
        ref = JLogger(run_name=transition)
        jhmc.sample(logp_j, jnp.asarray(u0), jax.random.PRNGKey(0), num_warmup=150,
                    num_samples=20, num_steps=8, transition_spec=spec, metrics=ref)
        _same_windows(log, ref)
        windows = _windows(log)
        assert [w["phase"] for w in windows] == [p for p, _ in hmc.warmup_schedule(150)] + [
            "sampling"]
        assert windows[-1]["leapfrogs"] == int(res.diagnostics["num_leapfrog_total"])
        assert windows[-1]["divergences"] == int(res.diagnostics["divergences"])
        lines = (tmp_path / f"{transition}.jsonl").read_text().splitlines()
        assert [json.loads(line) for line in lines] == log.records


def test_pt_windows_match_the_reference():
    """Parallel tempering on a 4-point SE model: 3 rungs x 2 chains, 100
    warmup + 10 samples; step sizes per rung and swap fractions as the
    reference's."""
    b = JBuilder(1)
    b.add(np.linspace(0.0, 1.0, 4), np.sin(np.linspace(0.0, 1.0, 4)), err_y=0.1)
    jd = b.build(dtype=jnp.float64)
    jm = JGPModel(JK.SquaredExponentialKernel(
        param_bounds=[(0.1, 3.0), (0.1, 3.0)]))
    tm, td = convert.model_from_jax(jm), convert.dataset_from_jax(jd, torch.float64, "cpu")
    log, ref = MetricsLogger(run_name="pt"), JLogger(run_name="pt")
    pt.sample(tm, td, torch.Generator().manual_seed(0), num_chains=2, num_temps=3,
              num_warmup=100, num_samples=10, num_steps=4, metrics=log)
    jpt.sample(jm, jd, jax.random.PRNGKey(0), num_chains=2, num_temps=3, num_warmup=100,
               num_samples=10, num_steps=4, metrics=ref)
    _same_windows(log, ref)
    windows = _windows(log)
    assert windows[-1]["phase"] == "pt-sampling"
    assert all(len(w["step_size"]) == 3 and 0.0 <= w["mean_swap_frac"] <= 1.0
               for w in windows)


def test_finalize_and_trace(tmp_path, rng):
    """The final record holds `ess_and_rhat`'s values and ESS per second;
    `trace` writes a profiler trace of what it encloses."""
    log = MetricsLogger(run_name="t")
    s = torch.tensor(rng.standard_normal((4, 200, 2)))
    with trace(str(tmp_path / "trace")):
        rec = log.finalize(s, wall_time=2.0)
    ess, rhat = diagnostics.ess_and_rhat(s)
    np.testing.assert_allclose(rec["ess"], ess, rtol=1e-12)
    np.testing.assert_allclose(rec["rhat"], rhat, rtol=1e-12)
    assert rec["ess_per_s"] == rec["min_ess"] / 2.0 and rec["event"] == "final"
    assert set(rec) == set(JLogger().finalize(np.asarray(s), wall_time=2.0))
    assert list((tmp_path / "trace").iterdir())
