"""The port's utilities against the JAX package, float64 on the CPU.

- combinatorics (Bell polynomials, set partitions, the Pochhammer symbol)
  for n <= 6: exactly the reference's on integers, within 1e-12 on floats;
- `error_handling`: the same exception classes on the same inputs;
- `compute_stats` and `summarize_sampler` within 1e-12 of the reference's
  on the same numpy draws, robust or not, with and without ``check_nan``;
  the two plots write a PNG (skipped without matplotlib);
- `unique_rows` equal to the reference's;
- the full-matrix chains-minor builders within 1e-12 of the reference's
  and of the port's symmetric builders;
- checkpoints: a round trip in the template's types, dtypes and devices;
  the manager's interval and retention; and a run resumed from a
  checkpoint (positions, dual averaging and the generator's state) equal
  to the uninterrupted run, through `hmc.run_window` with the HMC and
  NUTS transitions.
"""

import os

import numpy as np
import pytest
import torch

import gptools_tpu.utils as jutils
from gptools_tpu.ops import fused as jfused
from gptools_tpu.utils import combinatorics as jcomb
from gptools_tpu.utils import error_handling as jerr
from gptools_tpu.utils import plotting as jplot
import gptools_tpu_torch.utils as tutils
from gptools_tpu_torch.infer import hmc, nuts
from gptools_tpu_torch.infer.smc import SMCState
from gptools_tpu_torch.ops import fused as tfused
from gptools_tpu_torch.utils import combinatorics as tcomb
from gptools_tpu_torch.utils import error_handling as terr
from gptools_tpu_torch.utils import plotting as tplot
from gptools_tpu_torch.utils.checkpoint import CheckpointManager, restore_state, save_state

torch.set_num_threads(1)


@pytest.mark.parametrize("n", range(7))
def test_combinatorics_match_reference(n):
    assert tcomb.generate_set_partition_strings(n) == jcomb.generate_set_partition_strings(n)
    assert tcomb.generate_set_partitions(range(n)) == jcomb.generate_set_partitions(range(n))
    assert tcomb.generate_set_partitions("abcdef"[:n]) == jcomb.generate_set_partitions(
        "abcdef"[:n])
    rng = np.random.default_rng(n)
    xf = rng.standard_normal((max(n, 1), 3))
    xi = rng.integers(-3, 4, max(n, 1))
    for q in range(n + 1):
        assert tcomb.incomplete_bell_poly(n, q, xi) == jcomb.incomplete_bell_poly(n, q, xi)
        np.testing.assert_allclose(tcomb.incomplete_bell_poly(n, q, xf),
                                   jcomb.incomplete_bell_poly(n, q, xf), rtol=1e-12,
                                   atol=1e-12)
    a_int = np.arange(-4, 5)
    assert np.array_equal(tcomb.fixed_poch(a_int, n), jcomb.fixed_poch(a_int, n))
    assert tcomb.fixed_poch(-2, n) == jcomb.fixed_poch(-2, n)
    a = rng.uniform(0.1, 3.0, 5)
    np.testing.assert_allclose(tcomb.fixed_poch(a, n), jcomb.fixed_poch(a, n), rtol=1e-12)
    np.testing.assert_allclose(tcomb.fixed_poch(a, n + 0.5), jcomb.fixed_poch(a, n + 0.5),
                               rtol=1e-12)
    for mod in (tcomb, jcomb):
        with pytest.raises(ValueError):
            mod.incomplete_bell_poly(n, -1, xi)
    assert tutils.fixed_poch is tcomb.fixed_poch and tutils.incomplete_bell_poly is \
        tcomb.incomplete_bell_poly


def _raised(fn, *args):
    try:
        fn(*args)
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return type(e).__name__, isinstance(e, ValueError)
    return None


@pytest.mark.parametrize("theta,bounds", [
    ([0.5, 1.0], None),
    ([0.5, np.nan], None),
    ([np.inf, 1.0], [(0, 1), (0, 2)]),
    ([0.5, 3.0], [(0, 1), (0, 2)]),
    ([0.5, 1.0], [(0, 1), (0, 2)]),
])
def test_error_handling_matches_reference(theta, bounds):
    want = _raised(jerr.check_finite_params, np.asarray(theta), bounds)
    assert _raised(terr.check_finite_params, np.asarray(theta), bounds) == want
    assert _raised(terr.check_finite_params, torch.tensor(theta), bounds) == want
    assert issubclass(terr.GPArgumentError, ValueError)
    assert terr.GPImpossibleParamsError.__name__ == jerr.GPImpossibleParamsError.__name__


@pytest.mark.parametrize("robust", [False, True])
@pytest.mark.parametrize("check_nan", [False, True])
def test_stats_and_summary_match_reference(robust, check_nan):
    rng = np.random.default_rng(3)
    draws = rng.standard_normal((4, 120, 3)) * [1.0, 0.3, 2.0] + [0.0, 1.0, -2.0]
    vals = draws.reshape(-1, 3).copy()
    if check_nan:
        vals[::17, 1] = np.nan
    for axis in (0, 1):
        want = jplot.compute_stats(vals, check_nan=check_nan, robust=robust, axis=axis)
        got = tplot.compute_stats(torch.tensor(vals), check_nan=check_nan, robust=robust,
                                  axis=axis)
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.ma.filled(g, np.nan), np.ma.filled(w, np.nan),
                                       rtol=1e-12, atol=1e-12)
    burn = 10 if robust else 0
    want = jplot.summarize_sampler(draws, param_names=["a", "b", "c"], burn=burn)
    res = hmc.SampleResult(u=torch.tensor(draws), thetas=torch.tensor(draws),
                           log_prob=torch.zeros(4, 120), diagnostics={})
    got = tplot.summarize_sampler(res, param_names=["a", "b", "c"], burn=burn)
    assert set(got) == set(want) and got["params"] == want["params"]
    for k in ("mean", "std", "q05", "q50", "q95", "ess", "rhat", "ci_low", "ci_high"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-12, atol=1e-12,
                                   err_msg=k)


def test_plots_write_png(tmp_path):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(0)
    res = hmc.SampleResult(u=torch.tensor(rng.standard_normal((2, 50, 3))), thetas=None,
                           log_prob=torch.zeros(2, 50), diagnostics={})
    fig = tplot.plot_sampler(res, path=str(tmp_path / "corner.png"))
    x = torch.linspace(0, 1, 20, dtype=torch.float64)
    ax = tplot.univariate_envelope_plot(x, torch.sin(x), std=0.1 * torch.ones(20),
                                        label="f", path=str(tmp_path / "env.png"))
    for name in ("corner.png", "env.png"):
        with open(tmp_path / name, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert len(fig.axes) == 9 and ax.figure is not None


def test_unique_rows_matches_reference():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 3, (40, 2)).astype(float)
    np.testing.assert_array_equal(tutils.unique_rows(a), jutils.unique_rows(a))
    assert tutils.CombinedBounds and tutils.MaskedBounds
    with pytest.raises(ValueError):
        tutils.unique_rows(np.zeros(3))


@pytest.mark.parametrize("kind,P", [("se", 2), ("gibbs_tanh", 5), ("matern52", 2)])
def test_full_soa_builders_match_reference(kind, P):
    rng = np.random.default_rng(4)
    X = np.linspace(0.0, 1.2, 9)
    nid = np.array([0, 0, 1, 0, 0, 1, 0, 1, 0])
    th = rng.uniform(0.4, 1.2, (P, 6))
    if kind == "gibbs_tanh":
        th[3] = rng.uniform(0.02, 0.1, 6)
    want = np.asarray(getattr(jfused, f"{kind}_cov_fused_soa")(X, nid, th))
    args = (torch.tensor(X), torch.tensor(nid), torch.tensor(th))
    got = getattr(tfused, f"{kind}_cov_fused_soa")(*args).numpy()
    sym = getattr(tfused, f"{kind}_cov_fused_soa_sym")(*args).numpy()
    scale = np.abs(want).max()
    assert got.shape == (9, 9, 6)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * scale)
    np.testing.assert_allclose(got, sym, rtol=1e-12, atol=1e-12 * scale)


def test_checkpoint_round_trip_in_template_types(tmp_path):
    gen = torch.Generator().manual_seed(11)
    torch.rand(3, generator=gen)
    state = {
        "smc": SMCState(u=torch.randn(4, 2, dtype=torch.float64), log_like=torch.zeros(4),
                        log_prior=torch.ones(4, dtype=torch.float64),
                        beta=torch.tensor(0.25, dtype=torch.float64),
                        log_z=torch.tensor(-1.5), acc_rate=torch.tensor(0.4)),
        "welford": hmc.welford_init(2, torch.float64),
        "generator": gen,
        "gen_state": gen.get_state(),
        "iteration": 7,
        "rate": 0.5,
        "names": ["a", ("b", None)],
    }
    path = tmp_path / "sub" / "state.pt"
    save_state(str(path), state)
    assert os.listdir(tmp_path / "sub") == ["state.pt"]
    # the template's dtypes win
    template = dict(state, smc=state["smc"]._replace(log_like=torch.zeros(4, dtype=torch.float64)))
    back = restore_state(str(path), template=template)
    assert isinstance(back["smc"], SMCState) and isinstance(back["welford"], hmc.WelfordState)
    assert back["smc"].log_like.dtype == torch.float64
    torch.testing.assert_close(back["smc"].u, state["smc"].u, rtol=0, atol=0)
    assert back["iteration"] == 7 and isinstance(back["iteration"], int)
    assert back["rate"] == 0.5 and back["names"] == ["a", ("b", None)]
    assert isinstance(back["generator"], torch.Generator)
    assert torch.equal(torch.rand(5, generator=back["generator"]), torch.rand(5, generator=gen))
    plain = restore_state(str(path))
    assert set(plain["smc"]) == set(SMCState._fields)
    assert torch.equal(plain["generator"], state["gen_state"])
    with pytest.raises(ValueError):
        restore_state(str(path), template=dict(state, iteration=[1]))
    with pytest.raises(TypeError):
        save_state(str(tmp_path / "bad.pt"), {"f": object()})
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp-")]


def test_checkpoint_manager_interval_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2, save_every=3)
    assert mgr.latest_step is None and mgr.restore() is None
    saved = [mgr.save(s, {"x": torch.tensor(float(s))}) for s in range(10)]
    assert saved == [s % 3 == 0 for s in range(10)]
    assert mgr.latest_step == 9
    assert sorted(os.listdir(mgr.directory)) == ["6.pt", "9.pt"]
    assert not mgr.save(9, {"x": torch.tensor(0.0)})
    assert float(mgr.restore()["x"]) == 9.0
    assert float(mgr.restore(6, template={"x": torch.tensor(0.0)})["x"]) == 6.0
    mgr.close()


def _gauss_lg():
    prec = torch.tensor([[2.0, -0.6], [-0.6, 1.0]], dtype=torch.float64)

    def logp(u):
        return -0.5 * ((u @ prec) * u).sum(-1)

    return hmc.value_and_grad(logp)


@pytest.mark.parametrize("kind", ["hmc", "nuts"])
def test_checkpoint_resume_equals_uninterrupted(tmp_path, kind):
    lg = _gauss_lg()
    if kind == "hmc":
        def transition(q, lp, g, gen, eps, inv_mass):
            return hmc._hmc_transition(lg, q, lp, g, gen, eps, inv_mass, 8)
    else:
        transition = nuts.nuts_transition_builder(max_depth=6)(lg)
    qs = torch.randn(6, 2, dtype=torch.float64, generator=torch.Generator().manual_seed(2))
    da0 = hmc.da_init(torch.tensor(0.2, dtype=torch.float64))
    inv_mass = torch.ones(2, dtype=torch.float64)

    gen = torch.Generator().manual_seed(5)
    qs_a, da_a, _, _ = hmc.run_window(transition, qs, gen, 20, da0, inv_mass)
    qs_b, da_b, w_b, outs_b = hmc.run_window(transition, qs_a, gen, 20, da_a, inv_mass,
                                             collect_welford=True)

    gen = torch.Generator().manual_seed(5)
    qs_a2, da_a2, _, _ = hmc.run_window(transition, qs, gen, 20, da0, inv_mass)
    path = str(tmp_path / "resume.pt")
    save_state(path, {"qs": qs_a2, "da": da_a2, "gen": gen})
    del gen
    back = restore_state(path, template={"qs": torch.zeros(6, 2, dtype=torch.float64),
                                         "da": da0, "gen": torch.Generator()})
    qs_c, da_c, w_c, outs_c = hmc.run_window(transition, back["qs"], back["gen"], 20,
                                             back["da"], inv_mass, collect_welford=True)
    assert torch.equal(qs_c, qs_b)
    assert torch.equal(da_c.log_eps, da_b.log_eps)
    assert torch.equal(w_c.m2, w_b.m2) and float(w_b.count) == 20 * 6
    assert torch.equal(outs_c["u"], outs_b["u"]) and outs_b["u"].shape == (6, 20, 2)
    assert outs_b["eps"].shape == (20,)
