"""The solve's spans and counters (`gptools_tpu_torch.utils.metrics`): a
config-4 model on the plain evidence path, `smc_then_chees` at a few chains
and 3 + 3 transitions, on the CPU.

- off (no profiler, no `spans()`), nothing is recorded, and the draws,
  log posteriors and diagnostics are the bits of a recorded run;
- under `torch.profiler` the span tree is the documented one: one root,
  every span's solve the root's, a ``chees.transition`` per transition, a
  ``density`` per density call by the evidence counters, a
  ``density.backward`` per differentiated call, a trajectory-length sync
  per transition;
- every record has the profiler's ``record_function`` event of its name,
  starting and ending within 1 ms of it;
- `span_table`'s host self times add up to the root's host time;
- `trace` writes the records beside its Chrome trace; NUTS's
  ``host_syncs`` is the growth of its sites' counts.
"""

import gc
import json
from collections import Counter, defaultdict

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from gptools_tpu_torch import configs as tconfigs
from gptools_tpu_torch.infer import nuts as tnuts
from gptools_tpu_torch.infer.pipeline import smc_then_chees
from gptools_tpu_torch.utils import metrics

torch.set_num_threads(1)

WARMUP, SAMPLES = 3, 3
PHASES = ("solve.warm_start", "solve.whitening", "solve.warmup", "solve.sampling",
          "solve.finish")


@pytest.fixture(scope="module")
def prob():
    return tconfigs.config4_gibbs_smc(dtype=torch.float64, device="cpu")


class _GradCalls:
    """Counts the model's batched density calls that are differentiated."""

    def __init__(self, model):
        self.inner = model.log_posterior_u_batch
        self.n = 0
        model.log_posterior_u_batch = self

    def __call__(self, us, *args, **kwargs):
        self.n += bool(us.requires_grad)
        return self.inner(us, *args, **kwargs)


def _solve(prob, seed=5):
    gen = torch.Generator().manual_seed(seed)
    return smc_then_chees(prob.model, prob.data, gen, num_chains=8, num_warmup=WARMUP,
                          num_samples=SAMPLES, num_particles=64)


def _calls(counters):
    return sum(sum(counters[g].values()) for g in ("launches", "plain_calls", "route_calls"))


def _root(recs):
    roots = [r for r in recs if r["parent"] is None]
    assert len(roots) == 1 and roots[0]["name"] == "solve"
    return roots[0]


def test_off_records_nothing_and_keeps_the_bits(prob):
    with metrics.spans():
        on = _solve(prob)
    recorded = metrics.last_solve()
    assert recorded and _root(recorded)["attrs"]["counters"]["rows"]["kernel"] > 0
    off = _solve(prob)
    assert metrics.last_solve() == recorded  # the unrecorded solve left nothing
    assert torch.equal(on.u, off.u) and torch.equal(on.thetas, off.thetas)
    assert torch.equal(on.log_prob, off.log_prob)
    assert on.diagnostics.keys() == off.diagnostics.keys()
    for k, v in on.diagnostics.items():
        w = off.diagnostics[k]
        assert torch.equal(v, w) if torch.is_tensor(v) else v == w, k


def test_span_tree_under_the_profiler(prob):
    probe = _GradCalls(prob.model)
    try:
        syncs0 = metrics.HOST_SYNCS["chees.trajectory_length"]
        # a garbage collection between a span's stamp and the profiler's
        # would part them by its pause
        gc.disable()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            # the profiler's first range in a process pays a one-time
            # start-up inside it; take it here, outside the solve
            with record_function("warm"):
                pass
            _solve(prob)
        recs = metrics.last_solve()
    finally:
        gc.enable()
        del prob.model.log_posterior_u_batch
    root = _root(recs)
    counters = root["attrs"]["counters"]
    names = Counter(r["name"] for r in recs)
    assert {r["solve"] for r in recs} == {root["id"]}
    ids = {r["id"] for r in recs}
    assert len(ids) == len(recs) and all(r["parent"] in ids for r in recs if r is not root)
    assert all(names[p] == 1 for p in PHASES)
    assert names["chees.transition"] == WARMUP + SAMPLES
    assert names["density"] == _calls(counters) > 0
    assert names["density.backward"] == probe.n > 0
    assert sum(r["attrs"]["rows"] for r in recs if r["name"] == "density") == sum(
        counters["rows"].values())
    steps = counters["host_syncs"]["chees.trajectory_length"]
    assert steps == WARMUP + SAMPLES == metrics.HOST_SYNCS["chees.trajectory_length"] - syncs0
    assert counters["host_syncs"]["chees.halton"] == WARMUP + SAMPLES
    assert sum(counters["host_syncs"].values()) == names["sync"]
    assert counters["host_syncs"]["smc.beta"] == 2 * names["smc.round"] + 1
    # each density call's children, and the nesting of the phases
    by_id = {r["id"]: r for r in recs}
    for r in recs:
        if r["name"].startswith("density.") and r["name"] != "density.backward":
            assert by_id[r["parent"]]["name"] == "density"
        if r["name"] in PHASES:
            assert r["parent"] == root["id"]
        if r["name"] == "smc.round":
            assert by_id[r["parent"]]["name"] == "solve.warm_start"
    # each record is a record_function range of the profiler, within 1 ms
    events = defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and e.name() in names:
            events[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    for name, n in names.items():
        mine = sorted((r["start_ns"], r["end_ns"]) for r in recs if r["name"] == name)
        theirs = sorted(events[name])
        assert len(theirs) == n, name
        for (a0, a1), (b0, b1) in zip(mine, theirs):
            assert abs(a0 - b0) < 1_000_000 and abs(a1 - b1) < 1_000_000, name
    # host self times add up to the root's host time
    table = metrics.span_table(recs)
    assert sum(v["count"] for v in table.values()) == len(recs)
    total = sum(v["host_self_ms"] for v in table.values())
    assert total == pytest.approx(root["host_ms"], rel=1e-9)
    assert all(v["device_ms"] is None for v in table.values())  # no card


def test_trace_writes_the_spans(prob, tmp_path):
    with metrics.trace(str(tmp_path)):
        _solve(prob, seed=6)
    lines = (tmp_path / "spans.jsonl").read_text().splitlines()
    recs = [json.loads(line) for line in lines]
    assert recs == metrics.last_solve()
    assert Counter(r["name"] for r in recs)["chees.transition"] == WARMUP + SAMPLES
    assert any(p.name.endswith(".pt.trace.json") for p in tmp_path.iterdir())


def test_nuts_host_syncs_are_its_sites_counts(prob):
    from gptools_tpu_torch.infer import model_logp

    gen = torch.Generator().manual_seed(2)
    u0 = prob.model.u_of_theta(prob.model.hyperprior.sample(gen, (4,), torch.float64))
    with metrics.spans():
        res = tnuts.sample(model_logp(prob.model, prob.data), u0, gen, num_warmup=3,
                           num_samples=3, max_depth=3)
    recs = metrics.last_solve()
    counts = _root(recs)["attrs"]["counters"]["host_syncs"]
    sites = Counter(r["attrs"]["site"] for r in recs if r["name"] == "sync")
    assert res.diagnostics["host_syncs"] == counts["nuts.leaf"] + counts["nuts.doubling"] > 0
    assert sites == Counter({k: v for k, v in counts.items() if v})
    assert Counter(r["name"] for r in recs)["solve.sampling"] == 1
