"""The readers of the program's spans and counters, on synthetic records:
each gives its value, and None where its spans, extents or counters are
absent (an untraced run, the CPU, a program without spans)."""

import importlib
from types import SimpleNamespace

import pytest

READERS = ("smc_pct", "host_syncs_per_transition", "density_device_ms_per_call",
           "backward_device_ms_per_call", "aux_device_ms_per_call", "rows_per_density_call")


def _records(device=True):
    """A solve: a warm start with one density call, then two transitions
    with one differentiated density call each."""
    recs, ids = [], iter(range(1, 100))

    def add(name, parent, ms, **attrs):
        rid = next(ids)
        recs.append({"name": name, "id": rid, "parent": parent, "solve": 1, "start_ns": 0,
                     "end_ns": 1, "attrs": attrs, "device_ms": ms if device else None,
                     "host_ms": 1e-6})
        return rid

    root = add("solve", None, 100.0, counters={
        "launches": {"gibbs_tanh": 3}, "plain_calls": {"gibbs_tanh": 0},
        "route_calls": {"chains_minor": 0, "per_chain": 0},
        "rows": {"kernel": 1024 + 2 * 4096, "chains_minor": 0, "per_chain": 0},
        "host_syncs": {"chees.trajectory_length": 2, "smc.beta": 3, "smc.cholesky": 1,
                       "whitening.cholesky": 1}})
    warm = add("solve.warm_start", root, 10.0)
    d = add("density", warm, 3.0, rows=1024)
    add("density.aux", d, 1.0)
    add("density.evidence", d, 2.0)
    for _ in range(2):
        t = add("chees.transition", root, 40.0)
        d = add("density", t, 6.0, rows=4096)
        add("density.aux", d, 2.0)
        add("density.evidence", d, 4.0)
        add("density.backward", t, 3.0)
        add("sync", t, 0.1, site="chees.trajectory_length")
    return recs


EXPECTED = {
    "smc_pct": 10.0,
    "host_syncs_per_transition": 7 / 2,
    "density_device_ms_per_call": (3.0 + 6.0 + 6.0 + 3.0 + 3.0) / 3,
    "backward_device_ms_per_call": 3.0,
    "aux_device_ms_per_call": (1.0 + 2.0 + 2.0) / 3,
    "rows_per_density_call": (1024 + 2 * 4096) / 3,
}
ON_HOST = {"host_syncs_per_transition", "rows_per_density_call"}
# the span or counter whose absence leaves each reader nothing to read
NEEDS = {
    "smc_pct": "solve.warm_start",
    "host_syncs_per_transition": "chees.transition",
    "density_device_ms_per_call": "density",
    "backward_device_ms_per_call": "density.backward",
    "aux_device_ms_per_call": "density.aux",
    "rows_per_density_call": "density",
}


def _read(name, recs, **ctx):
    mod = importlib.import_module(f"benchmark.metrics.{name}")
    return mod.read(SimpleNamespace(spans=recs, **ctx))


@pytest.mark.parametrize("name", READERS)
def test_reader_value(name):
    assert _read(name, _records()) == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reader_none_without_its_records(name):
    recs = _records()
    assert _read(name, [r for r in recs if r["name"] != NEEDS[name]]) is None
    assert _read(name, None, trace=None) is None  # an untraced run
    on_cpu = _read(name, _records(device=False))
    assert (on_cpu == pytest.approx(EXPECTED[name])) if name in ON_HOST else on_cpu is None
    if name in ON_HOST:
        del recs[0]["attrs"]["counters"]
        assert _read(name, recs) is None


def test_reader_none_when_the_program_has_no_spans(monkeypatch):
    """A traced run of a program without `last_solve` (or with no recorded
    solve) reads nothing and raises nothing."""
    from gptools_tpu_torch.utils import metrics

    monkeypatch.delattr(metrics, "last_solve", raising=False)
    for name in READERS:
        assert _read(name, None, trace=object()) is None
