"""Streaming inference metrics, a profiler trace, and the solve's spans
and counters.

Counterpart of `gptools_tpu.utils.metrics`: a `MetricsLogger` keeps (and,
given a path, appends to JSONL) one record per adaptation or sampling
window of a sampler (step size, mean acceptance, divergences, leapfrogs,
for parallel tempering the mean swap fraction) and a final record with
ESS, split R-hat and ESS per second (`utils.diagnostics.ess_and_rhat`: on
the card for samples there, through the native library for host
samples). `infer.hmc.sample` (HMC and NUTS) and `infer.pt.sample` log to
it when given ``metrics=``; each window record reads its values to the
host once. `trace` records a `torch.profiler` trace of the CPU and, when
there is one, the card.

Spans. A solve (one call of a pipeline or sampler entry, `solve_entry`)
is a tree of named ranges at the program's layer boundaries: ``solve``,
its phases ``solve.warm_start``, ``solve.whitening``, ``solve.warmup``,
``solve.sampling`` and ``solve.finish``, ``smc.round``,
``chees.transition``, ``sync`` (attribute ``site``), ``density``
(attribute ``rows``; the outermost batched density call of `GPModel`),
its children ``density.bijector``, ``density.prior``, ``density.aux`` and
``density.evidence``, and ``density.backward`` (the gradient's backward
pass). Recording is decided once, when the root opens: it is on while a
`torch.profiler` session is active, where each span is also a
``record_function`` range on the kernels' timeline, and inside `spans()`.
While it is on each span keeps a record in memory (`last_solve`): its
name, id, parent, solve, host start and end in Unix ns (the profiler's
clock), attributes, and on the card its device extent, the time between
two CUDA events recorded at its boundaries on the solve's stream (the
current one when the root opened; none while the current stream captures
a graph), resolved when the records are read. Off, a span is one global
check and a shared no-op context: no device work, no sync, no
allocation. Only the open solve's records and the last finished one's
are kept.

Counters, always on, as `ops.evidence_cuda.LAUNCHES`: `HOST_SYNCS` counts
each call on the solve path that makes the host wait for the card (a
device-to-host read, or a copy of a host value to the card) by its site
(`host_sync`); the root's record holds the deltas over its solve of
these and of `evidence_cuda`'s ``LAUNCHES``, ``PLAIN_CALLS``,
``ROUTE_CALLS`` and ``ROWS``. `span_table` sums records by name.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import time
from collections import defaultdict
from typing import Optional

import numpy as np
import torch

__all__ = [
    "MetricsLogger",
    "trace",
    "HOST_SYNCS",
    "reset_counts",
    "host_sync",
    "span",
    "density",
    "solve_entry",
    "spans",
    "last_solve",
    "span_table",
]


def _host(v):
    """A tensor or array as numpy, on the host."""
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


class MetricsLogger:
    """Append-only metrics stream for a sampling run."""

    def __init__(self, path: Optional[str] = None, run_name: str = "run"):
        self.path = path
        self.run_name = run_name
        self.records = []
        self._t0 = time.perf_counter()
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, event: str, **fields):
        rec = {
            "run": self.run_name,
            "event": event,
            "t": round(time.perf_counter() - self._t0, 4),
        }
        for k, v in fields.items():
            if torch.is_tensor(v):
                v = _host(v)
            if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
                v = v.item()
            elif hasattr(v, "tolist"):
                v = v.tolist()
            rec[k] = v
        self.records.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec

    def log_window(self, phase: str, length: int, outs: dict):
        """Summarize one window from the sampler's per-iteration outputs:
        ``eps`` stacked over iterations on axis 0 (a scalar per iteration
        for HMC / NUTS, one per rung for PT), ``accept_prob`` and
        ``diverged`` per chain, optionally ``num_leapfrog`` and
        ``swap_frac``."""
        fields = dict(
            phase=phase,
            length=length,
            step_size=_host(outs["eps"])[-1],
            mean_accept=float(np.mean(_host(outs["accept_prob"]))),
            divergences=int(np.sum(_host(outs["diverged"]))),
        )
        if "num_leapfrog" in outs:
            fields["leapfrogs"] = int(np.sum(_host(outs["num_leapfrog"])))
        if "swap_frac" in outs:  # parallel tempering windows
            fields["mean_swap_frac"] = float(np.mean(_host(outs["swap_frac"])))
        return self.log("window", **fields)

    def finalize(self, samples, wall_time: Optional[float] = None):
        """Log end-of-run ESS and split R-hat of (chains, samples, dim)
        samples (`diagnostics.ess_and_rhat`), and ESS per second given the
        wall time."""
        from gptools_tpu_torch.utils.diagnostics import ess_and_rhat

        ess, rhat = ess_and_rhat(samples)
        ess, rhat = np.asarray(ess), np.asarray(rhat)
        fields = dict(ess=ess, rhat=rhat, min_ess=float(ess.min()))
        if wall_time is not None:
            fields["wall_s"] = wall_time
            fields["ess_per_s"] = float(ess.min() / wall_time)
        return self.log("final", **fields)


# -- counters ------------------------------------------------------------------

# calls on the solve path that make the host wait for the card, by site
# (`host_sync`): device-to-host reads, and copies of host values to the card
# (PyTorch's copy from pageable memory waits for the stream)
HOST_SYNCS = {
    "chees.trajectory_length": 0,  # chees_step's int(L)
    "chees.halton": 0,             # chees_step's Halton number, copied to the card
    "model.initial_params": 0,     # GPModel._fixed's tensors, copied to the card once
                                   # a (dtype, device); none for an all-free model
    "smc.beta": 0,                 # the tempering loop's reads of beta
    "smc.cholesky": 0,             # the proposal factor's info check
    "whitening.cholesky": 0,       # the ensemble factor's info check
    "nuts.leaf": 0,                # NUTS: any chain still building?
    "nuts.doubling": 0,            # NUTS: any chain still doubling?
}


def reset_counts() -> None:
    """Set every host-sync count to 0."""
    for k in HOST_SYNCS:
        HOST_SYNCS[k] = 0


def _counts() -> dict:
    """The program's counters now, copied: evidence launches, plain calls,
    route calls and rows (`ops.evidence_cuda`), and `HOST_SYNCS`."""
    from gptools_tpu_torch.ops import evidence_cuda as ev

    return {"launches": dict(ev.LAUNCHES), "plain_calls": dict(ev.PLAIN_CALLS),
            "route_calls": dict(ev.ROUTE_CALLS), "rows": dict(ev.ROWS),
            "host_syncs": dict(HOST_SYNCS)}


# -- spans ---------------------------------------------------------------------

_NULL = contextlib.nullcontext()
_REC = None          # the open solve's recorder while recording, else None
_OPEN = False        # a solve is open (recording or not)
_LAST = None         # the last finished solve's recorder
_FORCED = 0          # depth of `spans()` contexts
_POOL = []           # CUDA events for reuse
_IDS = itertools.count(1)


class _Recorder:
    """The records of one solve while it runs."""

    def __init__(self, device, profiled: bool):
        self.cuda = device is not None and torch.device(device).type == "cuda"
        # the solve's stream: where its events go (asking for the current
        # stream at each boundary would cost as much as the record)
        self.stream = torch.cuda.current_stream(device) if self.cuda else None
        self.profiled = profiled
        self.records = []
        self.stack = []
        self.density_depth = 0
        self.solve = None
        self.events = []
        self.resolved = False

    def _event(self):
        """A CUDA event recorded on the solve's stream now, or None while
        the current stream captures a graph."""
        if torch.cuda.is_current_stream_capturing():
            return None
        ev = _POOL.pop() if _POOL else torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        self.events.append(ev)
        return ev


class _Span:
    """One open span of a recording solve."""

    __slots__ = ("rec", "name", "attrs", "rf", "rec_dict", "ev0", "density")

    def __init__(self, rec: _Recorder, name: str, attrs: dict, density: bool = False):
        self.rec, self.name, self.attrs, self.density = rec, name, attrs, density

    def __enter__(self):
        rec = self.rec
        self.rf = None
        if rec.profiled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        start = time.time_ns()  # the stamps sit just inside the profiler's
        sid = next(_IDS)
        if rec.solve is None:
            rec.solve = sid
        self.rec_dict = {"name": self.name, "id": sid,
                         "parent": rec.stack[-1] if rec.stack else None,
                         "solve": rec.solve, "start_ns": start, "end_ns": None,
                         "attrs": self.attrs}
        self.ev0 = rec._event() if rec.cuda else None
        rec.stack.append(sid)
        rec.density_depth += self.density
        return self

    def __exit__(self, *exc):
        rec = self.rec
        ev1 = rec._event() if self.ev0 is not None else None
        if self.rf is not None:
            self.rf.__exit__(*exc)
        d = self.rec_dict
        d["end_ns"] = time.time_ns()
        d["_events"] = (self.ev0, ev1) if ev1 is not None else None
        rec.stack.pop()
        rec.density_depth -= self.density
        rec.records.append(d)
        return False


def span(name: str, **attrs):
    """The span ``name`` while a solve records, else a shared no-op
    context."""
    rec = _REC
    if rec is None:
        return _NULL
    return _Span(rec, name, attrs)


def density(rows: int):
    """The ``density`` span (attribute ``rows``) when no density call is
    open already: the outermost of the model's batched density calls."""
    rec = _REC
    if rec is None or rec.density_depth:
        return _NULL
    return _Span(rec, "density", {"rows": int(rows)}, density=True)


def host_sync(site: str):
    """Counts one wait of the host for the card at ``site`` in
    `HOST_SYNCS`; while a solve records, the ``sync`` span around it."""
    HOST_SYNCS[site] += 1
    rec = _REC
    if rec is None:
        return _NULL
    return _Span(rec, "sync", {"site": site})


class _Root:
    """The ``solve`` span: decides recording, keeps the counters' deltas
    and hands the finished records to `last_solve`."""

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        global _REC, _OPEN
        _OPEN = True
        profiled = torch.autograd.profiler._is_profiler_enabled
        if not (profiled or _FORCED):
            self.span = None
            return self
        _REC = _Recorder(self.device, profiled)
        self.counts0 = _counts()
        self.span = _Span(_REC, "solve", {})
        self.span.__enter__()
        return self

    def __exit__(self, *exc):
        global _REC, _OPEN, _LAST
        _OPEN = False
        if self.span is None:
            return False
        rec = _REC
        try:
            self.span.__exit__(*exc)
        finally:
            _REC = None
        now = _counts()
        self.span.rec_dict["attrs"]["counters"] = {
            group: {k: v - self.counts0[group].get(k, 0) for k, v in now[group].items()}
            for group in now
        }
        old, _LAST = _LAST, rec
        if old is not None:
            _POOL.extend(old.events)
        return False


def solve_entry(fn):
    """Decorator of a public pipeline or sampler entry: the root ``solve``
    span around the call, unless a solve is open already. Its device is
    that of the call's `torch.Generator` argument."""

    @functools.wraps(fn)
    def entry(*args, **kwargs):
        if _OPEN:
            return fn(*args, **kwargs)
        gen = kwargs.get("generator")
        if gen is None:
            gen = next((a for a in args if isinstance(a, torch.Generator)), None)
        with _Root(gen.device if gen is not None else None):
            return fn(*args, **kwargs)

    return entry


@contextlib.contextmanager
def spans():
    """Solves that open inside record their spans (`last_solve`), with no
    profiler session."""
    global _FORCED
    _FORCED += 1
    try:
        yield
    finally:
        _FORCED -= 1


def last_solve() -> Optional[list]:
    """The last finished recorded solve's span records, each a dict:
    ``name``, ``id``, ``parent``, ``solve``, ``start_ns``, ``end_ns`` (Unix
    ns), ``host_ms``, ``attrs`` (the root's ``counters``: the deltas over
    the solve) and ``device_ms``, the device extent (None off the card or
    inside a graph capture). Reading them the first time waits for the
    card. None before any recorded solve."""
    rec = _LAST
    if rec is None:
        return None
    if not rec.resolved:
        if rec.cuda:
            rec.stream.synchronize()
        for d in rec.records:
            evs = d.pop("_events", None)
            d["device_ms"] = evs[0].elapsed_time(evs[1]) if evs is not None else None
            d["host_ms"] = (d["end_ns"] - d["start_ns"]) * 1e-6
        rec.resolved = True
    return [dict(d) for d in rec.records]


def span_table(records: list) -> dict:
    """Per span name: ``count``, ``host_ms`` (total), ``host_self_ms``
    (less its children's), ``device_ms`` and ``device_self_ms`` (the
    same of the device extents; None where a span of the name has none).
    The host self times add up to the roots' host time."""
    children = defaultdict(list)
    for d in records:
        children[d["parent"]].append(d)
    table = {}
    for d in records:
        host = d["end_ns"] - d["start_ns"]
        host_self = host - sum(c["end_ns"] - c["start_ns"] for c in children[d["id"]])
        dev = d.get("device_ms")
        dev_self = None
        if dev is not None:
            kids = [c.get("device_ms") for c in children[d["id"]]]
            dev_self = dev - sum(k for k in kids if k is not None)
        row = table.setdefault(d["name"], {"count": 0, "host_ms": 0.0, "host_self_ms": 0.0,
                                           "device_ms": 0.0, "device_self_ms": 0.0})
        row["count"] += 1
        row["host_ms"] += host * 1e-6
        row["host_self_ms"] += host_self * 1e-6
        if dev is None or row["device_ms"] is None:
            row["device_ms"] = row["device_self_ms"] = None
        else:
            row["device_ms"] += dev
            row["device_self_ms"] += dev_self
    return table


@contextlib.contextmanager
def trace(log_dir: str):
    """`torch.profiler` trace of the enclosed code (the card's activity
    too, when CUDA is available), written to ``log_dir`` as a Chrome trace
    for TensorBoard or Perfetto; the spans of solves inside are ranges on
    it, and the last one's records go to ``log_dir/spans.jsonl``, a record
    a line, when it closes."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    before = _LAST
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ) as prof:
        yield prof
    if _LAST is not None and _LAST is not before:
        with open(os.path.join(log_dir, "spans.jsonl"), "w") as f:
            for d in last_solve():
                f.write(json.dumps(d) + "\n")
