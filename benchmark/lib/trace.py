"""One solve under ``torch.profiler``, reduced to what the per-layer
metrics read: the device's intervals, the evidence kernel's launches, the
solve's span, and where the device sat idle.

The profiler's own events are read (``kineto_results.events()``), not its
``FunctionEvent`` tables, which take minutes to build at a solve's millions
of events. A profiler session slows every later host launch of its
process, so a run profiles only after its unprofiled window.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, NamedTuple

import numpy as np
import torch

SPAN = "benchmark.solve"
EVIDENCE_KERNEL = "evidence_kernel"
TOP = 10


class Trace(NamedTuple):
    events: int              # events the profiler held
    span_s: float            # the solve's wall on the profiler's clock
    busy_s: float            # union of device intervals inside the span
    device_s: float          # sum of device op durations
    evidence_s: list         # each evidence-kernel launch's duration, in order
    device_ops: list         # [[name, seconds]], most time first
    idle_gaps: list          # [[host op, seconds]], most idle time first
    calls: int               # density calls during the solve
    widths: list             # rows of each density call, in order
    wall_s: float            # host wall of the solve, profiler on


def _union(starts: np.ndarray, ends: np.ndarray):
    """Merged [start, end) intervals, sorted."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(s.shape[0], dtype=bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    last = np.append(idx[1:] - 1, s.shape[0] - 1)
    return s[idx], run_end[last]


def _innermost(host, tids_main, points):
    """For each time in ``points`` (sorted), the name of the innermost host
    op of the main thread running then, or "(no host op)"."""
    hs = sorted((h for h in host if h[3] == tids_main), key=lambda h: (h[0], -h[1]))
    out, stack, i = [], [], 0
    for t in points:
        while i < len(hs) and hs[i][0] <= t:
            while stack and stack[-1][1] <= hs[i][0]:
                stack.pop()
            stack.append(hs[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else "(no host op)")
    return out


def profile_solve(fn: Callable[[], None], probe) -> Trace:
    """Run ``fn`` (one solve that ends in a device sync) under the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    probe.widths = []
    calls0 = probe.calls
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function(SPAN):
            fn()
        wall = time.perf_counter() - t0
    widths, probe.widths = probe.widths, None
    calls = probe.calls - calls0

    evs = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    dev_s, dev_e, dev_n, host = [], [], [], []
    span = None
    for e in evs:
        start = e.start_ns()
        end = start + e.duration_ns()
        name = e.name()
        if name == SPAN or e.is_user_annotation():
            # the solve's own range, on the host and mirrored on the device
            if name == SPAN and e.device_type() != cuda:
                span = (start, end, e.start_thread_id())
        elif e.device_type() == cuda:
            dev_s.append(start)
            dev_e.append(end)
            dev_n.append(name)
        else:
            host.append((start, end, name, e.start_thread_id()))
    if span is None or not dev_s:
        raise RuntimeError("the profiler recorded no solve span or no device op")
    s0, s1, main_tid = span
    starts = np.clip(np.asarray(dev_s, dtype=np.int64), s0, s1)
    ends = np.clip(np.asarray(dev_e, dtype=np.int64), s0, s1)
    us, ue = _union(starts, ends)
    busy_ns = int((ue - us).sum())

    per_name = defaultdict(int)
    evidence = []
    for name, a, b in zip(dev_n, dev_s, dev_e):
        per_name[name] += b - a
        if EVIDENCE_KERNEL in name:
            evidence.append((a, (b - a) * 1e-9))
    evidence.sort()
    device_ns = sum(per_name.values())
    top_ops = sorted(per_name.items(), key=lambda kv: -kv[1])[:TOP]

    gap_s = np.concatenate([[s0], ue])
    gap_e = np.concatenate([us, [s1]])
    keep = gap_e > gap_s
    gap_s, gap_e = gap_s[keep], gap_e[keep]
    mids = (gap_s + (gap_e - gap_s) // 2).tolist()
    owners = _innermost(host, main_tid, mids)
    per_owner = defaultdict(int)
    for who, a, b in zip(owners, gap_s.tolist(), gap_e.tolist()):
        per_owner[who] += b - a
    top_gaps = sorted(per_owner.items(), key=lambda kv: -kv[1])[:TOP]

    return Trace(
        events=len(evs),
        span_s=(s1 - s0) * 1e-9,
        busy_s=busy_ns * 1e-9,
        device_s=device_ns * 1e-9,
        evidence_s=[d for _, d in evidence],
        device_ops=[[n, v * 1e-9] for n, v in top_ops],
        idle_gaps=[[n, v * 1e-9] for n, v in top_gaps],
        calls=calls,
        widths=widths,
        wall_s=wall,
    )
