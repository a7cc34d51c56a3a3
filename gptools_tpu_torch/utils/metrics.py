"""Streaming inference metrics and a profiler trace.

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
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import numpy as np
import torch

__all__ = ["MetricsLogger", "trace"]


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


@contextlib.contextmanager
def trace(log_dir: str):
    """`torch.profiler` trace of the enclosed code (the card's activity
    too, when CUDA is available), written to ``log_dir`` as a Chrome trace
    for TensorBoard or Perfetto."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ) as prof:
        yield prof
