"""The generator of posterior solves: whole calls of one of the program's
pipelines (``gptools_tpu_torch.infer.pipeline``), back to back.

A mix that it reads (``traffic/<name>.json``) gives the pipeline's public
name, the dtype, the pipeline's keyword settings, the warm-up solve's
transitions, and the pool of solves: ``solve_pool`` seeds the stream of
solve seeds, ``pool_solves`` is how many of them the window cycles through,
and ``min_solves`` the fewest a window holds. The configuration gives the
chains, the warm-up and the samples.

A solve's seed decides its work (the samplers adapt their trajectories),
so every run draws its solves from the same pool: each cycle through the
pool in an order drawn from the run's seed. The window closes at the end of
the solve that is running when ``seconds`` have passed, once it holds
``min_solves``; the rates divide by its true length.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from benchmark.generators import Window
from benchmark.lib.seeds import stream_seed

DTYPES = {"float64": torch.float64, "float32": torch.float32}
# mix keys that are the generator's own, not the pipeline's
_OWN = ("generator", "pipeline", "dtype", "warmup_transitions", "solve_pool", "pool_solves",
        "min_solves")
# quality gates of one solve (bench.py:40-41)
RHAT_GATE = 1.1
DIVERGENCE_GATE = 1e-3


class Solve(NamedTuple):
    """What one solve produced, as the program returned it."""

    u: torch.Tensor          # (C, S, P) draws in the unconstrained space
    thetas: torch.Tensor     # (C, S, P) the same draws through the bijector
    log_prob: torch.Tensor   # (C, S) the program's log posterior at each draw
    divergences: int
    last: Optional[dict]     # the last density call: theta, ll, grad
    wall_s: float
    calls: int               # density calls of the solve
    info: dict               # every scalar of the pipeline's diagnostics
    seed: int                # the solve's seed


class EvidenceProbe:
    """Counts the rows (chain-evaluations) and calls that reach
    ``GPModel.log_marginal_batch`` on one model instance, whatever route
    or kernel is behind it, and keeps the last differentiated call's
    theta, evidence and gradient d(log prior + evidence)/dtheta. Installed
    as an attribute of that instance; it adds no device work and no sync."""

    def __init__(self, model):
        self._inner = model.log_marginal_batch
        self.rows = 0
        self.calls = 0
        self.widths: Optional[list] = None
        self.last: Optional[dict] = None
        model.log_marginal_batch = self

    def __call__(self, thetas, data, *args, **kwargs):
        out = self._inner(thetas, data, *args, **kwargs)
        self.rows += thetas.shape[0]
        self.calls += 1
        if self.widths is not None:
            self.widths.append(thetas.shape[0])
        if thetas.requires_grad:
            rec = {"theta": thetas.detach(), "ll": out.detach()}
            thetas.register_hook(lambda g: rec.__setitem__("grad", g.detach()))
            self.last = rec
        return out


def _scalars(diagnostics: dict) -> dict:
    """Every one-element entry of a pipeline's diagnostics, as a number."""
    out = {}
    for k, v in diagnostics.items():
        if isinstance(v, torch.Tensor) and v.numel() == 1:
            v = v.item()
        if isinstance(v, (bool, int, float)):
            out[k] = v
    return out


def _density_calls() -> int:
    """The program's counters of batched density calls, by every path."""
    from gptools_tpu_torch.ops import evidence_cuda

    return (sum(evidence_cuda.LAUNCHES.values()) + sum(evidence_cuda.PLAIN_CALLS.values())
            + sum(evidence_cuda.ROUTE_CALLS.values()))


class Session:
    """One configuration under one mix: set-up on construction."""

    def __init__(self, spec: dict, cfg: dict, cfg_mod, config_name: str, device: str,
                 seed: int, program_hook=None):
        import gptools_tpu_torch.infer.pipeline as pipelines
        from gptools_tpu_torch.ops import evidence_cuda

        self.spec, self.cfg, self.cfg_mod, self.config_name = spec, cfg, cfg_mod, config_name
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.pipeline = getattr(pipelines, spec["pipeline"])
        self.dtype_name = spec["dtype"]
        self.dtype = DTYPES[self.dtype_name]
        self.kwargs = {k: v for k, v in spec.items() if k not in _OWN}
        self.kwargs["num_chains"] = int(cfg["num_chains"])
        self.num_warmup = int(cfg["num_warmup"])
        self.num_samples = int(cfg["num_samples"])
        self.pool = [stream_seed(spec["solve_pool"], k) for k in range(int(spec["pool_solves"]))]

        self.info = {"build_s": None}
        if self.on_card:
            tb = time.perf_counter()
            evidence_cuda.build()
            self.info["build_s"] = time.perf_counter() - tb
        self.arrays = cfg_mod.make_data(cfg)
        self.model, self.data = cfg_mod.program(cfg, self.arrays, self.dtype, self.device)
        if program_hook is not None:
            program_hook(self.model, self.data)
        self.probe = EvidenceProbe(self.model)

        tw = time.perf_counter()
        warm = self._solve(stream_seed(seed, 1), tuple(spec.get("warmup_transitions", (2, 2))))
        del warm
        self.info["warmup_s"] = time.perf_counter() - tw
        if self.on_card:
            # a solve keeps each sampling step's positions until it stacks
            # them (the first window solve would grow the allocator's pool by
            # hundreds of blocks); grow it here once, to twice their size
            item = torch.empty((), dtype=self.dtype).element_size()
            torch.empty(2 * self.num_samples * self.kwargs["num_chains"]
                        * self.model.num_free_params * item, dtype=torch.uint8,
                        device=self.device)

    def _solve(self, seed: int, transitions: Optional[tuple] = None) -> Solve:
        """One whole solve on a generator seeded with ``seed``; it ends when
        the device has finished. ``transitions``: (warm-up, samples), else
        the configuration's."""
        warm, samples = transitions or (self.num_warmup, self.num_samples)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        probe = self.probe
        probe.last = None
        calls0 = probe.calls
        t0 = time.perf_counter()
        res = self.pipeline(self.model, self.data, gen, num_warmup=warm, num_samples=samples,
                            **self.kwargs)
        if self.on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return Solve(res.u, res.thetas, res.log_prob, int(res.diagnostics["divergences"]),
                     probe.last, wall, probe.calls - calls0, _scalars(res.diagnostics), seed)

    def _order(self, seed: int):
        """The run's solve seeds: cycles through the pool, each in an order
        drawn from the run's seed."""
        rng = np.random.default_rng(stream_seed(seed, 2))
        while True:
            for k in rng.permutation(len(self.pool)):
                yield self.pool[k]

    def window(self, seconds: float, seed: int) -> Window:
        order = self._order(seed)
        records = []
        calls0, rows0 = _density_calls(), self.probe.rows
        start = time.perf_counter()
        while (time.perf_counter() - start < seconds
               or len(records) < int(self.spec["min_solves"])):
            records.append(self._solve(next(order)))
        window_s = time.perf_counter() - start
        counters = {"calls": _density_calls() - calls0, "rows": self.probe.rows - rows0}
        return Window(records, window_s, counters, [s.wall_s for s in records])

    def profile(self, seed: int):
        """The window's first solve again, under the profiler."""
        from benchmark.lib.trace import profile_solve

        first = next(self._order(seed))
        return profile_solve(lambda: self._solve(first), self.probe)

    def release(self) -> None:
        del self.model, self.data, self.probe
        if self.on_card:
            torch.cuda.empty_cache()

    def stats(self, records: list) -> list:
        """Each solve's diagnostics, its least ESS and largest split R-hat
        over theta's parameters (the frozen float64 copy), and whether it
        passes the quality gates."""
        from benchmark.lib import diagnostics

        out = []
        for s in records:
            C, S, _ = s.thetas.shape
            min_ess = float(diagnostics.ess_per_param(s.thetas).min())
            max_rhat = float(diagnostics.split_rhat(s.thetas).max())
            ok = (np.isfinite(min_ess) and np.isfinite(max_rhat) and max_rhat <= RHAT_GATE
                  and s.divergences <= DIVERGENCE_GATE * C * S)
            out.append({"wall_s": s.wall_s, "calls": s.calls, **s.info, "min_ess": min_ess,
                        "max_rhat": max_rhat, "passed": bool(ok)})
        return out

    def readings(self, records: list, seed: int, cell: dict) -> dict:
        """The program's draws, log posterior, evidence and gradient against
        the plain reference (`benchmark.lib.check`)."""
        import json
        import os

        from benchmark.lib import check

        here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        with open(os.path.join(here, "reference", "posteriors", self.config_name + ".json")) as f:
            posterior = json.load(f)
        ref = self.cfg_mod.reference(self.cfg, self.arrays, self.device)
        return check.readings(ref, records, posterior, seed, int(cell["sample"]))
