"""Whether a run's solves are right: the program's outputs against the
plain reference, after the timed window.

Readings (each a largest gap, so larger is worse):

- ``theta_gap``: every draw's theta against the reference's bijection of
  the same u, largest relative gap;
- ``logp_gap``: the program's log posterior at a sample of draws (drawn
  from the seed) against the reference's at the same u, largest gap over
  max(1, |reference|);
- ``ll_gap`` and ``grad_gap``: the last density call of each solve (the
  last leapfrog's endpoints, all chains; a sample drawn from the seed):
  its evidence against the reference's, largest gap over max(1,
  |reference|), and its gradient d(log prior + evidence)/dtheta against
  the reference's, largest per-chain norm of the difference over the norm
  of the reference's;
- ``mean_z``: the window's pooled posterior mean of theta (each distinct
  solve once) against the reference posterior (`reference/posteriors/<config>.json`), largest
  |z| over the parameters, with the standard error of the chains' means
  (the chains are independent) and the reference's own.

A reading that is not finite fails.
"""

from __future__ import annotations

import math

import torch

from benchmark.lib.seeds import stream_seed
from benchmark.reference.gp import blocks


def _rel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs() / b.abs().clamp(min=1.0)


def _max(x: torch.Tensor) -> float:
    """Largest entry; inf where any entry is not finite."""
    x = x.detach()
    if x.numel() == 0:
        return math.inf
    if not bool(torch.isfinite(x).all()):
        return math.inf
    return float(x.max())


@torch.no_grad()
def readings(ref, solves, posterior: dict, seed: int, sample: int) -> dict:
    out = {}
    f64 = torch.float64
    gaps = []
    for s in solves:
        for u, th in zip(s.u.split(4096), s.thetas.split(4096)):
            th_ref = ref.theta_of_u(u.to(f64))
            gaps.append(((th.to(f64) - th_ref).abs() / th_ref.abs().clamp(min=1e-300)).amax())
    out["theta_gap"] = _max(torch.stack(gaps))

    lp_gaps, ll_gaps, g_gaps = [], [], []
    for k, s in enumerate(solves):
        C, S, _ = s.u.shape
        gen = torch.Generator(device=s.u.device).manual_seed(stream_seed(seed, 7, k))
        ci = torch.randint(0, C, (sample,), generator=gen, device=s.u.device)
        si = torch.randint(0, S, (sample,), generator=gen, device=s.u.device)
        lp_ref = blocks(ref.log_posterior_u, s.u[ci, si].to(f64))
        lp_gaps.append(_rel(s.log_prob[ci, si].to(f64), lp_ref))
        if s.last is None or "grad" not in s.last:
            ll_gaps.append(torch.full((1,), math.inf, dtype=f64))
            g_gaps.append(torch.full((1,), math.inf, dtype=f64))
            continue
        th = s.last["theta"]
        rows = torch.randint(0, th.shape[0], (sample,), generator=gen, device=th.device)
        ll_ref, g_ref = [], []
        for b in th[rows].to(f64).split(4096):
            ll_b, g_b = ref.ll_and_grad(b)
            ll_ref.append(ll_b)
            g_ref.append(g_b)
        ll_ref, g_ref = torch.cat(ll_ref), torch.cat(g_ref)
        fin = torch.isfinite(ll_ref)
        ll_gaps.append(_rel(s.last["ll"][rows].to(f64)[fin], ll_ref[fin]))
        g = s.last["grad"][rows].to(f64)[fin]
        g_gaps.append((g - g_ref[fin]).norm(dim=1) / g_ref[fin].norm(dim=1))
    out["logp_gap"] = _max(torch.cat(lp_gaps))
    out["ll_gap"] = _max(torch.cat(ll_gaps))
    out["grad_gap"] = _max(torch.cat(g_gaps))

    # a window that cycles through its pool repeats solves; each counts once
    distinct = list({s.seed: s for s in solves}.values())
    chain_means = torch.cat([s.thetas.to(f64).mean(1) for s in distinct])  # (sum C, P)
    m = chain_means.mean(0)
    se = chain_means.std(0, correction=1) / math.sqrt(chain_means.shape[0])
    ref_mean = torch.tensor(posterior["mean"], dtype=f64, device=m.device)
    ref_se = torch.tensor(posterior["se"], dtype=f64, device=m.device)
    out["mean_z"] = _max(((m - ref_mean) / torch.sqrt(se * se + ref_se * ref_se)).abs())
    return out
