#!/usr/bin/env python3
"""Time and memory of the batch evidence's chains-minor route on the card.

    python scripts/bench_torch_route.py [--root DIR] [--label NAME]

For each shape below, one call of ``GPModel.log_marginal_batch`` with its
theta gradient (as a sampler asks for them) in float64 on ``cuda:0``:
its ms per call (median of `REPS` calls, CUDA events, after the warm-up
calls) and the peak device memory one call allocates above what
was allocated before it (``torch.cuda.max_memory_allocated``), and the
largest difference of its values and gradients from two calls on the
halves of its thetas (0 when a chain's numbers do not depend on the
batch's width, as a sharded run needs, `parallel.mesh`). Prints the
card's name and power limit, then one ``ROUTE_BENCH {json}`` line per
shape.

``--root`` imports ``gptools_tpu_torch`` from another checkout (default:
this one), so two commits compare on one card in one command: run this
script with the parent's root and this one's, in the order parent,
change, change, parent.

Shapes (all take the chains-minor route, `evidence_cuda.ROUTE_CALLS`):
config 4 at 60 points (N = 62, Gibbs-tanh) at 256 thetas; config 5
(M = 32, Q = 47, Gibbs-tanh, a transformed observation) at 1024; config 1
at 64 points (N = 64, SE) and config 2 at 62 points (N = 64, SE with
slope observations) at 1024.
"""

import argparse
import json
import os
import subprocess
import sys

SHAPES = (
    ("config4_gibbs_smc", dict(n_points=60), 256),
    ("config5_multihost_profile", {}, 1024),
    ("config1_se_map", dict(n_points=64), 1024),
    ("config2_se_deriv_nuts", dict(n_points=62), 1024),
)
REPS = 20


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default=None)
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.root))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_torch_route: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from gptools_tpu_torch import configs
    from gptools_tpu_torch.ops import evidence_cuda as ec

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    for name, kw, chains in SHAPES:
        prob = getattr(configs, name)(dtype=torch.float64, device=dev, **kw)
        model, data = prob.model, prob.data
        gen = torch.Generator(device=dev).manual_seed(chains)
        u = 0.4 * torch.randn(chains, model.num_free_params, generator=gen, device=dev,
                              dtype=torch.float64)
        thetas = model.theta_of_u(u).detach()

        def call(th=thetas):
            t = th.clone().requires_grad_(True)
            ll = model.log_marginal_batch(t, data)
            (g,) = torch.autograd.grad(ll.sum(), t)
            return ll.detach(), g

        ec.reset_counts()
        ll, g = call()
        routes = dict(ec.ROUTE_CALLS)
        if routes["chains_minor"] != 1 or sum(ec.LAUNCHES.values()):
            raise SystemExit(f"bench_torch_route: {name} did not take the chains-minor route")
        if not (bool(torch.isfinite(ll).all()) and bool(torch.isfinite(g).all())):
            raise SystemExit(f"bench_torch_route: {name} gave non-finite values")
        # each chain's value and gradient at half the width: 0 when a chain's
        # numbers do not depend on how many chains share the call
        halves = [call(h) for h in thetas.chunk(2)]
        width_diff = max(float((torch.cat([h[i] for h in halves]) - v).abs().max())
                         for i, v in enumerate((ll, g)))
        call()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        times.sort()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        call()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        print("ROUTE_BENCH " + json.dumps(dict(
            label=a.label or a.root, shape=name, n=data.num_latent, chains=chains,
            ms=times[len(times) // 2], ms_min=times[0], peak_mib=peak / 2**20,
            half_width_max_abs_diff=width_diff, card=card,
        )), flush=True)


if __name__ == "__main__":
    main()
