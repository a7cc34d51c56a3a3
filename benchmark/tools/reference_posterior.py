"""The reference posterior of a configuration, by importance sampling with
the plain reference alone (the program is not imported).

A multivariate Student-t proposal in the unconstrained space, started from
the configuration's ``pilot_mean`` / ``pilot_std`` (posterior moments of
theta from the reference gptools_tpu, float64) and adapted over a few
stages to the weighted draws' mean and covariance; then ``--draws`` draws
give theta's posterior mean, its standard error (delta method on the
self-normalized estimate), the std and the importance-sampling ESS.

    python3 benchmark/tools/reference_posterior.py --config config4_gibbs_tanh \\
        --draws 16000000 --out config4_gibbs_tanh.json

Runs on the card when there is one. The result is the file
``benchmark/reference/posteriors/<config>.json`` that the check reads.
"""

import argparse
import importlib
import json
import math
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NU = 7.0
BLOCK = 16384


def _u_of_theta(cfg, theta):
    cols, dcols = [], []
    for i, (kind, a, b) in enumerate(cfg["priors"]):
        t = theta[i]
        if kind == "lognormal":
            u = t + math.log(-math.expm1(-t))
            cols.append(u)
            dcols.append(1.0 / (1.0 + math.exp(-u)))
        elif kind == "uniform":
            p = (t - a) / (b - a)
            cols.append(math.log(p) - math.log1p(-p))
            dcols.append((b - a) * p * (1.0 - p))
        else:
            cols.append(t)
            dcols.append(1.0)
    return cols, dcols


def _t_draws(gen, n, mean, chol):
    P = mean.shape[0]
    z = torch.randn((n, P), generator=gen, dtype=torch.float64, device=mean.device)
    g = torch._standard_gamma(torch.full((n,), NU / 2.0, dtype=torch.float64,
                                         device=mean.device), generator=gen) * (2.0 / NU)
    x = mean + (z @ chol.T) / torch.sqrt(g)[:, None]
    # log density of the multivariate t, up to a constant
    r = torch.linalg.solve_triangular(chol, (x - mean).T, upper=False).T
    logq = -0.5 * (NU + P) * torch.log1p((r * r).sum(1) / NU)
    return x, logq


def _stage(ref, gen, n, mean, chol):
    logw, thetas = [], []
    left = n
    while left > 0:
        b = min(BLOCK, left)
        u, logq = _t_draws(gen, b, mean, chol)
        with torch.no_grad():
            lp = ref.log_posterior_u(u)
        logw.append(lp - logq)
        thetas.append(torch.cat([u, ref.theta_of_u(u)], 1))
        left -= b
    logw = torch.cat(logw)
    logw = torch.where(torch.isfinite(logw), logw, -math.inf)
    w = torch.exp(logw - logw.max())
    return w, torch.cat(thetas)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--draws", type=int, default=16_000_000)
    p.add_argument("--stages", type=int, nargs="+", default=[200_000, 1_000_000, 2_000_000])
    p.add_argument("--seed", type=int, default=20261018)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    with open(os.path.join(ROOT, "benchmark", "configs", args.config + ".json")) as f:
        cfg = json.load(f)
    mod = importlib.import_module(f"benchmark.configs.{args.config}")
    ref = mod.reference(cfg, mod.make_data(cfg), dev)
    P = len(cfg["priors"])
    um, du = _u_of_theta(cfg, cfg["pilot_mean"])
    mean = torch.tensor(um, dtype=torch.float64, device=dev)
    sd = torch.tensor([s / d for s, d in zip(cfg["pilot_std"], du)], dtype=torch.float64,
                      device=dev)
    chol = torch.diag(2.0 * sd)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.perf_counter()
    history = []
    for n in args.stages:
        w, x = _stage(ref, gen, n, mean, chol)
        u = x[:, :P]
        wn = w / w.sum()
        mean = (wn[:, None] * u).sum(0)
        d = u - mean
        cov = (wn[:, None] * d).T @ d
        chol = torch.linalg.cholesky(1.44 * cov)
        history.append({"draws": n, "is_ess": float(w.sum() ** 2 / (w * w).sum())})
    w, x = _stage(ref, gen, args.draws, mean, chol)
    th = x[:, P:]
    W = w.sum()
    m = (w[:, None] * th).sum(0) / W
    d = th - m
    se = torch.sqrt(((w * w)[:, None] * d * d).sum(0)) / W
    std = torch.sqrt((w[:, None] * d * d).sum(0) / W)
    out = {
        "config": args.config,
        "params": cfg["param_names"],
        "mean": m.tolist(),
        "se": se.tolist(),
        "std": std.tolist(),
        "draws": args.draws,
        "is_ess": float(W * W / (w * w).sum()),
        "max_weight_share": float(w.max() / W),
        "stages": history,
        "proposal": f"multivariate t, nu {NU}, in u; seed {args.seed}",
        "device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
        "seconds": time.perf_counter() - t0,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
