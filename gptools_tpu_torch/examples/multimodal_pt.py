"""Parallel tempering on a multimodal hyperparameter posterior.

The flagship Gibbs-tanh pedestal fit (config 4) has a multimodal
hyperposterior: the edge length scale trades off against the warp
transition location. Prior-initialized single-temperature chains get stuck
in one mode each and split R-hat grows; this example runs the two
gradient-based fixes the package has:

  1. replica-exchange HMC (``sampler='pt'``, the temperature ladder an
     axis of the batched density, `gptools_tpu_torch.infer.pt`), and
  2. the SMC warm-started pipeline (``sampler='smc+chees'``).

    python -m gptools_tpu_torch.examples.multimodal_pt          # on the card
    python -m gptools_tpu_torch.examples.multimodal_pt --cpu    # on the CPU

Counterpart of the JAX package's ``examples/multimodal_pt.py``, on config
4's model and data (`configs.config4_gibbs_smc`, the model the reference
takes from its bench). Each run starts from a generator seeded with 0, as
the reference reuses ``PRNGKey(0)``.
"""

import argparse
import time

import numpy as np


def main(argv=None):
    """Run the three samplers; returns ``{"nuts", "pt", "smc+chees"}`` of
    `SampleResult`."""
    ap = argparse.ArgumentParser(prog="python -m gptools_tpu_torch.examples.multimodal_pt")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--chains", type=int, default=16)
    ap.add_argument("--samples", type=int, default=400)
    ap.add_argument("--warmup", type=int, default=300)
    args = ap.parse_args(argv)

    import torch

    from gptools_tpu_torch import configs
    from gptools_tpu_torch.infer import run_sampler
    from gptools_tpu_torch.utils.diagnostics import split_rhat

    prob = configs.config4_gibbs_smc(device="cpu" if args.cpu else "cuda")
    model, data = prob.model, prob.data
    names = model.param_names

    def key():
        return torch.Generator(device=data.device).manual_seed(0)

    def report(tag, res, wall):
        rhat = split_rhat(res.thetas).cpu().numpy()
        th = res.thetas.reshape(-1, len(names)).cpu().numpy()
        print(f"\n== {tag} ({wall:.1f}s) ==")
        print(f"  max split R-hat: {rhat.max():.3f}")
        for i, n in enumerate(names):
            print(
                f"  {n:>8s}: mean {th[:, i].mean():8.4f}  "
                f"sd {th[:, i].std():7.4f}  R-hat {rhat[i]:.3f}"
            )

    # 1) prior-initialized single-temperature NUTS: chains split across modes
    t0 = time.time()
    res_nuts = run_sampler(
        model, data, key(), sampler="nuts",
        num_chains=args.chains, num_samples=args.samples,
        num_warmup=args.warmup,
    )
    report(
        "prior-init NUTS (mode-split chains show up as R-hat >> 1 at scale)",
        res_nuts,
        time.time() - t0,
    )

    # 2) parallel tempering: hot rungs cross the barrier, swaps ferry it down
    t0 = time.time()
    res_pt = run_sampler(
        model, data, key(), sampler="pt",
        num_chains=args.chains, num_samples=args.samples,
        num_warmup=args.warmup, num_temps=6, beta_min=0.05,
    )
    report("parallel tempering (6 rungs)", res_pt, time.time() - t0)
    sw = res_pt.diagnostics["swap_accept"].cpu().numpy()
    print(f"  swap acceptance along ladder: {np.round(sw, 2)}")

    # 3) the pipeline: tempered SMC warm start + whitened ChEES-HMC
    t0 = time.time()
    res_pipe = run_sampler(
        model, data, key(), sampler="smc+chees",
        num_chains=args.chains, num_samples=args.samples,
        num_warmup=min(args.warmup, 100),
    )
    report("SMC -> whitened ChEES (pipeline)", res_pipe, time.time() - t0)
    return {"nuts": res_nuts, "pt": res_pt, "smc+chees": res_pipe}


if __name__ == "__main__":
    main()
