#!/usr/bin/env python3
"""Is a config's float32 posterior shift the float32 jitter, or rounding?

The evidence adds a relative jitter ``diag_factor * eps * max(mean diag,
1)`` to the covariance diagonal, with eps the dtype's machine epsilon, so
float32 adds ~5e8 times more than float64. This script runs a config
through `smc_then_chees` on the card at `chip_smoke.py`'s shape three ways
and holds each posterior to the config's float64 golden by the rule of
`scripts/f32_parity.py`:

- float32 (the main path's model);
- float64 with the float32 jitter (``diag_factor = 100 * eps32 / eps64``);
- float64 (the golden's model).

If the second run reproduces the first's shift, the jitter explains it.

    python scripts/torch_f32_shift.py --configs 3 2

Prints the card line and one JSON object per run. Needs a CUDA device.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

F32_JITTER_DF = 100 * 2.0**-23 / 2.0**-52


def run(config, dtype, diag_factor, seed, dev):
    import torch

    import chip_smoke
    from gptools_tpu_torch import configs
    from gptools_tpu_torch.infer.pipeline import smc_then_chees
    from gptools_tpu_torch.models.gp import GPModel
    from gptools_tpu_torch.utils.diagnostics import ess_and_rhat

    prob = configs.ALL_CONFIGS[config](dtype=dtype, device=dev)
    m = prob.model
    model = GPModel(m.kernel, noise_kernel=m.noise_kernel, mean=m.mean,
                    diag_factor=diag_factor)
    chains, warmup, samples, _ = chip_smoke.PATHS[config]
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    res = smc_then_chees(model, prob.data, gen, num_chains=chains, num_warmup=warmup,
                         num_samples=samples, num_particles=1024, max_steps=256)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ess, rhat = ess_and_rhat(res.thetas)
    z, std_rel, ok = chip_smoke.golden_rule(config, res.thetas, ess)
    return {
        "config": config, "dtype": str(dtype).replace("torch.", ""),
        "diag_factor": diag_factor, "seed": seed, "chains": chains,
        "warmup": warmup, "samples": samples, "wall_s": wall,
        "max_rhat": float(rhat.max()), "z": [float(v) for v in z],
        "std_rel_err": [float(v) for v in std_rel], "golden_rule_ok": ok,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", type=int, nargs="*", default=[3])
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("torch_f32_shift: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(chip_smoke.card_line())
    for c in args.configs:
        for dtype, df in ((torch.float32, 1e2), (torch.float64, F32_JITTER_DF),
                          (torch.float64, 1e2)):
            print(json.dumps(run(c, dtype, df, args.seed, dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
