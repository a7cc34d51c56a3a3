"""Float64 golden posteriors of configs 2 and 3 (CPU, x64).

The rule of `scripts/f32_parity.py`, extended to the SE-with-slopes model
(config 2) and the warped Matern-5/2 model with a linear mean (config 3):
each config runs through `smc_then_chees` on the CPU in float64 at the
shape of `tests/golden_config4.json`, and its posterior moments, ESS and
split R-hat are written next to it:

    python scripts/golden_configs.py            # writes both goldens
    python scripts/golden_configs.py --configs 3

Writes `tests/golden_config{2,3}.json` with the keys of
`tests/golden_config4.json`. Imports only the JAX package.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

RUN_KWARGS = dict(num_chains=512, num_warmup=75, num_samples=300, num_particles=1024)
SEED = 7


def golden(config: int) -> dict:
    import jax

    from gptools_tpu import configs
    from gptools_tpu.infer.pipeline import smc_then_chees
    from gptools_tpu.utils.diagnostics import ess_per_param, split_rhat

    prob = configs.ALL_CONFIGS[config]()
    res = smc_then_chees(
        prob.model, prob.data, jax.random.PRNGKey(SEED), **RUN_KWARGS
    )
    th = np.asarray(res.thetas)
    flat = th.reshape(-1, th.shape[-1])
    return {
        "params": list(prob.model.param_names),
        "mean": flat.mean(axis=0).tolist(),
        "std": flat.std(axis=0, ddof=1).tolist(),
        "ess": np.asarray(ess_per_param(th)).tolist(),
        "rhat": np.asarray(split_rhat(th)).tolist(),
        "dtype": str(th.dtype),
        "kwargs": RUN_KWARGS,
        "seed": SEED,
        "device": str(jax.devices()[0]),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", type=int, nargs="*", default=[2, 3])
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    for c in args.configs:
        t0 = time.perf_counter()
        out = golden(c)
        if out["dtype"] != "float64":
            raise SystemExit(f"config {c}: golden ran in {out['dtype']}")
        path = os.path.join(ROOT, "tests", f"golden_config{c}.json")
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        print(json.dumps({"golden_written": path, "seconds": time.perf_counter() - t0,
                          **{k: out[k] for k in ("mean", "std", "ess", "rhat")}}),
              flush=True)


if __name__ == "__main__":
    main()
