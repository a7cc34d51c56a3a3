"""One solve of each cell at its chain count and at half of it, with the
profiled solve: wall, density calls and the device's busy share.

    python3 benchmark/tools/sweep.py --seed 11 cfg4.chees.f64 cfg3.chees.f64

One process, one line of JSON a run; needs a CUDA device.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("workloads", nargs="+")
    p.add_argument("--seed", type=int, default=11)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import run

    run._set_caches()
    torch.set_num_threads(1)
    bench = run._load_json(ROOT, "BENCHMARK.json")
    cfg_of = {w["name"]: w["config"] for w in bench["workloads"]}
    for wl in args.workloads:
        cfg = run._load_json(ROOT, "benchmark", "configs", cfg_of[wl] + ".json")
        for chains in (cfg["num_chains"], cfg["num_chains"] // 2):
            t0 = time.perf_counter()
            res = run.run_cell(wl, args.seed, 0.0, True, overrides={
                "config": {"num_chains": chains},
                "traffic": {"pool_solves": 1, "min_solves": 1}}, t0=t0)
            d = res["device"]
            print(json.dumps({
                "workload": wl, "chains": chains, "setup_s": time.perf_counter() - t0,
                "correct": res["correct"], "busy_share": d["busy_s"] / d["window_s"],
                "memory_peak_bytes": d["memory_peak_bytes"], "metrics": res["metrics"],
                "breakdown": res["breakdown"], "checks": res["checks"],
                "card": res["card"]}), flush=True)
            torch.cuda.reset_peak_memory_stats()


if __name__ == "__main__":
    main()
