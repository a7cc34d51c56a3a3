"""The check's readings over many seeds, in one process: the program as the
configuration states it (the lower readings) and its control, the program
with its float32 path switched on (the upper readings), each run a window
of one solve at the cell's own size, judged as a run judges it.

    python3 benchmark/tools/readings.py cfg4.chees.f64 --seeds 101 102 ... \\
        --control-seeds 201 202 203

Prints one JSON line a run; needs a CUDA device. The runs set no limit by
themselves: the cell's limits in ``cells/<workload>.json`` are set from
these readings, as PERF.md records.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("workload")
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-dtype", default="float32")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import run

    run._set_caches()
    torch.set_num_threads(1)
    plan = [(s, None) for s in args.seeds] + [(s, args.control_dtype) for s in args.control_seeds]
    for seed, dtype in plan:
        # each seed its own solve: the run's pool drawn from the seed
        over = {"traffic": {"solve_pool": seed, "pool_solves": 1, "min_solves": 1,
                             **({"dtype": dtype} if dtype else {})}}
        t0 = time.perf_counter()
        res = run.run_cell(args.workload, seed, 0.0, False, overrides=over, t0=t0)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "dtype": dtype or "as stated", "correct": res["correct"],
                          "readings": {k: v["value"] for k, v in res["checks"].items()},
                          "metrics": res["metrics"], "failed": res["failed"],
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.reset_peak_memory_stats()


if __name__ == "__main__":
    main()
