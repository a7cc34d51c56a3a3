#!/usr/bin/env python3
"""The covariance kernel of this checkout against another tree's, on the card.

Builds ``gptools_tpu_torch/csrc/cov_kernel.cu`` of this checkout and of the
tree given (for example the parent commit, unpacked with ``git archive``
into a git-ignored directory) into two libraries, one ``nvcc`` each, both
at once, and calls their entry points ``gt_{kind}_cov_{f64,f32}`` (the same
arguments in both) on the same inputs: configs 4 (gibbs_tanh, N = 27) and 2
(se, N = 32) at theta batch B = 1 and 512 (the serving states), and both
kinds at (B, N) = (16, 1001) and (256, 1024) (the configs at 999 and 1022
points), float64 and float32, thetas from the golden posteriors. Per shape
and dtype: the largest difference between the two outputs over max |K|
(it must stay within 1e-12 in float64 and 1e-5 in float32, or the script
fails), whether each output is exactly symmetric, and each library's
device time per launch (CUDA events around a CUDA graph of 20 launches,
`chip_smoke.graph_ms`), taken in the order other, this, this, other,
``--rounds`` times over.

    python scripts/ab_cov_kernel.py --other .chip_scratch/parent

Prints the card line and one JSON object per shape and dtype. Needs a
CUDA device.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (config, n_points or None for the config's own, B)
SHAPES = ((4, None, 1), (4, None, 512), (2, None, 1), (2, None, 512), (4, 999, 16),
          (2, 999, 16), (4, 1022, 256), (2, 1022, 256))


def build(trees):
    """{name: library} of each tree's cov_kernel.cu, the nvcc calls run
    together."""
    from gptools_tpu_torch.ops import evidence_cuda as ec

    procs = {}
    for name, tree in trees.items():
        out = ec._BUILD_DIR / f"ab_{name}"
        out.mkdir(parents=True, exist_ok=True)
        src = os.path.join(tree, "gptools_tpu_torch", "csrc", "cov_kernel.cu")
        cmd = [ec._nvcc(), *ec._NVCC_FLAGS, "-o", str(out / "libcov.so"), src]
        procs[name] = (out / "libcov.so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc of {trees[name]} failed:\n{log}")
        lib = ctypes.CDLL(str(so))
        for kind in ("se", "gibbs_tanh"):
            for dt in ("f32", "f64"):
                fn = getattr(lib, f"gt_{kind}_cov_{dt}")
                fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                               + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
                fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def caller(lib, kind, X64, ids, th):
    """One launch of ``lib``'s entry point into its own output, on the
    current stream."""
    import torch

    fn = getattr(lib, f"gt_{kind}_cov_{'f64' if th.dtype == torch.float64 else 'f32'}")
    B, n = th.shape[0], X64.shape[0]
    out = torch.empty((B, n, n), dtype=th.dtype, device=th.device)

    def call():
        rc = fn(n, X64.data_ptr(), ids.data_ptr(), th.data_ptr(), B, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: cudaError {rc}")

    return call, out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, help="root of the tree to compare with")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ab_cov_kernel: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gptools_tpu_torch import configs

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    libs = build({"other": os.path.abspath(args.other), "this": ROOT})
    for config, n_points, B in SHAPES:
        kind = cs.COV_KIND_OF[config]
        kw = {} if n_points is None else {"n_points": n_points}
        prob = configs.ALL_CONFIGS[config](dtype=torch.float64, device=dev, **kw)
        X64 = prob.data.Xf.reshape(-1).to(torch.float64).contiguous()
        ids = prob.data.nid.to(torch.int32).contiguous()
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            th = cs.posterior_draws(config, B, dtype, dev, seed=B).contiguous()
            calls = {name: caller(lib, kind, X64, ids, th) for name, lib in libs.items()}
            for call, _ in calls.values():
                call()
            torch.cuda.synchronize()
            K0, K1 = calls["other"][1], calls["this"][1]
            rel = float((K1 - K0).abs().max() / K0.abs().max())
            sym = {name: bool((K == K.mT).all()) for name, (_, K) in calls.items()}
            times = {name: [] for name in calls}
            for _ in range(args.rounds):
                for name in ("other", "this", "this", "other"):
                    times[name].append(1e3 * cs.graph_ms(calls[name][0]))
            row = {
                "kind": kind, "B": B, "N": X64.shape[0],
                "dtype": str(dtype).replace("torch.", ""),
                "max_abs_diff_over_max_abs_K": rel, "exactly_symmetric": sym,
                "device_us_per_launch": {k: [round(v, 4) for v in t] for k, t in times.items()},
                "median_us": {k: float(np.median(t)) for k, t in times.items()},
                "card": card,
            }
            print(json.dumps(row), flush=True)
            if not rel <= tol:
                print(f"ab_cov_kernel: the two kernels disagree ({rel:.3e} > {tol:g})",
                      file=sys.stderr)
                return 1
            del calls, K0, K1
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
