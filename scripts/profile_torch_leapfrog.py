#!/usr/bin/env python3
"""Where one leapfrog's time goes in the PyTorch + CUDA port, on the card.

For each config, in float32 at the chain count `chip_smoke.py` runs it:

- the SMC warm start alone (`infer.smc.sample`, 1024 particles): wall and
  rounds;
- one leapfrog step as ChEES takes it (`infer.hmc.leapfrog` on the
  whitened density ``vs @ C.T + mu -> log_posterior_u_batch``, one value
  and gradient per step) at posterior-typical positions: host wall per step
  over 50 steps after warm-up, then under `torch.profiler` over 20 steps the
  device time of all kernels and of the evidence kernel, the device's busy
  share, and the kernel launches, host-to-device copies and
  synchronizations per step.

With ``--phases``, also where one evidence-kernel call spends its time:
the kernels built from the same sources with ``-DGT_PHASE_CLOCK``, so
that the warp team reads clock64() after every phase of the chain body
(block 0's first warp, so chain 0), into a library beside the real one, run
at the config's chains and at 1024 (the SMC particles); SM clock
cycles per phase (the Cholesky summed over its steps).

With ``--cov``, instead, where one covariance-kernel call (`ops.cov_cuda`)
spends its time, from the same phase-clock library: for configs 4
(gibbs_tanh, N = 27) and 2 (se, N = 32) at theta batch B = 1 and 512 (the
serving states) and at (B, N) = (256, 1024) (1022 points), float64, the SM
clock cycles from a block's start to the end of each of its phases and
barriers, for the grid's first and last blocks, and the global timer from
the first block's start to the last block's end (ns; the SMs' clocks are
not each other's). Its times per launch and per call are phase 3b's of
`chip_smoke.py`.

    python scripts/profile_torch_leapfrog.py                # configs 4 2 3
    python scripts/profile_torch_leapfrog.py --configs 3 --steps 100
    python scripts/profile_torch_leapfrog.py --phases
    python scripts/profile_torch_leapfrog.py --cov

Prints the card line and one JSON object per config (and per phase run).
Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CHAINS = {4: 12288, 2: 4096, 3: 4096}
# covariance kernel: (config, n_points or None for the config's own, B)
COV_SHAPES = ((4, None, 1), (4, None, 512), (2, None, 1), (2, None, 512), (4, 1022, 256),
              (2, 1022, 256))
COV_PHASES = {
    "small": ("points", "barrier", "pairs", "barrier", "store", "barrier"),
    "bands": ("points", "barrier", "pairs"),
    "tiles": ("points", "barrier", "entries", "barrier", "store", "barrier"),
}
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def profile_config(config, steps, prof_steps, card, dev):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gptools_tpu_torch import configs
    from gptools_tpu_torch.infer import chees, hmc, smc
    from gptools_tpu_torch.ops import evidence_cuda

    dtype = torch.float32
    C = CHAINS[config]
    prob = configs.ALL_CONFIGS[config](dtype=dtype, device=dev)
    model, data = prob.model, prob.data

    # SMC warm start alone, the kernel already built
    evidence_cuda.build()
    gen = torch.Generator(device=dev).manual_seed(7)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    smc_res = smc.sample(model, data, gen, num_particles=1024)
    torch.cuda.synchronize()
    smc_wall = time.perf_counter() - t0

    # leapfrog steps on the whitened density at the SMC particles
    with torch.no_grad():
        particles = smc_res.u[0]
        idx = torch.randint(0, particles.shape[0], (C,), generator=gen, device=dev)
        mu = particles.mean(0)
        cov = torch.cov(particles.T) + 1e-8 * torch.eye(particles.shape[1], dtype=dtype, device=dev)
        Ch = torch.linalg.cholesky(cov)
        q = torch.linalg.solve_triangular(Ch, (particles[idx] - mu).T, upper=False).T

    def logp_w(vs):
        return model.log_posterior_u_batch(vs @ Ch.T + mu, data)

    vg = chees._value_and_grad(logp_w)
    inv_mass = torch.ones(q.shape[1], dtype=dtype, device=dev)
    p = torch.randn(q.shape, generator=gen, device=dev, dtype=dtype)
    eps = torch.tensor(0.05, dtype=dtype, device=dev)

    def run(n, q, p, g):
        for _ in range(n):
            q, p, _, g = hmc.leapfrog(vg, q, p, eps, inv_mass, grad=g)
        return q, p, g

    with torch.no_grad():
        _, g = vg(q)
        q, p, g = run(10, q, p, g)
        torch.cuda.synchronize()
        evidence_cuda.reset_counts()
        t0 = time.perf_counter()
        q, p, g = run(steps, q, p, g)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
        launches = dict(evidence_cuda.LAUNCHES)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            q, p, g = run(prof_steps, q, p, g)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0

    n_launch = n_copy = n_sync = 0
    dev_us = ev_us = 0.0
    for a in prof.key_averages():
        if a.key in LAUNCH_CALLS:
            n_launch += a.count
        elif a.key.startswith("cudaMemcpy"):
            n_copy += a.count
        elif a.key in SYNC_CALLS:
            n_sync += a.count
        if str(getattr(a, "device_type", "")).endswith("CUDA"):
            t = getattr(a, "self_device_time_total", None)
            t = getattr(a, "self_cuda_time_total", 0.0) if t is None else t
            dev_us += t
            if "evidence_kernel" in a.key:
                ev_us += t
    return {
        "config": config,
        "dtype": "float32",
        "chains": C,
        "smc_wall_s": smc_wall,
        "smc_rounds": smc_res.diagnostics["num_rounds"],
        "leapfrog_wall_ms": wall_ms,
        "evidence_launches_per_step": {k: v / steps for k, v in launches.items()},
        "profiled_steps": prof_steps,
        "profiled_wall_ms_per_step": 1e3 * prof_wall / prof_steps,
        "device_ms_per_step": 1e-3 * dev_us / prof_steps,
        "evidence_kernel_ms_per_step": 1e-3 * ev_us / prof_steps,
        "device_busy_share": (1e-3 * dev_us / prof_steps) / wall_ms,
        "kernel_launches_per_step": n_launch / prof_steps,
        "memcpy_calls_per_step": n_copy / prof_steps,
        "syncs_per_step": n_sync / prof_steps,
        "card": card,
    }


def phase_library():
    """Build and bind the kernels with their phase clocks on."""
    import ctypes

    from gptools_tpu_torch.ops import evidence_cuda as ec

    ec._BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = ec._BUILD_DIR / "libgt_phase_clock.so"
    subprocess.run([ec._nvcc(), *ec._NVCC_FLAGS, "-DGT_PHASE_CLOCK", "-o", str(so),
                    *(str(ec._CSRC / u) for u in ec._UNITS)], check=True, capture_output=True)
    lib = ec.bind(ctypes.CDLL(str(so)))
    lib.gt_phase_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gt_cov_phase_clocks.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.gt_cov_phase_clocks.restype = ctypes.c_int
    return lib


def kernel_phases(config, C, lib, card, dev):
    """SM cycles per phase of chain 0 in one float32 evidence call at C
    chains on posterior-typical thetas (golden mean +- 1 std)."""
    import ctypes

    import numpy as np
    import torch

    from gptools_tpu_torch import configs
    from gptools_tpu_torch.ops import evidence_cuda as ec

    prob = configs.ALL_CONFIGS[config](dtype=torch.float64, device=dev)
    with open(os.path.join(ROOT, "tests", f"golden_config{config}.json")) as f:
        gold = json.load(f)
    gm, gs = np.asarray(gold["mean"]), np.asarray(gold["std"])
    th = gm + gs * np.random.default_rng(3).uniform(-1.0, 1.0, (C, gm.shape[0]))
    with torch.no_grad():
        thT, ev, aux = prob.model._evidence_inputs(
            torch.tensor(th.T, dtype=torch.float32, device=dev), prob.data)
    thT, aux = thT.contiguous(), {k: v.contiguous() for k, v in aux.items()}
    real, ec._LIB = ec._LIB, lib
    try:
        ec.loglik_vag_cuda(thT, ev, aux)
        torch.cuda.synchronize()
        lib.gt_phase_clocks(None, 1)
        ec.loglik_vag_cuda(thT, ev, aux)
        torch.cuda.synchronize()
    finally:
        ec._LIB = real
    buf = (ctypes.c_longlong * 256)()
    lib.gt_phase_clocks(buf, 0)
    marks = [buf[0]] + [buf[i] for i in range(1, 256) if buf[i] != 0]
    d = [b - a for a, b in zip(marks, marks[1:])]
    steps = (ev.n + 1) // 2
    if len(d) != 2 + steps + 6:
        raise RuntimeError(f"phase marks: {len(d)} phases, expected {8 + steps}")
    names = ("ll", "alpha_diag_kinv", "kinv_pairs", "pair_vjp", "point_sums", "outputs")
    return {
        "config": config, "dtype": "float32", "chains": C, "n": ev.n,
        "cycles": {"operands": d[0], "build": d[1], "cholesky": sum(d[2:2 + steps]),
                   **dict(zip(names, d[2 + steps:]))},
        "cholesky_steps": steps, "total_cycles": sum(d), "card": card,
    }


def cov_phases(config, n_points, B, lib, card, dev):
    """SM cycles per phase of the first and last blocks of one float64
    covariance-kernel call at (B, N), and the global span (ns)."""
    import ctypes

    import torch

    import chip_smoke as cs
    from gptools_tpu_torch import configs
    from gptools_tpu_torch.ops import cov_cuda
    from gptools_tpu_torch.ops import evidence_cuda as ec

    kind = cs.COV_KIND_OF[config]
    kw = {} if n_points is None else {"n_points": n_points}
    prob = configs.ALL_CONFIGS[config](dtype=torch.float64, device=dev, **kw)
    X, nid = prob.data.Xf.reshape(-1), prob.data.nid
    th = cs.posterior_draws(config, B, torch.float64, dev, seed=B)
    real, fns = ec._LIB, dict(cov_cuda._FNS)
    ec._LIB = lib
    cov_cuda._FNS.clear()
    try:
        cov_cuda.cov_cuda(kind, X, nid, th)
        torch.cuda.synchronize()
        if lib.gt_cov_phase_clocks(None, None, 1) != 0:
            raise RuntimeError("gt_cov_phase_clocks reset failed")
        cov_cuda.cov_cuda(kind, X, nid, th)
        torch.cuda.synchronize()
        layout = cov_cuda.layout(X.shape[0], B, torch.float64)
    finally:
        ec._LIB = real
        cov_cuda._FNS.clear()
        cov_cuda._FNS.update(fns)
    clk = (ctypes.c_longlong * 16)()
    gtime = (ctypes.c_ulonglong * 4)()
    if lib.gt_cov_phase_clocks(clk, gtime, 0) != 0:
        raise RuntimeError("gt_cov_phase_clocks read failed")
    names = COV_PHASES[layout["layout"]]
    row = {"kind": kind, "B": B, "N": X.shape[0], "dtype": "float64", "layout": layout}
    for r, tag in ((0, "first_block"), (1, "last_block")):
        marks = [clk[8 * r + k] for k in range(len(names) + 1)]
        row[tag] = {f"{k + 1}_{name}": marks[k + 1] - marks[0] for k, name in enumerate(names)}
    row["first_start_to_last_end_ns"] = int(gtime[3]) - int(gtime[0])
    row["card"] = card
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", type=int, nargs="*", default=[4, 2, 3])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--prof-steps", type=int, default=20)
    ap.add_argument("--phases", action="store_true",
                    help="also the evidence kernel's cycles per phase")
    ap.add_argument("--cov", action="store_true",
                    help="instead, the covariance kernel's cycles per phase")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_leapfrog: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card)
    if args.cov:
        lib = phase_library()
        for config, n_points, B in COV_SHAPES:
            print(json.dumps(cov_phases(config, n_points, B, lib, card,
                                        torch.device("cuda", 0))), flush=True)
        return 0
    for c in args.configs:
        row = profile_config(c, args.steps, args.prof_steps, card, torch.device("cuda", 0))
        print(json.dumps(row), flush=True)
    if args.phases:
        lib = phase_library()
        for c in args.configs:
            for C in (CHAINS[c], 1024):
                print(json.dumps(kernel_phases(c, C, lib, card, torch.device("cuda", 0))),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
