#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; no phase falls back):

1. device: needs CUDA; prints the card's name and power limit
   (``nvidia-smi``); TF32 off for matmul and cuDNN.
2. build: compiles the evidence kernel and the covariance kernel, every
   kind and dtype, from ``gptools_tpu_torch/csrc`` with one ``nvcc`` call
   for ``sm_90a`` (into ``gptools_tpu_torch/_build``).
   Then, per evidence and covariance instantiation, the compiler's
   registers, stack frame and spill bytes (``-Xptxas -v``; a spill fails
   the run), and for the evidence kernel the dynamic shared memory of a
   block at the configs' N.
3. kernel parity, kernel vs plain PyTorch version on the card, on the
   inputs the main paths give it (theta rows and aux channels from
   `GPModel._evidence_inputs`): config 4 (kind gibbs_tanh, N = 27) at
   C = 12288, 1000, 1 and 1023 (a C that fills no last block); config 2
   (se, N = 32) and config 3 (matern52 with aux mu and w, N = 35) at
   C = 4096, 1000, 1 and 1023; the se_noise (se + nd) and warped_se_deriv
   (se + w + wp) models at C = 256; an se_noise model at N = 48 (the
   largest shared-memory case) at C = 1023, float64; config 1 (se, N = 40,
   value rows only) at C = 9 (its MAP's starts) and 1023. float64: ll rtol
   1e-9, gradient and aux cotangents rtol 1e-7 / atol 1e-9; float32: the
   bounds below; the -inf contract on every output; three calls at the
   main paths' C give the same bits; at the main paths' C and at C = 1024
   (the SMC particles), the kernel's device time per launch (CUDA events
   around a CUDA graph of 20 launches), its time per call through the
   wrapper, the plain version's per call (main paths' C only), the bound,
   and, for scale, the time of ``torch.linalg.cholesky_ex`` on a (C, N, N)
   batch of the same covariances (the factorization alone); and, in
   float64, the same times at phase 7's C (config 1 at 9, config 2 at 8 and
   64, config 3 at 16, config 4 at 16).
3b. covariance-kernel parity, kernel vs plain PyTorch version (the fused
   single-theta builders) on the card: config 4 (gibbs_tanh, N = 27) and
   config 2 (se, N = 32) at theta batch B = 1 and 512 (the MCMC
   predictor's ``max_samples``; the kernel's small layout), and both kinds
   at (B, N) = (16, 1001) (the configs at 999 points: tiles with a ragged
   edge and rows off 16-byte boundaries) and (256, 1024) (at 1022 points);
   and gibbs_tanh at config 5's served shapes, (512, 47) and (1, 47), on
   its 47 latent points; thetas from the golden posteriors. Gates:
   float64 max |dK| / max |K|
   <= 1e-12, float32 <= 1e-5; the whole matrix exactly symmetric (K ==
   K^T, every block). Per shape the layout the launch took, CUDA-event
   times per call of kernel (with the points made once, as a `GPModel`
   calls it) and plain version, the kernel's device time per launch
   (torch.profiler; and a CUDA graph of 20 launches), the wrapper's host
   time per call (CPU clock around 200 calls) with the points made once
   and with them made each call (``cov_cuda``), and the kernel's bound.
3c. the route on the card, float64: config 4 at 60 points (N = 62, past
   the kernel's N_MAX) at C = 256 must take the chains-minor route (route
   calls > 0, no launch, no plain call), its ll within 1e-9 and its
   gradient within 1e-9 / 1e-9 of the same model on the CPU; the N = 48
   se_noise model must take the kernel under ``evidence_backend`` "auto"
   and "fused_pallas" and the route under "xla", the route within 1e-9 (ll)
   and 1e-7 / 1e-9 (gradient) of the kernel; ms per call of each.
4. main paths in float32, each with the launch counts set to 0 just before
   and read just after: config 4 through ``smc_then_chees`` at 12288 chains
   (75 warmup + 300 samples), configs 2 and 3 at 4096 chains (100 + 200,
   `F32_SAMPLES`; phase 5 runs them at 100 + 500);
   1024 particles, max_steps 256. Every gradient must go through the kernel
   (its launch count up, plain-version calls 0, route calls 0); quality
   gates R-hat <= 1.1, divergences <= 1e-3 of draws; the golden rule is
   reported, not gated.
5. the same pipelines in float64, with the same gates and the posterior
   moments held to tests/golden_config{4,2,3}.json by the rule of
   scripts/f32_parity.py (why not in float32: see the comment at phase 5);
   then config 5 (1024 chains, 100 + 100, cut from the protocol's 100 +
   300; its transformed observation sends the evidence to the route: route
   calls > 0, no launch, no plain call) with the same gates and
   tests/golden_config5.json; config 5's host wall and device time per
   leapfrog; and ``summarize_samples`` of config 4's float64 draws on the
   card and on the host (the native library), which must agree within
   1e-6 in ESS and R-hat.
6. serving, configs 4, 2, 3 and 5 in float64, the covariance kernel's main
   path (config 3, a warped Matern, has no covariance kind: its pallas
   backend takes the fused build and launches nothing),
   with its launch counts set to 0 just before and read just after: from
   phase 5's posterior draws, a ``FrozenMCMCPredictor`` (``max_samples``
   512) and a ``FrozenPredictor`` at the posterior mean on
   ``GPModel(..., cov_backend="pallas")`` answer 20 requests of 200 grid
   points each, alternating n = 0 (the profile) and n = 1 (its gradient).
   The states must go through the kernel (launches > 0, plain calls 0);
   every answer is held to the same predictors on ``cov_backend="fused"``
   (rtol 1e-9); state-build and per-request times of both backends, and
   (reported, not gated) the share of config 4's true profile within
   +-2 predictive std.
7. (run right after phase 3, before the first torch.profiler session of
   phase 3b, whose CUDA tracing slows every later launch of the process
   on the host) the reference's own inference routes in float64, each run
   with the evidence counts set to 0 just before and read just after (kernel
   launches > 0, plain-version calls 0, route calls 0), each printing its
   wall, its density calls (= launches) per transition or iteration and
   the host wall per density call: (7a) config 1 through
   ``GaussianProcess.optimize_hyperparameters`` (8 random starts and the
   current point, 200 L-BFGS steps), its best theta within 1e-6 of
   tests/golden_config1.json and its log posterior within 1e-8 + 1e-10
   |lp|, and the same starts through ``map_fit.minimize`` on the CPU
   within 1e-7 in u of the card's optimum for every converged start; (7b)
   config 2 through ``run_sampler(..., "nuts")`` (8 chains, `NUTS_CUT`
   warmup + samples, cut from its protocol's 500 + 1000); (7c) config 3 through ``"hmc"`` (16 chains, 32
   steps, `HMC_CUT` warmup + samples, cut from 500 + 800); (7d) config 4
   through ``smc_then_nuts`` (whitened, 1024 chains, `SMC_NUTS_CUT` warmup +
   samples, cut from the pipeline's 150 + 350, max_depth 8); (7e) config 2
   through ``"pt"`` (4 temperatures x 16 chains, `PT_CUT` warmup +
   samples, cut from 200 + 400, 16 steps; the cold rung's draws and
   divergences); each gated on
   R-hat <= 1.1, divergences <= 1e-3 of draws and the golden rule; (7f)
   config 4 through ``"advi"`` (mean-field, 1500 steps, 16 ELBO draws),
   gated on finite ELBOs whose last 100 average above the first 100, q's
   mean reported against the golden.

8. (run right after phase 7, before phase 3b's profiler sessions) the
   rest of the reference's kernel zoo in float64, through the per-chain
   route (`models.gp.GPModel._per_chain_batch`, chosen by `_evidence_plan`
   before any launch; its value and gradient replay a CUDA graph per
   shape), each part with the counts set to 0 just before and read just
   after (per-chain route calls > 0; launches of either CUDA kernel,
   calls of either plain version and chains-minor calls 0): (8a) the
   free-nu Matern (`MaternGeneralKernel`, the reference test's prior) on
   config 2's data through ``run_sampler(..., "nuts")`` (8 chains,
   `FREE_NU_RUN`; the reference test's protocol `FREE_NU_PROTOCOL`),
   gated on R-hat <= 1.1, divergences <= 1e-3 of draws, nu's std > 0.05
   and every nu inside (1.05, 6), then 64 of its draws card against CPU
   (value 1e-9, gradient 1e-7 / 1e-9), its peak device memory, and the
   graph against the eager route (1e-12) with the ms per call of each;
   (8b) an RQ + SE sum on config 1's data through
   ``GaussianProcess.optimize_hyperparameters`` (8 random starts and the
   current point), the same starts through ``map_fit.minimize`` on the
   CPU: the best start's log posterior within 1e-9 (relative) and its u
   within 1e-6; (8c) card against CPU at `ZOO_C` thetas (value 1e-9,
   gradient 1e-7 / 1e-9, ms per call of each): the Gauss, exp and
   interpolated (6 knots) Gibbs warps on config 4's data, ``2 (SE(x1)
   RQ(x2)) + noise`` on a 12 x 12 grid with 12 slopes (N = 156, `GRID_C`),
   a `ChainRuleKernel` SE on config 2's data (also equal to the SE), and a
   Gibbs-Gauss model under a `SortedUniformJointPrior` (its density in u,
   through the `OrderedIntervalBijector`); after phase 10, the CUDA
   launches of one eager density call of each model (torch.profiler: the
   script's first profiler session, which slows every later launch of the
   process on the host, so phases 9 and 10 run before it).

9. (run right after phase 8, before phase 3b) the chains sharded over a
   mesh (`gptools_tpu_torch.parallel`), float64, each sharded run held to
   the unsharded run from the same seed (every draw within `MESH_TOL`),
   with the evidence and collective counts set to 0 just before each run
   and read just after: (9a) config 4 through ``smc_then_chees(mesh=
   make_mesh())`` at world size 1 on NCCL, 1024 chains, 75 + 150 (the
   kernel's launches > 0, plain-version and route calls 0, collectives >
   0; the walls and the host wall per density call); (9c) config 5
   through the route at world size 1, 1024 chains, SMC + 25 + 25 (route
   calls > 0, no launch); each of 9a and 9c runs unsharded, sharded,
   sharded, unsharded, and prints all four walls; (9b) config 4 at 2048
   chains, 75 + 150, on two ranks sharing the card (gloo,
   `scripts/torch_mp_worker.py`), each rank's draws against one
   process's unsharded run at 2048 chains and its kernel launched at
   C = 1024, its half, never at 2048; and config 5's log marginal and
   gradient through the route at 1024 thetas, 512 a rank, against one
   unsharded call at 1024; (9d) in this process, float64 and float32:
   ``log_posterior_u_batch``'s value and gradient at 1024 chains against
   the same chains in blocks of 512 + 512, 1 + 1023 and 256 x 4, a call
   each, every chain the same bits (config 3: the kernel with aux mu and
   w; warped_se_deriv: w and wp; se_noise: nd; config 5: the chains-minor
   route; config 2, no aux channel, the control; RQ + SE on config 1's
   data: the per-chain route), each density on its path, each largest
   difference on a line of its own; (9e) config 3 at 1024 chains, SMC +
   25 + 25, on two ranks sharing the card (gloo), each rank's draws
   against one process's unsharded run and its kernel launched at
   C = 512 only.

10. (run right after phase 9, before phase 3b) the reference's entry
   points (`gptools_tpu_torch.examples`) on the card, float64, each
   ``main(argv)`` called in this process with the evidence counts set to 0
   just before and read just after (the wall, the launches by kind, the
   plain-version and route calls; the run's kernel launched, no plain
   call): (10a) ``run_config 1``, its theta within 1e-6 of
   tests/golden_config1.json; (10b) ``run_config 4`` (SMC, 2048 particles,
   8 mutations), every printed mean finite and within 0.5 posterior std of
   tests/golden_config4.json; (10c) ``sine_derivative_constraint``, its
   NUTS split R-hat <= 1.1 and its predicted slope at x = 1 within 3 of
   its std of 2 cos 2; (10d) ``multimodal_pt`` at `MULTIMODAL_CUT`
   warmup + samples (cut from 100 + 100), finite summaries and PT's swap acceptance per rung pair; (10e)
   ``python -m gptools_tpu_torch.examples.run_config 1`` as its own
   process, run beside 10d: exit 0 and 10a's theta lines.

The last three lines of standard output are the card line, the kernel
table as JSON and ``{"ok": true, "device": {...}}``.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 7
RHAT_GATE = 1.1
DIVERGENCE_FRAC_GATE = 1e-3
# float32 kernel vs float32 plain version on the same posterior-typical
# inputs. Both factor the same f32 matrix; at config 4 cond(K) is ~1e4
# (err_y^2 floors the spectrum), so the two Cholesky orders may differ by
# up to n * eps32 * cond ~ 3e-2 relative in K^-1; measured on an H100
# (700 W) over 12288 draws: ll 4.6e-5 relative, gradient 9.8e-4. The
# bounds leave ~20x room on ll and ~10x on the gradient (norm over the
# theta rows, or over the N points of an aux cotangent, per chain). The
# same bounds hold configs 2 and 3, whose err_y^2 (1e-2 and 2.5e-3 on the
# values) floor the spectrum as high or higher.
F32_LL_RTOL = 1e-3
F32_GRAD_RTOL = 1e-2
# Published H100 SXM peaks (NVIDIA data sheet): CUDA-core (non-tensor)
# FP32 and FP64, HBM bandwidth. The kernel's bound is the larger of its
# flops over the dtype's peak and its bytes over the bandwidth.
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
PEAK_BYTES = 3.35e12
# flops per lower-triangle pair of the build and its VJP, counted from
# csrc/pair_math.cuh (a transcendental counts as one): the Gibbs pair
# carries the g1/g2/dg2dx algebra and its hand VJP, the stationary pairs a
# few products around one exp.
PAIR_FLOPS = {"gibbs_tanh": 150, "se": 45, "matern52": 55}
SOURCE = "gptools_tpu_torch/csrc/evidence_kernel.cu"
REPLACES = "gptools_tpu/ops/evidence_pallas.py:475"
COV_SOURCE = "gptools_tpu_torch/csrc/cov_kernel.cu"
COV_REPLACES = "gptools_tpu/ops/pallas_cov.py:98"
# flops of one covariance entry per block sel (0 value-value, 1 and 2
# value-slope, 3 slope-slope), counted from csrc/cov_entry.cuh and the pair
# functions it calls (a transcendental or a division counts as one; ids
# outside {0, 1} cost nothing), and of the per-point tanh warp
COV_FLOPS = {"se": (9, 12, 12, 12), "gibbs_tanh": (15, 35, 35, 58)}
COV_POINT_FLOPS = {"se": 0, "gibbs_tanh": 13}
# the covariance kernel's kind of each served config; config 3 (a warped
# Matern) has none and takes the fused build on the pallas backend, as in
# the reference
COV_KIND_OF = {4: "gibbs_tanh", 2: "se", 3: None, 5: "gibbs_tanh"}
SERVE_REQUESTS = 20
SERVE_POINTS = 200
SERVE_MAX_SAMPLES = 512
SERVE_BUILDS = 5
# config -> (pipeline chains, warmup, samples, parity C values: the main
# path's, 1000, and two that fill no block of 4 warps, 1 and 1023)
PATHS = {4: (12288, 75, 300, (12288, 1000, 1, 1023)),
         2: (4096, 100, 500, (4096, 1000, 1, 1023)),
         3: (4096, 100, 500, (4096, 1000, 1, 1023)),
         # config 5's 300 samples cut to 100 to pay for phase 9d and 9e
         # within the script's 900 s (PERF.md, section 7)
         5: (1024, 100, 100, ())}
# phase 4 (float32) runs configs 2 and 3 at fewer samples than phase 5, to
# keep the script's wall with phase 7 in it (PR 6: 500 each)
F32_SAMPLES = {2: 200, 3: 200}
SMC_PARTICLES = 1024  # the SMC rounds' C; timed beside the main paths' C
# the evidence kernel's kind of each pipeline; config 5's transformed
# observation (T) sends its evidence to the route, as in the reference
KIND_OF = {1: "se", 4: "gibbs_tanh", 2: "se", 3: "matern52", 5: None}
# config 1 (se, N = 40, value rows only): the MAP's C (8 starts and the
# current point) and one that fills no block
CONFIG1_C = (9, 1023)
# phase 7's C per config, timed in float64 in phase 3: config 1's MAP,
# config 2's NUTS (8 chains) and tempering lanes (4 rungs x 16 chains),
# config 3's HMC (16 chains), config 4's ADVI draws (16; its NUTS at 1024 is
# the SMC particles' C above)
INFERENCE_C = {1: (9,), 2: (8, 64), 3: (16,), 4: (16,)}
# config 3's HMC in phase 7: warmup + samples, cut from the protocol's
# 500 + 800 (16 chains x 32 leapfrogs a transition, host-paced), and from
# 200 + 300 to keep the script within 900 s on a slower host (PERF.md, §7)
HMC_CUT = (100, 150)
# 7d's warmup + samples, cut from the pipeline's 150 + 350 (75 + 150 until
# the script's runs on slower hosts passed 900 s; PERF.md, section 7)
SMC_NUTS_CUT = (50, 100)
NUTS_CUT = (250, 500)  # 7b's warmup + samples, cut from config 2's 500 + 1000
PT_CUT = (100, 200)  # 7e's warmup + samples, cut from 200 + 400 (PERF.md, section 7)
# 10d's warmup + samples, cut from 100 + 100 (the example's own defaults are
# 300 + 400) to keep the script within 900 s (PERF.md, section 7)
MULTIMODAL_CUT = (50, 50)
ROUTE_N_POINTS = 60  # config 4 at 60 points: N = 62 > N_MAX, the route on the card
ROUTE_C = 256
# phase 8: the free-nu Matern's NUTS, the reference test's protocol (chains,
# warmup, samples; tests/test_parity.py:241-246) and the run here, cut to
# 150 + 150 to keep the script within 900 s (PERF.md, §7)
FREE_NU_PROTOCOL = (8, 300, 400)
FREE_NU_RUN = (8, 150, 150)
ZOO_C = 256  # 8c's thetas per parity call
GRID_C = 64  # 8c's thetas for the 2-D grid (N = 156)
# phase 9: (chains, warmup, samples) of each sharded run, and the largest
# draw difference allowed from the unsharded run (0 expected: a chain's
# density and gradient do not depend on how many chains share the call)
MESH_RUNS = {"9a": (1024, 75, 150), "9b": (2048, 75, 150), "9c": (1024, 25, 25),
             "9e": (1024, 25, 25)}
MESH_TOL = 1e-10
MESH_WORKER_TIMEOUT = 300
# 9d: one density call on WIDTH_C chains against the same chains in blocks,
# a call each; every chain's value and gradient must be the same bits
WIDTH_C = 1024
WIDTH_SPLITS = ((512, 512), (1, 1023), (256, 256, 256, 256))
# phase 10
EXAMPLE_SUBPROCESS_TIMEOUT = 300
MEAN_GATE_STDS = 0.5  # 10b: each SMC mean within this many posterior stds of the golden
SLOPE_GATE_STDS = 3.0  # 10c: the predicted slope within this many of its stds of 2 cos 2
_PARAM_LINE = r"^\s+(\S+) = (\S+) \+- (\S+)\s+\[ESS (\S+), Rhat (\S+)\]$"


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def golden(config):
    with open(os.path.join(ROOT, "tests", f"golden_config{config}.json")) as f:
        return json.load(f)


def posterior_draws(config, C, dtype, device, seed):
    """Golden mean +- 1 std (uniform): thetas (C, P); for config 1 (a MAP
    golden) the optimum times exp(U(-0.3, 0.3)), the region its L-BFGS
    starts cross."""
    import torch

    gold = golden(config)
    rng = np.random.default_rng(seed)
    if "mean" not in gold:
        th0 = np.asarray(gold["theta"])
        th = th0 * np.exp(rng.uniform(-0.3, 0.3, (C, th0.shape[0])))
    else:
        gm, gs = np.asarray(gold["mean"]), np.asarray(gold["std"])
        th = gm + gs * rng.uniform(-1.0, 1.0, (C, gm.shape[0]))
    return torch.tensor(th, dtype=dtype, device=device)


def cuda_ms(fn, reps=30, warm=3):
    """Median milliseconds of ``fn`` by CUDA events, after warm-up."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def graph_ms(fn, calls=20, reps=15):
    """Median milliseconds per call of ``fn`` on the device alone: ``calls``
    calls captured in one CUDA graph, replayed between two CUDA events (no
    host overhead between the launches, unlike `cuda_ms`)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph
    return float(np.median(times))


def bound(ev, thetaT, aux):
    """(bound_ms, bound_by) of one kernel call on these inputs: its flops
    (exact loop counts of the factorization, solves, L^-1 and K^-1 at the
    pairs, two flops per multiply-add, plus `PAIR_FLOPS` per pair) over the
    dtype's peak, against its bytes (theta and aux in, ll, grad and aux
    cotangents out, the (N,) constants once) over the bandwidth."""
    n, C = ev.n, thetaT.shape[1]
    chol = sum(j for i in range(n) for j in range(i + 1))
    solves = n * (n - 1)
    linv = sum(i - j - 1 for j in range(n) for i in range(j + 1, n))
    kinv = sum((n - i) * (i + 1) for i in range(n))
    pairs = n * (n + 1) // 2
    flops = C * (2 * (chol + solves + linv + kinv) + PAIR_FLOPS[ev.kind] * pairs)
    item = thetaT.element_size()
    nbytes = (C * item * (2 * thetaT.shape[0] + 1 + 2 * n * len(aux))
              + n * (3 * 8 + 4))
    t_ops = flops / PEAK_FLOPS[str(thetaT.dtype).replace("torch.", "")]
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def cov_bound(kind, nid, B, item):
    """(bound_ms, bound_by) of one covariance-kernel call: the flops the
    entries of this nid need (`COV_FLOPS` per block, `COV_POINT_FLOPS` per
    point) over the dtype's peak, against its bytes (the B N^2 output
    written once; X, nid and theta read once) over the bandwidth."""
    ids = nid.cpu().numpy()
    n = ids.shape[0]
    ok = (ids == 0) | (ids == 1)
    sel = (2 * ids[:, None] + ids[None, :])[ok[:, None] & ok[None, :]]
    per_theta = sum(int((sel == k).sum()) * f for k, f in enumerate(COV_FLOPS[kind]))
    flops = B * (per_theta + n * COV_POINT_FLOPS[kind])
    from gptools_tpu_torch.ops import cov_cuda

    nbytes = B * n * n * item + n * (8 + 4) + B * cov_cuda.KINDS[kind] * item
    t_ops = flops / PEAK_FLOPS["float64" if item == 8 else "float32"]
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def kernel_inputs(model, data, thetas):
    """The kernel's inputs on the main path: base theta rows, constants and
    aux channels from full thetas (C, P), contiguous."""
    import torch

    with torch.no_grad():
        thT, ev, aux = model._evidence_inputs(thetas.T, data)
    return thT.contiguous(), ev, {k: v.contiguous() for k, v in aux.items()}


def parity(tag, model, data, thetas64, f32=True):
    """Kernel vs plain version at one shape, float64 and (with ``f32``)
    float32; returns the float64 max abs error over every output."""
    import torch

    from gptools_tpu_torch.ops import evidence_cuda as ec

    thT, ev, aux = kernel_inputs(model, data, thetas64)
    outk = ec.loglik_vag_cuda(thT, ev, aux)
    outp = ec.loglik_vag_plain(thT, ev, aux)
    torch.cuda.synchronize()
    llk, llp = outk[0], outp[0]
    gk = [outk[1]] + [outk[2][k] for k in aux]
    gp = [outp[1]] + [outp[2][k] for k in aux]
    if not (torch.isfinite(llk).all() and all(torch.isfinite(g).all() for g in gk)):
        fail(f"{tag} f64: non-finite kernel output on posterior draws")
    ll_rel = float(((llk - llp).abs() / llp.abs()).max())
    g_margin = max(float(((a - b).abs() - (1e-9 + 1e-7 * b.abs())).max())
                   for a, b in zip(gk, gp))
    err = max([float((llk - llp).abs().max())]
              + [float((a - b).abs().max()) for a, b in zip(gk, gp)])
    print(f"phase3 {tag} f64 C={thT.shape[1]} aux={sorted(aux)}: ll max rel err "
          f"{ll_rel:.3e} (tol 1e-9); grad+aux max |d| - (1e-9 + 1e-7|g|) = "
          f"{g_margin:.3e} (must be <= 0); max abs err {err:.3e}")
    if not ll_rel <= 1e-9 or not g_margin <= 0.0:
        fail(f"{tag}: f64 kernel/plain disagree")
    if not f32:
        return err

    # float32 on the main path's float32 inputs (aux formed in float32)
    thT32, ev, aux32 = kernel_inputs(model, data, thetas64.float())
    outk = ec.loglik_vag_cuda(thT32, ev, aux32)
    outp = ec.loglik_vag_plain(thT32, ev, aux32)
    ll_rel32 = float(((outk[0] - outp[0]).abs() / outp[0].abs().clamp(min=1.0)).max())
    pairs = [(outk[1], outp[1], "theta")] + [
        (outk[2][k], outp[2][k], k) for k in aux32]
    g_rel32 = {name: float(((a - b).norm(dim=0) / b.norm(dim=0)).max())
               for a, b, name in pairs}
    vs64 = float((outk[0].double() - llp).abs().median())
    print(f"phase3 {tag} f32: kernel vs plain ll max rel {ll_rel32:.3e} (tol "
          f"{F32_LL_RTOL}), grad/aux max rel (norm) "
          f"{ {k: float(f'{v:.3e}') for k, v in g_rel32.items()} } (tol "
          f"{F32_GRAD_RTOL}); f32 kernel vs f64 plain ll median abs {vs64:.3e}")
    if not ll_rel32 <= F32_LL_RTOL or not max(g_rel32.values()) <= F32_GRAD_RTOL:
        fail(f"{tag}: f32 kernel/plain disagree")
    return err


def neg_inf_contract(tag, model, data, thetas64):
    """A NaN in one chain's theta gives ll = -inf and zeros in every
    gradient and cotangent of that chain only."""
    import torch

    from gptools_tpu_torch.ops import evidence_cuda as ec

    for dtype in (torch.float64, torch.float32):
        th = thetas64[:8].to(dtype).clone()
        th[1, 0] = float("nan")
        thT, ev, aux = kernel_inputs(model, data, th)
        out = ec.loglik_vag_cuda(thT, ev, aux)
        ll, gs = out[0], [out[1]] + [out[2][k] for k in aux]
        keep = [0, 2, 3, 4, 5, 6, 7]
        ok = (float(ll[1]) == -float("inf")
              and all(bool((g[:, 1] == 0).all()) for g in gs)
              and bool(torch.isfinite(ll[keep]).all())
              and all(bool(torch.isfinite(g).all()) for g in gs))
        print(f"phase3 {tag} -inf contract {dtype}: ll[1]={float(ll[1])} -> "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{tag}: -inf contract")


def determinism(tag, model, data, thetas64):
    """Three calls on the same inputs give the same bits in ll, the
    gradient and every cotangent (no atomics; sums in a fixed order)."""
    import torch

    from gptools_tpu_torch.ops import evidence_cuda as ec

    for dtype in (torch.float32, torch.float64):
        thT, ev, aux = kernel_inputs(model, data, thetas64.to(dtype))
        outs = [ec.loglik_vag_cuda(thT, ev, aux) for _ in range(3)]
        flat = [[o[0], o[1], *(o[2][k] for k in aux)] for o in outs]
        same = all(torch.equal(a, b) for f in flat[1:] for a, b in zip(flat[0], f))
        print(f"phase3 {tag} determinism {dtype} C={thT.shape[1]}: three calls "
              f"bitwise equal: {same}")
        if not same:
            fail(f"{tag}: kernel calls on the same inputs differ")


def kernel_times(tag, model, data, thetas, card, plain=True):
    """The kernel's time per call through the wrapper (`cuda_ms`, host work
    included, as the kernels line's `ms` of every row) and its device time
    per launch (`graph_ms`), the plain version's per call, the kernel's
    bound, and the time of torch.linalg.cholesky_ex on a (C, N, N) batch
    of the same covariances. Returns (ms, device_ms, plain_ms or None,
    bound_ms, bound_by)."""
    import torch

    from gptools_tpu_torch.ops import evidence_cuda as ec

    thT, ev, aux = kernel_inputs(model, data, thetas)
    t_dev = graph_ms(lambda: ec.loglik_vag_cuda(thT, ev, aux))
    t_call = cuda_ms(lambda: ec.loglik_vag_cuda(thT, ev, aux))
    t_p = cuda_ms(lambda: ec.loglik_vag_plain(thT, ev, aux)) if plain else None
    b_ms, b_by = bound(ev, thT, aux)
    K = ec._plain_cov(ev, thT, aux) + torch.diag(ev.err2.to(thT.dtype))[:, :, None]
    if "nd" in aux:
        K = K + torch.diag_embed(aux["nd"].T).permute(1, 2, 0)
    K = K.permute(2, 0, 1).contiguous()
    t_chol = cuda_ms(lambda: torch.linalg.cholesky_ex(K))
    plain_txt = "not timed" if t_p is None else f"{t_p:.4f} ms"
    print(f"phase3 time {tag} C={thT.shape[1]} N={ev.n} aux={sorted(aux)} {thT.dtype}: "
          f"kernel {t_call:.4f} ms per call, {t_dev:.4f} ms per launch on the device "
          f"(CUDA graph of 20); plain {plain_txt} per call; bound {b_ms * 1e3:.3f} us "
          f"({b_by}); kernel at {100 * b_ms / t_call:.2f}% of the bound per call, "
          f"{100 * b_ms / t_dev:.2f}% per launch; for scale, torch.linalg.cholesky_ex "
          f"on the (C, N, N) covariances {t_chol:.4f} ms per call (medians, CUDA "
          f"events; {card})")
    return t_call, t_dev, t_p, b_ms, b_by


def variant_problems(dev, dtype=None):
    """The se_noise and warped_se_deriv models of the reference's
    test_evidence_pallas.py::_model_variants, data from a numpy seed
    (float64 unless ``dtype``)."""
    import torch

    from gptools_tpu_torch.models.dataset import DatasetBuilder
    from gptools_tpu_torch.models.gp import GPModel
    from gptools_tpu_torch.ops.kernels import (
        BetaWarp, DiagonalNoiseKernel, SquaredExponentialKernel, WarpedKernel,
    )

    rng = np.random.default_rng(SEED)
    dtype = dtype or torch.float64

    def data(lo, hi):
        b = DatasetBuilder(1)
        X = np.sort(rng.uniform(lo, hi, 7))
        b.add(X, np.sin(X), err_y=0.1)
        b.add(np.array([lo, hi]), np.zeros(2), err_y=0.05, n=1)
        return b.build(dtype, dev)

    def data48():  # N_MAX = 48 points: 46 values and 2 end slopes
        b = DatasetBuilder(1)
        X = np.sort(rng.uniform(0.0, 1.2, 46))
        b.add(X, np.sin(X), err_y=0.1)
        b.add(np.array([0.0, 1.2]), np.zeros(2), err_y=0.05, n=1)
        return b.build(dtype, dev)

    return [
        ("se_noise", GPModel(SquaredExponentialKernel(),
                             noise_kernel=DiagonalNoiseKernel(n=0)), data(0.0, 1.2)),
        ("warped_se_deriv", GPModel(WarpedKernel(SquaredExponentialKernel(), BetaWarp())),
         data(0.05, 0.95)),
        ("se_noise_n48", GPModel(SquaredExponentialKernel(),
                                 noise_kernel=DiagonalNoiseKernel(n=0)), data48()),
    ]


def golden_rule(config, th, ess):
    """z-scores and pass flag of scripts/f32_parity.py's rule for
    (chains, samples, P) samples against tests/golden_config<k>.json."""
    gold = golden(config)
    P = len(gold["mean"])
    flat = th.reshape(-1, P).double()
    m = flat.mean(0).cpu().numpy()
    s = flat.std(0).cpu().numpy()
    gm, gs, ge = (np.asarray(gold[k]) for k in ("mean", "std", "ess"))
    se = np.sqrt(s**2 / ess + gs**2 / ge)
    z = (m - gm) / se
    ok = bool(np.all(np.abs(z) <= 4.0)) and bool(
        np.all(np.abs(s - gs) <= 0.15 * gs + 4.0 * se)
    )
    return z, (s - gs) / gs, ok


def run_pipeline(config, dtype, dev, card, enforce_golden):
    """One config through smc_then_chees on the card; its evidence must go
    through its kernel alone (configs 4, 2, 3: launches > 0, no plain call,
    no route call), or through the route alone where the kernel does not
    apply (config 5: route calls > 0, no launch, no plain call). Returns
    that kernel's launch count (the route calls for config 5) and the
    draws, thetas (chains, samples, P)."""
    import torch

    from gptools_tpu_torch import configs
    from gptools_tpu_torch.infer.pipeline import smc_then_chees
    from gptools_tpu_torch.ops import evidence_cuda
    from gptools_tpu_torch.utils.diagnostics import ess_and_rhat

    tag = f"config{config} {str(dtype).replace('torch.', '')}"
    prob = configs.ALL_CONFIGS[config](dtype=dtype, device=dev)
    num_chains, num_warmup, num_samples, _ = PATHS[config]
    if dtype == torch.float32:
        num_samples = F32_SAMPLES.get(config, num_samples)
    kind = KIND_OF[config]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    evidence_cuda.reset_counts()
    t0 = time.perf_counter()
    res = smc_then_chees(
        prob.model, prob.data, gen, num_chains=num_chains,
        num_warmup=num_warmup, num_samples=num_samples, num_particles=1024,
        max_steps=256,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(evidence_cuda.LAUNCHES)
    plain_calls = sum(evidence_cuda.PLAIN_CALLS.values())
    routes = dict(evidence_cuda.ROUTE_CALLS)
    print(f"{tag}: evidence kernel launches {launches}, plain-version calls "
          f"{plain_calls}, route calls {routes}")
    if kind is None:
        if routes["chains_minor"] <= 0 or sum(launches.values()) or plain_calls:
            fail(f"{tag}: the evidence did not run through the chains-minor route alone")
        count = routes["chains_minor"]
    else:
        if launches[kind] <= 0 or plain_calls != 0 or sum(routes.values()):
            fail(f"{tag}: the main path did not run through the {kind} kernel alone")
        count = launches[kind]

    th = res.thetas
    P = prob.model.num_params
    if th.shape != (num_chains, num_samples, P) or not torch.isfinite(th).all():
        fail(f"{tag}: bad samples: shape {tuple(th.shape)}")
    ess, rhat = ess_and_rhat(th)
    divergences = int(res.diagnostics["divergences"])
    draws = num_chains * num_samples
    min_ess = float(ess.min())
    print(f"{tag}: smc_then_chees {num_chains} chains ({num_warmup}+"
          f"{num_samples}): wall {wall:.3f} s, min ESS {min_ess:.1f}, ESS/s "
          f"{min_ess / wall:.1f}, max R-hat {float(rhat.max()):.5f}, "
          f"divergences {divergences}/{draws}, leapfrogs "
          f"{int(res.diagnostics['num_leapfrog_total'])}, eps "
          f"{float(res.diagnostics['step_size']):.5f}, tau "
          f"{float(res.diagnostics['trajectory_time']):.4f}, SMC rounds "
          f"{res.diagnostics['smc_rounds']} ({card})")
    if not float(rhat.max()) <= RHAT_GATE:
        fail(f"{tag}: max R-hat {float(rhat.max())} > {RHAT_GATE}")
    if not divergences / draws <= DIVERGENCE_FRAC_GATE:
        fail(f"{tag}: divergence fraction {divergences / draws} > {DIVERGENCE_FRAC_GATE}")
    z, std_rel, ok = golden_rule(config, th, ess)
    verdict = ("ok" if ok else "FAIL") if enforce_golden else (
        "reported, not gated: float32 model, see phase 5")
    print(f"{tag}: golden rule z {np.round(z, 3).tolist()}, std rel err "
          f"{np.round(std_rel, 4).tolist()}, mean "
          f"{np.round(th.reshape(-1, P).double().mean(0).cpu().numpy(), 5).tolist()}"
          f" -> {verdict}")
    if enforce_golden and not ok:
        fail(f"{tag}: posterior moments disagree with tests/golden_config{config}.json")
    return count, th


LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")


def profiled(fn, reps):
    """Per call of ``fn`` over ``reps`` calls under ``torch.profiler``, as
    scripts/profile_torch_leapfrog.py counts them: {kernel name: self device
    us} and the kernel launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev, launches = {}, 0
    for a in prof.key_averages():
        if a.key in LAUNCH_CALLS:
            launches += a.count
        if str(getattr(a, "device_type", "")).endswith("CUDA"):
            t = getattr(a, "self_device_time_total", None)
            t = getattr(a, "self_cuda_time_total", 0.0) if t is None else t
            dev[a.key] = dev.get(a.key, 0.0) + t / reps
    return dev, launches / reps


def device_us(fn, name, reps=20):
    """Device microseconds per call of the kernels whose name holds
    ``name`` (the CUDA-event time of a call also holds its host overhead,
    which sets it at small shapes); None when the profiler saw none."""
    dev, _ = profiled(fn, reps)
    t = sum(v for k, v in dev.items() if name in k)
    return t if t > 0 else None


def wrapper_host_us(fn, calls=200):
    """Host microseconds per call of ``fn`` (the CPU clock around ``calls``
    calls, after a synchronize; the device may still be running)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return 1e6 * t


def cov_parity(kind, X, nid, thetas, card, time_plain_reps=30):
    """Covariance kernel vs its plain version on one (B, N) in float64 and
    float32: the error bound, exact symmetry of the whole matrix, the
    layout the launch took, CUDA-event medians per call, the device time
    per launch (torch.profiler, and a CUDA graph of 20 launches), the
    wrapper's host time per call, and the bound. The plain version runs in
    theta chunks of 32 for the comparison and whole for its time (at
    (256, 1024) in float64 its intermediates take some tens of GB; it fits
    the 80 GB card). Returns {dtype: (max_abs_err, ms, device_ms or None,
    plain_ms, bound_ms, bound_by)}."""
    import torch

    from gptools_tpu_torch.ops import cov_cuda

    B, n = thetas.shape[0], X.shape[0]
    pts = cov_cuda.points(X, nid)
    out = {}
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        th = thetas.to(dtype)
        K = cov_cuda.cov_cuda(kind, X, nid, th)
        torch.cuda.synchronize()
        err = kmax = 0.0
        for c in range(0, B, 32):
            Kp = cov_cuda.cov_plain(kind, X, nid, th[c:c + 32])
            err = max(err, float((K[c:c + 32] - Kp).abs().max()))
            kmax = max(kmax, float(Kp.abs().max()))
            del Kp
        sym = bool((K == K.mT).all())
        lay = cov_cuda.layout(n, B, dtype)
        tag = f"phase3b {kind} (B, N) = ({B}, {n}) {str(dtype).replace('torch.', '')}"
        print(f"{tag}: max |dK| / max |K| = {err / kmax:.3e} (tol {tol:g}), whole "
              f"matrix exactly symmetric: {sym}; layout {lay['layout']}: grid "
              f"{lay['grid_x']} x {lay['grid_yz']}, {lay['threads']} threads, "
              f"{lay['smem_bytes']} bytes of shared memory a block")
        if not err / kmax <= tol or not sym:
            fail(f"{tag}: kernel/plain disagree or K is not exactly symmetric")
        del K

        def call():  # as a GPModel calls it: the dataset's points made once
            return cov_cuda.cov_vjp(kind, pts, th)

        t_k = cuda_ms(call)
        t_p = cuda_ms(lambda: cov_cuda.cov_plain(kind, X, nid, th),
                      reps=time_plain_reps, warm=1)
        b_ms, b_by = cov_bound(kind, nid, B, th.element_size())
        dev_us = device_us(call, "cov_")
        dev_txt = "not measured" if dev_us is None else f"{dev_us:.3f} us"
        t_graph = graph_ms(call)
        host_us = wrapper_host_us(call)
        host_raw_us = wrapper_host_us(lambda: cov_cuda.cov_cuda(kind, X, nid, th))
        print(f"{tag}: kernel {t_k:.4f} ms per call (device time {dev_txt} per "
              f"launch by the profiler, {1e3 * t_graph:.3f} us by a CUDA graph of 20; "
              f"wrapper host time {host_us:.2f} us per call with the points made "
              f"once, {host_raw_us:.2f} us with them made each call (cov_cuda), "
              f"200 calls), plain "
              f"{t_p:.4f} ms, bound {b_ms * 1e3:.3f} us ({b_by}); kernel call at "
              f"{100 * b_ms / t_k:.2f}% of the bound"
              + ("" if dev_us is None else f", launch at {100e3 * b_ms / dev_us:.2f}%")
              + f" (median of 30, CUDA events; {card})")
        out[dtype] = (err, t_k, None if dev_us is None else 1e-3 * dev_us, t_p, b_ms, b_by)
        torch.cuda.empty_cache()
    return out


def serve(config, thetas, dev, card):
    """Phase 6 for one config: the pallas-backend predictors on phase 5's
    draws, gated on the covariance kernel's launches (config 3, which has
    no kind, on none), held to the fused backend. Returns the kernel's
    launch count."""
    import torch

    from gptools_tpu_torch import configs
    from gptools_tpu_torch.models.gp import GPModel
    from gptools_tpu_torch.models.serve import FrozenMCMCPredictor, FrozenPredictor
    from gptools_tpu_torch.ops import cov_cuda

    kind = COV_KIND_OF[config]
    prob = configs.ALL_CONFIGS[config](dtype=torch.float64, device=dev)
    draws = thetas.reshape(-1, prob.model.num_params).double()
    lo, hi = float(prob.data.Xf.min()), float(prob.data.Xf.max())
    grid = np.linspace(lo, hi, SERVE_POINTS)
    pm = prob.model
    models = {b: GPModel(pm.kernel, noise_kernel=pm.noise_kernel, mean=pm.mean, cov_backend=b)
              for b in ("pallas", "fused")}
    for model in models.values():  # one untimed build and request each (first-call costs)
        FrozenMCMCPredictor(model, prob.data, draws, max_samples=SERVE_MAX_SAMPLES)(grid)
    answers, times = {}, {}
    for backend, model in models.items():
        torch.cuda.synchronize()
        cov_cuda.reset_counts()
        builds = []
        for _ in range(SERVE_BUILDS):
            t0 = time.perf_counter()
            mcmc = FrozenMCMCPredictor(model, prob.data, draws, max_samples=SERVE_MAX_SAMPLES)
            point = FrozenPredictor(model, prob.data, draws.mean(0))
            torch.cuda.synchronize()
            builds.append(1e3 * (time.perf_counter() - t0))
        build_ms = float(np.median(builds))
        req_ms, outs = [], []
        for r in range(SERVE_REQUESTS):
            t0 = time.perf_counter()
            outs.append(mcmc(grid, n=r % 2) + point(grid, n=r % 2))
            torch.cuda.synchronize()
            req_ms.append(1e3 * (time.perf_counter() - t0))
        launches = dict(cov_cuda.LAUNCHES)
        plain_calls = sum(cov_cuda.PLAIN_CALLS.values())
        dev, n_launch = profiled(lambda: mcmc(grid, n=1), 3)
        top = sorted(dev.items(), key=lambda kv: -kv[1])[:3]
        print(f"phase6 config{config} {backend}: one MCMC request (n = 1) under the "
              f"profiler: device busy {1e-3 * sum(dev.values()):.3f} ms, "
              f"{n_launch:.0f} kernel launches; top kernels "
              f"{[(k[:60], round(1e-3 * v, 3)) for k, v in top]} (ms)")
        answers[backend] = outs
        times[backend] = (build_ms, float(np.median(req_ms)))
        print(f"phase6 config{config} {backend}: states of {mcmc.thetas.shape[0]} "
              f"posterior draws + the posterior mean built in {build_ms:.3f} ms "
              f"(median of {SERVE_BUILDS} builds); "
              f"{SERVE_REQUESTS} requests of {SERVE_POINTS} points (MCMC + point "
              f"predictor, n alternating 0/1): median {times[backend][1]:.3f} ms, "
              f"max {max(req_ms):.3f} ms; covariance-kernel launches {launches}, "
              f"plain-version calls {plain_calls} ({card})")
        if backend == "pallas":
            if kind is None:
                if sum(launches.values()) or plain_calls:
                    fail(f"config{config}: a kernel without a covariance kind launched "
                         f"the covariance kernel")
                pallas_launches = 0
            elif launches[kind] <= 0 or plain_calls != 0:
                fail(f"config{config}: the serving states did not go through the "
                     f"{kind} covariance kernel alone")
            else:
                pallas_launches = launches[kind]
    # |a - b| <= 1e-9 |b| + 1e-12 max|b| on every answer; worst ratio printed
    worst = 0.0
    for a_req, b_req in zip(answers["pallas"], answers["fused"]):
        for a, b in zip(a_req, b_req):
            if not bool(torch.isfinite(a).all()) or a.shape != (SERVE_POINTS,):
                fail(f"config{config}: bad answer shape {tuple(a.shape)} or non-finite")
            allowed = 1e-9 * b.abs() + 1e-12 * float(b.abs().max())
            worst = max(worst, float(((a - b).abs() / allowed).max()))
    print(f"phase6 config{config}: pallas vs fused answers, max |a - b| / (1e-9 |b| + "
          f"1e-12 max|b|) = {worst:.3e} (must be <= 1)")
    if not worst <= 1.0:
        fail(f"config{config}: pallas and fused serving answers disagree")
    if config == 4:
        mean, std = answers["pallas"][0][0], answers["pallas"][0][1]
        truth = configs._pedestal_profile(grid)
        inside = np.abs(mean.cpu().numpy() - truth) <= 2.0 * std.cpu().numpy()
        print(f"phase6 config4: {100 * inside.mean():.1f}% of the true profile lies "
              f"within +-2 predictive std of the MCMC predictor (reported, not gated)")
    return pallas_launches


def grad_call(model, data, thetas):
    """The batch evidence and its theta gradient (cotangent ones), as a
    sampler asks for them: (ll (C,), grad (C, P))."""
    import torch

    t = thetas.detach().clone().requires_grad_(True)
    ll = model.log_marginal_batch(t, data)
    (g,) = torch.autograd.grad(ll.sum(), t)
    return ll.detach(), g


def close(a, b, rtol, atol):
    """max(|a - b| - (atol + rtol |b|)), which must be <= 0."""
    return float(((a - b).abs() - (atol + rtol * b.abs())).max())


def route_phase(dev, card):
    """Phase 3c: the route on the card in float64. Config 4 at N = 62 (past
    N_MAX) takes the chains-minor route, with the CPU's numbers; the N = 48
    se_noise model takes the kernel under evidence_backend "auto" and
    "fused_pallas" and the route under "xla", with the kernel's numbers.
    Returns the route's ms per call at N = 62."""
    import torch

    from gptools_tpu_torch import configs
    from gptools_tpu_torch.models.gp import GPModel
    from gptools_tpu_torch.ops import evidence_cuda as ec

    big = configs.config4_gibbs_smc(n_points=ROUTE_N_POINTS, dtype=torch.float64, device=dev)
    cpu = configs.config4_gibbs_smc(n_points=ROUTE_N_POINTS, dtype=torch.float64,
                                    device="cpu")
    th = posterior_draws(4, ROUTE_C, torch.float64, dev, seed=62)
    ec.reset_counts()
    ll, g = grad_call(big.model, big.data, th)
    torch.cuda.synchronize()
    routes, launches = dict(ec.ROUTE_CALLS), dict(ec.LAUNCHES)
    plain = sum(ec.PLAIN_CALLS.values())
    llc, gc = (v.to(dev) for v in grad_call(cpu.model, cpu.data, th.cpu()))
    ll_m, g_m = close(ll, llc, 1e-9, 0.0), close(g, gc, 1e-9, 1e-9)
    t_route = cuda_ms(lambda: grad_call(big.model, big.data, th), reps=20)
    n = big.data.num_obs
    print(f"phase3c config4 N={n} C={ROUTE_C} f64: route calls {routes}, kernel launches "
          f"{launches}, plain calls {plain}; card vs CPU: ll max |d| - 1e-9|ll| = {ll_m:.3e}, "
          f"grad max |d| - (1e-9 + 1e-9|g|) = {g_m:.3e} (each must be <= 0); route "
          f"{t_route:.4f} ms per call (ll and gradient; median of 20, CUDA events; {card})")
    if (routes["chains_minor"] <= 0 or sum(launches.values()) or plain
            or not ll_m <= 0.0 or not g_m <= 0.0):
        fail(f"phase3c: config 4 at N = {n} did not take the route with the CPU's numbers")

    (_, m48, d48), = [v for v in variant_problems(dev) if v[0] == "se_noise_n48"]
    th48 = torch.tensor(np.random.default_rng(SEED).uniform(0.4, 1.2, (1023, m48.num_params)),
                        device=dev)
    outs, times = {}, {}
    for backend in ("auto", "fused_pallas", "xla"):
        m = GPModel(m48.kernel, noise_kernel=m48.noise_kernel, evidence_backend=backend)
        ec.reset_counts()
        outs[backend] = grad_call(m, d48, th48)
        torch.cuda.synchronize()
        launches, routes = dict(ec.LAUNCHES), dict(ec.ROUTE_CALLS)
        plain = sum(ec.PLAIN_CALLS.values())
        times[backend] = cuda_ms(lambda: grad_call(m, d48, th48), reps=20)
        want_kernel = backend != "xla"
        took = ("kernel" if launches["se"] == 1 and not sum(routes.values()) else
                "route" if routes["chains_minor"] == 1 and not sum(launches.values()) else
                "neither")
        print(f"phase3c se_noise_n48 C=1023 f64 evidence_backend={backend!r}: launches "
              f"{launches}, route calls {routes}, plain calls {plain} -> {took}; "
              f"{times[backend]:.4f} ms per call (ll and gradient; median of 20, CUDA "
              f"events; {card})")
        if plain or took != ("kernel" if want_kernel else "route"):
            fail(f"phase3c: evidence_backend {backend!r} took the wrong route")
    (llk, gk), (llr, gr) = outs["auto"], outs["xla"]
    ll_m, g_m = close(llr, llk, 1e-9, 0.0), close(gr, gk, 1e-7, 1e-9)
    print(f"phase3c se_noise_n48: route vs kernel ll max |d| - 1e-9|ll| = {ll_m:.3e}, grad "
          f"max |d| - (1e-9 + 1e-7|g|) = {g_m:.3e} (each must be <= 0); route "
          f"{times['xla']:.4f} ms against the kernel's {times['auto']:.4f} ms per call")
    if not ll_m <= 0.0 or not g_m <= 0.0:
        fail("phase3c: the route and the kernel disagree at N = 48")
    return t_route


def leapfrog_wall(config, dtype, dev, card, steps=50):
    """Host wall and device time per leapfrog step of a config's density
    at its pipeline's chains, on golden-typical points (identity mass,
    step 0.01), as scripts/profile_torch_leapfrog.py times configs 4, 2
    and 3."""
    import torch

    from gptools_tpu_torch import configs
    from gptools_tpu_torch.infer import chees, hmc

    prob = configs.ALL_CONFIGS[config](dtype=dtype, device=dev)
    model, data = prob.model, prob.data
    C = PATHS[config][0]
    q = model.u_of_theta(posterior_draws(config, C, dtype, dev, seed=11))
    vg = chees._value_and_grad(lambda u: model.log_posterior_u_batch(u, data))
    inv_mass = torch.ones(q.shape[1], dtype=dtype, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    p = torch.randn(q.shape, generator=gen, dtype=dtype, device=dev)
    eps = torch.tensor(0.01, dtype=dtype, device=dev)
    state = {}

    def step():
        state["q"], state["p"], _, state["g"] = hmc.leapfrog(
            vg, state["q"], state["p"], eps, inv_mass, grad=state["g"])

    with torch.no_grad():
        state.update(q=q, p=p, g=vg(q)[1])
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
        dev_us, n_launch = profiled(step, 10)
    busy_ms = 1e-3 * sum(dev_us.values())
    print(f"phase5 config{config} {str(dtype).replace('torch.', '')} C={C}: host wall "
          f"{wall_ms:.3f} ms per leapfrog ({steps} steps, no profiler); device busy "
          f"{busy_ms:.3f} ms per step ({100 * busy_ms / wall_ms:.1f}% of the wall), "
          f"{n_launch:.0f} kernel launches per step (torch.profiler, 10 steps; {card})")
    return wall_ms


def diagnostics_phase(th, names, card):
    """`summarize_samples` of float64 draws on the card and through its host
    path (the native library); gated on finite values and on the two paths
    agreeing within 1e-6 relative in ESS and R-hat."""
    import torch

    from gptools_tpu_torch.utils.diagnostics import summarize_samples

    out = {}
    for where, s in (("card", th), ("host", th.cpu())):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[where] = summarize_samples(s, param_names=names)
        out[where]["seconds"] = time.perf_counter() - t0
        row = {k: np.round(np.asarray(out[where][k], dtype=float), 5).tolist()
               for k in ("mean", "std", "q05", "q50", "q95", "ess", "rhat")}
        print(f"diagnostics {where}: summarize_samples of {tuple(th.shape)} "
              f"{str(th.dtype).replace('torch.', '')} draws in "
              f"{out[where]['seconds']:.3f} s: {row} ({card})")
    rel = {k: float(np.max(np.abs(out["card"][k] / out["host"][k] - 1.0)))
           for k in ("ess", "rhat", "mean", "std", "q50")}
    print(f"diagnostics: card vs host, largest relative difference {rel} (ESS and R-hat "
          f"must be <= 1e-6)")
    finite = all(np.isfinite(np.asarray(out[w][k], dtype=float)).all()
                 for w in out for k in ("mean", "std", "ess", "rhat"))
    if not finite or not rel["ess"] <= 1e-6 or not rel["rhat"] <= 1e-6:
        fail("diagnostics: card and host summaries disagree or are not finite")


def counted(tag, kind, fn, card):
    """``fn()`` with the evidence counts set to 0 just before and read just
    after: every density call must have been a launch of the ``kind``
    kernel (launches > 0, plain-version calls 0, route calls 0). Returns
    (result, wall seconds, launches)."""
    import torch

    from gptools_tpu_torch.ops import evidence_cuda as ec

    torch.cuda.synchronize()
    ec.reset_counts()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, routes = dict(ec.LAUNCHES), dict(ec.ROUTE_CALLS)
    plain = sum(ec.PLAIN_CALLS.values())
    n = launches[kind]
    print(f"phase7 {tag}: wall {wall:.3f} s; evidence kernel launches {launches}, "
          f"plain-version calls {plain}, route calls {routes}; host wall per density call "
          f"{1e3 * wall / max(n, 1):.3f} ms ({card})")
    if n <= 0 or plain or sum(routes.values()) or sum(launches.values()) != n:
        fail(f"phase7 {tag}: the density did not run through the {kind} kernel alone")
    return res, wall, n


def sampler_gates(tag, config, res, wall, card):
    """R-hat, divergences and the golden rule of a sampler's draws against
    tests/golden_config<config>.json (float64); for parallel tempering the
    draws and divergences are the cold rung's. Returns the min ESS."""
    from gptools_tpu_torch.utils.diagnostics import ess_and_rhat

    th = res.thetas
    if not bool(np.isfinite(th.cpu().numpy()).all()):
        fail(f"phase7 {tag}: non-finite draws")
    ess, rhat = ess_and_rhat(th)
    draws = th.shape[0] * th.shape[1]
    d = res.diagnostics
    div = int(d["divergences_by_rung"][0] if "divergences_by_rung" in d else d["divergences"])
    min_ess, max_rhat = float(ess.min()), float(rhat.max())
    z, std_rel, ok = golden_rule(config, th, ess)
    print(f"phase7 {tag}: {th.shape[0]} chains x {th.shape[1]} samples: min ESS "
          f"{min_ess:.1f}, min-ESS/s {min_ess / wall:.2f}, max R-hat {max_rhat:.5f}, "
          f"divergences {div}/{draws}; golden rule z {np.round(z, 3).tolist()}, std rel err "
          f"{np.round(std_rel, 4).tolist()} -> {'ok' if ok else 'FAIL'} ({card})")
    if not max_rhat <= RHAT_GATE:
        fail(f"phase7 {tag}: max R-hat {max_rhat} > {RHAT_GATE}")
    if not div / draws <= DIVERGENCE_FRAC_GATE:
        fail(f"phase7 {tag}: divergence fraction {div / draws} > {DIVERGENCE_FRAC_GATE}")
    if not ok:
        fail(f"phase7 {tag}: posterior moments disagree with tests/golden_config{config}.json")
    return min_ess


def per_transition(tag, res, launches, n_transitions):
    """Print a sampler's leapfrogs, density calls and host syncs per
    transition (each density call is one kernel launch over all rows)."""
    d = res.diagnostics
    C, S = res.u.shape[:2]
    extra = ""
    if "mean_tree_depth" in d:
        extra = (f", mean tree depth {float(d['mean_tree_depth']):.3f}, host syncs per "
                 f"transition {d['host_syncs'] / n_transitions:.2f}")
    leap = float(d["num_leapfrog_total"]) / (C * S) if "num_leapfrog_total" in d else None
    leap_txt = "" if leap is None else f"leapfrogs per transition and chain {leap:.2f} (sampling), "
    print(f"phase7 {tag}: {n_transitions} transitions: {leap_txt}density calls (launches) per "
          f"transition {launches / n_transitions:.2f}{extra}")


def map_phase(dev, card):
    """7a: config 1 through `GaussianProcess.optimize_hyperparameters`
    (9 starts, 200 L-BFGS steps) on the card, held to its golden; the same
    starts through `map_fit.minimize` on the CPU reach the card's optimum."""
    import torch

    from gptools_tpu_torch import configs
    from gptools_tpu_torch.infer import map_fit, model_logp
    from gptools_tpu_torch.models.gp import GaussianProcess

    prob = configs.config1_se_map(dtype=torch.float64, device=dev)
    gp = GaussianProcess(prob.model.kernel, device=dev)
    gp.add_data(prob.data.Xf[:, 0].cpu().numpy(), prob.data.y.cpu().numpy(),
                err_y=prob.data.err_y.cpu().numpy())
    res, wall, launches = counted("7a config1 MAP (optimize_hyperparameters, 8 random starts "
                                  "+ the current point, 200 L-BFGS steps, f64)", "se",
                                  lambda: gp.optimize_hyperparameters(random_starts=8), card)
    gold = golden(1)
    th_rel = float(np.max(np.abs(res.theta.cpu().numpy() / np.asarray(gold["theta"]) - 1.0)))
    lp, lp_g = float(res.log_posterior), gold["log_posterior"]
    print(f"phase7 7a: best theta {res.theta.cpu().numpy().tolist()} (golden {gold['theta']}), "
          f"max rel err {th_rel:.3e} (tol 1e-6); log posterior {lp!r} (golden {lp_g!r}), |d| "
          f"{abs(lp - lp_g):.3e} (tol {1e-8 + 1e-10 * abs(lp_g):.3e}); starts converged "
          f"{int(res.converged.sum())}/{res.converged.numel()}; density calls (launches) per "
          f"L-BFGS step {launches / 200:.2f}")
    if not th_rel <= 1e-6 or not abs(lp - lp_g) <= 1e-8 + 1e-10 * abs(lp_g):
        fail("phase7 7a: the MAP optimum disagrees with tests/golden_config1.json")
    if not torch.equal(gp.theta, res.theta):
        fail("phase7 7a: the wrapper was not left at the optimum")
    # the wrapper's default generator, seeded 0 on its device, gives its starts
    u0s = map_fit.start_points(gp.model, torch.Generator(device=dev).manual_seed(0), 8,
                               torch.float64, dev)
    cpu = configs.config1_se_map(dtype=torch.float64, device="cpu")
    t0 = time.perf_counter()
    us_cpu, lps_cpu, stats = map_fit.minimize(model_logp(cpu.model, cpu.data), u0s.cpu())
    t_cpu = time.perf_counter() - t0
    u_card = gp.model.u_of_theta(res.all_thetas).cpu()
    ok = res.converged.cpu() & torch.isfinite(lps_cpu)
    err = float((us_cpu - u_card)[ok].abs().max())
    print(f"phase7 7a: the same 9 starts through map_fit.minimize on the CPU ({t_cpu:.2f} s, "
          f"{stats['density_calls']} density calls, {stats['host_syncs']} host syncs): "
          f"{int(ok.sum())} converged on both, max |u_cpu - u_card| {err:.3e} (tol 1e-7)")
    if not int(ok.sum()) or not err <= 1e-7:
        fail("phase7 7a: the CPU and the card reach different optima from the same starts")
    return launches


def inference_phase(dev, card):
    """Phase 7: the reference's own inference routes in float64, each run
    with the evidence counts set to 0 just before and read just after.
    Returns {run: (kind, launches)}."""
    import torch

    from gptools_tpu_torch import configs
    from gptools_tpu_torch.infer import run_sampler
    from gptools_tpu_torch.infer.pipeline import smc_then_nuts

    out = {"7a": ("se", map_phase(dev, card))}

    def gen():
        return torch.Generator(device=dev).manual_seed(SEED)

    # 7b: config 2's NUTS, 8 chains, cut from its protocol's 500 + 1000 to
    # NUTS_CUT for the script's time
    p2 = configs.config2_se_deriv_nuts(dtype=torch.float64, device=dev)
    warm, samp = NUTS_CUT
    kw = dict(p2.sampler_kwargs, num_warmup=warm, num_samples=samp)
    res, wall, n = counted(
        f"7b config2 run_sampler nuts (8 chains, {warm} + {samp}: cut from the protocol's "
        f"500 + 1000, f64)", "se",
        lambda: run_sampler(p2.model, p2.data, gen(), sampler="nuts", **kw), card)
    per_transition("7b", res, n, kw["num_warmup"] + kw["num_samples"])
    sampler_gates("7b config2 nuts", 2, res, wall, card)
    out["7b"] = ("se", n)

    # 7c: config 3's HMC, 16 chains and 32 steps (the reference's defaults),
    # cut from its 500 + 800 to HMC_CUT for the wall
    p3 = configs.config3_matern_mean_warp_hmc(dtype=torch.float64, device=dev)
    warm, samp = HMC_CUT
    res, wall, n = counted(
        f"7c config3 run_sampler hmc (16 chains, num_steps 32, {warm} + {samp}: cut from the "
        f"protocol's 500 + 800, f64)", "matern52",
        lambda: run_sampler(p3.model, p3.data, gen(), sampler="hmc", num_chains=16,
                            num_warmup=warm, num_samples=samp, num_steps=32), card)
    per_transition("7c", res, n, warm + samp)
    sampler_gates("7c config3 hmc", 3, res, wall, card)
    out["7c"] = ("matern52", n)

    # 7d: config 4 through smc_then_nuts, whitened, cut from the pipeline's
    # 150 + 350 to SMC_NUTS_CUT for the script's time (phase 10 needs it)
    p4 = configs.config4_gibbs_smc(dtype=torch.float64, device=dev)
    warm, samp = SMC_NUTS_CUT
    res, wall, n = counted(
        f"7d config4 smc_then_nuts (whiten, 1024 chains, {warm} + {samp}: cut from the "
        f"pipeline's 150 + 350, max_depth 8, 1024 particles, f64)", "gibbs_tanh",
        lambda: smc_then_nuts(p4.model, p4.data, gen(), num_warmup=warm, num_samples=samp),
        card)
    per_transition("7d", res, n, warm + samp)
    print(f"phase7 7d: SMC rounds {res.diagnostics['smc_rounds']}")
    sampler_gates("7d config4 smc+nuts", 4, res, wall, card)
    out["7d"] = ("gibbs_tanh", n)

    # 7e: config 2 through replica exchange, 4 rungs x 16 chains
    warm, samp = PT_CUT
    res, wall, n = counted(
        f"7e config2 run_sampler pt (4 temperatures x 16 chains, {warm} + {samp}: cut from "
        f"200 + 400, num_steps 16, f64)",
        "se", lambda: run_sampler(p2.model, p2.data, gen(), sampler="pt", num_temps=4,
                                  num_chains=16, num_warmup=warm, num_samples=samp,
                                  num_steps=16), card)
    per_transition("7e", res, n, warm + samp)
    print(f"phase7 7e: divergences per rung "
          f"{res.diagnostics['divergences_by_rung'].cpu().numpy().tolist()}; swap acceptance "
          f"per rung pair "
          f"{np.round(res.diagnostics['swap_accept'].cpu().numpy(), 4).tolist()}, step sizes "
          f"{np.round(res.diagnostics['step_size'].cpu().numpy(), 5).tolist()}")
    sampler_gates("7e config2 pt (cold rung)", 2, res, wall, card)
    out["7e"] = ("se", n)

    # 7f: config 4 through mean-field ADVI (an approximation: the golden z
    # of q's mean is reported, not gated)
    res, wall, n = counted(
        "7f config4 run_sampler advi (mean-field, 1500 steps, 16 ELBO draws, f64)",
        "gibbs_tanh", lambda: run_sampler(p4.model, p4.data, gen(), sampler="advi",
                                          num_steps=1500, num_elbo_samples=16), card)
    elbo = res.diagnostics["elbo_trace"].cpu().numpy()
    first, last = float(elbo[:100].mean()), float(elbo[-100:].mean())
    gold = golden(4)
    z = (res.thetas[0].double().mean(0).cpu().numpy() - np.asarray(gold["mean"])) / np.asarray(
        gold["std"])
    print(f"phase7 7f: density calls (launches) per iteration {n / 1500:.3f}; ELBO mean of "
          f"the first 100 {first:.4f}, of the last 100 {last:.4f}, final "
          f"{float(elbo[-1]):.4f}; q's mean against the golden, in posterior stds, z "
          f"{np.round(z, 3).tolist()} (reported, not gated)")
    if not np.isfinite(elbo).all() or not last > first:
        fail("phase7 7f: the ELBO is not finite or did not rise")
    out["7f"] = ("gibbs_tanh", n)
    return out


def free_nu_model(dev):
    """8a's model: the free-nu Matern with the reference test's prior
    (tests/test_parity.py:241-246), nu on (1.05, 6) for slope data."""
    from gptools_tpu_torch.models.gp import GPModel
    from gptools_tpu_torch.ops.kernels import MaternGeneralKernel
    from gptools_tpu_torch.utils.priors import LogNormalJointPrior, UniformJointPrior

    prior = (LogNormalJointPrior([0.0], [0.75]) * UniformJointPrior([1.05], [6.0])
             * LogNormalJointPrior([-0.5], [0.75]))
    return GPModel(MaternGeneralKernel(hyperprior=prior))


def routed(tag, fn, card):
    """``fn()`` with every count of both CUDA kernels and of the route set
    to 0 just before and read just after: the per-chain route must have
    carried every density call (its calls > 0), with no launch of either
    kernel, no call of either plain version and no chains-minor call.
    Returns (result, wall seconds, per-chain route calls)."""
    import torch

    from gptools_tpu_torch.ops import cov_cuda as cc
    from gptools_tpu_torch.ops import evidence_cuda as ec

    torch.cuda.synchronize()
    ec.reset_counts()
    cc.reset_counts()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    routes = dict(ec.ROUTE_CALLS)
    launches = sum(ec.LAUNCHES.values()) + sum(cc.LAUNCHES.values())
    plain = sum(ec.PLAIN_CALLS.values()) + sum(cc.PLAIN_CALLS.values())
    print(f"phase8 {tag}: wall {wall:.3f} s; route calls {routes}, CUDA kernel launches "
          f"{launches}, plain-version calls {plain} ({card})")
    if routes["per_chain"] <= 0 or routes["chains_minor"] or launches or plain:
        fail(f"phase8 {tag}: the density did not run through the per-chain route alone")
    return res, wall, routes["per_chain"]


def vag(fn, x):
    """``fn(x)`` and its gradient in x (cotangent ones), as a sampler asks
    for them: (value (C,), gradient (C, P))."""
    import torch

    t = x.detach().clone().requires_grad_(True)
    v = fn(t)
    (g,) = torch.autograd.grad(v.sum(), t)
    return v.detach(), g


def card_vs_cpu(tag, fn_card, fn_cpu, x, card, reps=5, value_atol=1e-9):
    """Phase 8's parity: ``fn`` (a batched density) and its gradient at x on
    the card (through `routed`) and on the CPU: the value within 1e-9
    (relative) / ``value_atol`` (absolute; 8a's check holds it to 1e-9
    relative alone, 8c's lets a log likelihood that crosses zero carry
    the rounding of its terms), the gradient within 1e-7 (relative) / 1e-9
    (absolute); the ms per call (value and gradient) of each. Returns the
    card's ms and the per-chain route calls of one call."""
    import torch

    (v, g), _, calls = routed(f"{tag} (value and gradient)", lambda: vag(fn_card, x), card)
    t0 = time.perf_counter()
    vc, gc = vag(fn_cpu, x.cpu())
    t_cpu = 1e3 * (time.perf_counter() - t0)
    v_m = close(v, vc.to(v.device), 1e-9, value_atol)
    g_m = close(g, gc.to(g.device), 1e-7, 1e-9)
    t_card = cuda_ms(lambda: vag(fn_card, x), reps=reps, warm=1)
    print(f"phase8 {tag} C={x.shape[0]} f64: card vs CPU value max |d| - ({value_atol:g} + "
          f"1e-9|v|) = {v_m:.3e}, grad max |d| - (1e-9 + 1e-7|g|) = {g_m:.3e} (each must be "
          f"<= 0); "
          f"{t_card:.3f} ms per call on the card (value and gradient; median of {reps}, "
          f"CUDA events; {card}), {t_cpu:.1f} ms on the CPU")
    if not bool(torch.isfinite(v).all()) or not v_m <= 0.0 or not g_m <= 0.0:
        fail(f"phase8 {tag}: the card and the CPU disagree")
    return t_card, calls


def free_nu_phase(dev, card):
    """8a: the free-nu Matern on config 2's data under NUTS (`FREE_NU_RUN`),
    gated on R-hat, divergences and nu's spread and support; then 64 of
    its draws, card against CPU. Returns {name: (model, data, thetas)} for
    the launch count at the end of phase 8."""
    import torch

    from gptools_tpu_torch import configs
    from gptools_tpu_torch.infer import run_sampler
    from gptools_tpu_torch.utils.diagnostics import ess_and_rhat

    p2 = configs.config2_se_deriv_nuts(dtype=torch.float64, device=dev)
    cpu = configs.config2_se_deriv_nuts(dtype=torch.float64, device="cpu")
    model, model_cpu = free_nu_model(dev), free_nu_model("cpu")
    if model._evidence_plan(p2.data) is not None:
        fail("phase8 8a: the evidence kernel's plan took the free-nu Matern")
    chains, warm, samp = FREE_NU_RUN
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    res, wall, calls = routed(
        f"8a free-nu Matern, config 2's data, run_sampler nuts ({chains} chains, {warm} + "
        f"{samp}; the reference test's protocol is {FREE_NU_PROTOCOL[1]} + "
        f"{FREE_NU_PROTOCOL[2]}, f64)",
        lambda: run_sampler(model, p2.data, gen, sampler="nuts", num_chains=chains,
                            num_warmup=warm, num_samples=samp), card)
    peak = torch.cuda.max_memory_allocated() / 2**30
    th = res.thetas
    ess, rhat = ess_and_rhat(th)
    d = res.diagnostics
    draws = th.shape[0] * th.shape[1]
    div = int(d["divergences"])
    nu = th[..., 1].cpu().numpy()
    min_ess, max_rhat = float(ess.min()), float(rhat.max())
    leap = float(d["num_leapfrog_total"]) / draws
    print(f"phase8 8a: {th.shape[0]} chains x {th.shape[1]} samples: min ESS {min_ess:.1f}, "
          f"min-ESS/s {min_ess / wall:.3f}, max R-hat {max_rhat:.5f}, divergences "
          f"{div}/{draws}; nu mean {nu.mean():.4f} std {nu.std():.4f} range "
          f"[{nu.min():.4f}, {nu.max():.4f}]; {calls} density calls (per-chain route calls), "
          f"{calls / (warm + samp):.2f} a transition, leapfrogs per transition and chain "
          f"{leap:.2f} (sampling), mean tree depth {float(d['mean_tree_depth']):.3f}; host "
          f"wall per density call {1e3 * wall / calls:.2f} ms; peak device memory "
          f"{peak:.2f} GiB ({card})")
    if not bool(np.isfinite(th.cpu().numpy()).all()):
        fail("phase8 8a: non-finite draws")
    if not max_rhat <= RHAT_GATE:
        fail(f"phase8 8a: max R-hat {max_rhat} > {RHAT_GATE}")
    if not div / draws <= DIVERGENCE_FRAC_GATE:
        fail(f"phase8 8a: divergence fraction {div / draws} > {DIVERGENCE_FRAC_GATE}")
    if not nu.std() > 0.05 or not (nu.min() > 1.05 and nu.max() < 6.0):
        fail("phase8 8a: nu did not explore its support (std > 0.05, inside (1.05, 6))")
    flat = th.reshape(-1, th.shape[-1])
    th64 = flat[torch.linspace(0, flat.shape[0] - 1, 64, device=dev).long()]
    card_vs_cpu("8a free-nu Matern at 64 of its draws",
                lambda t: model.log_marginal_batch(t, p2.data),
                lambda t: model_cpu.log_marginal_batch(t, cpu.data), th64, card,
                value_atol=0.0)
    th8 = flat[:chains]
    graphed = route_graph_vs_eager("8a free-nu Matern", model, p2.data, th8, card)
    return {"8a free-nu Matern": (model, p2.data, th8, graphed)}


def route_graph_vs_eager(tag, model, data, th, card):
    """The per-chain route's value and gradient at th as the samplers run
    it on the card (a replayed CUDA graph) and eagerly (the graphs turned
    off): the same numbers within 1e-12 (relative; 1e-12 of the largest
    gradient entry absolute), and the ms per call of each. Returns the
    graph's ms."""
    from gptools_tpu_torch.models import gp as gp_mod

    def call():
        return vag(lambda t: model.log_marginal_batch(t, data), th)

    (v, g), t_graph = call(), cuda_ms(call, reps=10, warm=1)
    keep = gp_mod._PER_CHAIN_GRAPHS
    gp_mod._PER_CHAIN_GRAPHS = 0
    try:
        (ve, ge), t_eager = call(), cuda_ms(call, reps=3, warm=1)
    finally:
        gp_mod._PER_CHAIN_GRAPHS = keep
    dv = float(((v - ve).abs() / ve.abs()).max())
    dg = float(((g - ge).abs() / (ge.abs() + ge.abs().max())).max())
    print(f"phase8 {tag}: per density call (value and gradient, C = {th.shape[0]}) "
          f"{t_graph:.3f} ms as a CUDA graph (median of 10), {t_eager:.3f} ms eagerly (median "
          f"of 3; CUDA events; {card}); graph vs eager value max rel {dv:.3e}, gradient "
          f"{dg:.3e} (tol 1e-12)")
    if not dv <= 1e-12 or not dg <= 1e-12:
        fail(f"phase8 {tag}: the CUDA graph and the eager route disagree")
    return t_graph


def rq_se_kernel():
    """8b's kernel: an RQ + SE sum with log-normal and gamma priors."""
    from gptools_tpu_torch.ops.kernels import RationalQuadraticKernel, SquaredExponentialKernel
    from gptools_tpu_torch.utils.priors import GammaJointPrior, LogNormalJointPrior

    rq = RationalQuadraticKernel(hyperprior=LogNormalJointPrior([0.0], [0.75])
                                 * GammaJointPrior([2.0], [1.0])
                                 * LogNormalJointPrior([-0.5], [0.75]))
    se = SquaredExponentialKernel(hyperprior=LogNormalJointPrior([-1.0], [0.75])
                                  * LogNormalJointPrior([0.0], [0.75]))
    return rq + se


def rq_se_problem(dev, dtype):
    """`rq_se_kernel` on config 1's data: the per-chain route."""
    from gptools_tpu_torch import configs
    from gptools_tpu_torch.models.gp import GPModel

    return GPModel(rq_se_kernel()), configs.config1_se_map(dtype=dtype, device=dev).data


def zoo_map_phase(dev, card):
    """8b: the kernel algebra through MAP: an RQ + SE sum on config 1's
    data through `GaussianProcess.optimize_hyperparameters` on the card
    (8 random starts and the current point), then the same starts through
    `map_fit.minimize` on the CPU: the best start's log posterior within
    1e-9 (relative) and its u within 1e-6."""
    import torch

    from gptools_tpu_torch import configs
    from gptools_tpu_torch.infer import map_fit, model_logp
    from gptools_tpu_torch.models.gp import GaussianProcess

    prob = configs.config1_se_map(dtype=torch.float64, device=dev)
    gps = {}
    for where in (dev, "cpu"):
        gp = GaussianProcess(rq_se_kernel(), device=where)
        gp.add_data(prob.data.Xf[:, 0].cpu().numpy(), prob.data.y.cpu().numpy(),
                    err_y=prob.data.err_y.cpu().numpy())
        gps[str(where)] = gp
    gp, gp_cpu = gps[str(dev)], gps["cpu"]
    if gp.model._evidence_plan(gp.data) is not None:
        fail("phase8 8b: the evidence kernel's plan took the RQ + SE sum")
    res, wall, calls = routed(
        "8b RQ + SE on config 1's data, optimize_hyperparameters (8 random starts + the "
        "current point, 200 L-BFGS steps, f64)",
        lambda: gp.optimize_hyperparameters(random_starts=8), card)
    u0s = map_fit.start_points(gp.model, torch.Generator(device=dev).manual_seed(0), 8,
                               torch.float64, dev)
    t0 = time.perf_counter()
    us_cpu, lps_cpu, _ = map_fit.minimize(model_logp(gp_cpu.model, gp_cpu.data), u0s.cpu())
    t_cpu = time.perf_counter() - t0
    best = int(torch.argmax(torch.where(res.converged, res.all_log_posteriors, -np.inf)))
    lp, lp_cpu = float(res.all_log_posteriors[best]), float(lps_cpu[best])
    u_card = gp.model.u_of_theta(res.all_thetas[best]).cpu()
    du = float((us_cpu[best] - u_card).abs().max())
    print(f"phase8 8b: best start {best}, theta {res.theta.cpu().numpy().tolist()}, log "
          f"posterior {lp!r} (CPU from the same start {lp_cpu!r}, |d| / |lp| "
          f"{abs(lp - lp_cpu) / abs(lp):.3e}, tol 1e-9), max |u_cpu - u_card| {du:.3e} (tol "
          f"1e-6); {calls} density calls, {calls / 200:.2f} an L-BFGS step, host wall per "
          f"density call {1e3 * wall / calls:.2f} ms; the CPU run {t_cpu:.2f} s ({card})")
    if not abs(lp - lp_cpu) <= 1e-9 * abs(lp) or not du <= 1e-6:
        fail("phase8 8b: the card and the CPU reach different optima from the same starts")
    th9 = res.all_thetas
    graphed = route_graph_vs_eager("8b RQ + SE", gp.model, gp.data, th9, card)
    return {"8b RQ + SE": (gp.model, gp.data, th9, graphed)}


def grid_problem(device):
    """8c's 2-D problem: values on a 12 x 12 grid of [0, 1]^2 and the slope
    along x1 at the 12 points of the edge x1 = 0 (N = 156), under
    ``2 (SE(x1) RQ(x2)) + white noise`` (the noise through `SumKernel`'s
    delta terms)."""
    import torch

    from gptools_tpu_torch.models.dataset import DatasetBuilder
    from gptools_tpu_torch.models.gp import GPModel
    from gptools_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(SEED)
    g = np.linspace(0.0, 1.0, 12)
    x1, x2 = np.meshgrid(g, g, indexing="ij")
    X = np.stack([x1.ravel(), x2.ravel()], -1)
    y = np.sin(3.0 * X[:, 0]) * np.cos(2.0 * X[:, 1]) + 0.05 * rng.standard_normal(144)
    edge = np.stack([np.zeros(12), g], -1)
    b = DatasetBuilder(2)
    b.add(X, y, err_y=0.05)
    b.add(edge, 3.0 * np.cos(2.0 * g), err_y=0.1, n=[1, 0])
    kernel = (2.0 * (K.MaskedKernel(K.SquaredExponentialKernel(), 2, [0])
                     * K.MaskedKernel(K.RationalQuadraticKernel(), 2, [1]))
              + K.DiagonalNoiseKernel(2))
    return GPModel(kernel), b.build(torch.float64, device)


def zoo_parity_phase(dev, card):
    """8c: the other kernels, card against CPU, at `ZOO_C` prior-typical
    thetas (`GRID_C` for the 2-D grid): the Gauss, exp and interpolated
    Gibbs warps on config 4's data, the 2-D grid model, a chain-rule SE
    (which must also equal the SE) on config 2's data, and a Gibbs-Gauss
    model under a sorted-uniform prior, its u through the ordered
    bijector. Returns {name: (model, data, thetas)}."""
    import torch

    from gptools_tpu_torch import configs
    from gptools_tpu_torch.models.gp import GPModel
    from gptools_tpu_torch.ops import kernels as K
    from gptools_tpu_torch.utils import priors as PR

    rng = np.random.default_rng(SEED + 8)
    out = {}

    def u(lo, hi, C=ZOO_C):
        return rng.uniform(lo, hi, C)

    p4 = configs.config4_gibbs_smc(dtype=torch.float64, device=dev)
    p4c = configs.config4_gibbs_smc(dtype=torch.float64, device="cpu")
    xs = p4.data.Xf[:, 0].cpu().numpy()
    knots = np.linspace(xs.min(), xs.max(), 6)
    gibbs = {
        "GibbsKernel1dGauss": (lambda: K.GibbsKernel1dGauss(), [u(0.5, 1.5), u(0.2, 0.6),
                               u(0.02, 0.1), u(0.03, 0.15), u(0.9, 1.05)]),
        "GibbsKernel1dExp": (lambda: K.GibbsKernel1dExp(), [u(0.5, 1.5), u(0.05, 0.3),
                             u(0.5, 2.0)]),
        "GibbsKernel(InterpolatedWarp, 6 knots)": (
            lambda: K.GibbsKernel(K.InterpolatedWarp(knots)),
            [u(0.5, 1.5)] + [u(0.05, 0.5) for _ in knots]),
    }
    for name, (make, cols) in gibbs.items():
        m, mc = GPModel(make()), GPModel(make())
        th = torch.tensor(np.stack(cols, -1), dtype=torch.float64, device=dev)
        ms, _ = card_vs_cpu(f"8c {name}, config 4's data (N = {p4.data.num_obs})",
                            lambda t, m=m: m.log_marginal_batch(t, p4.data),
                            lambda t, mc=mc: mc.log_marginal_batch(t, p4c.data), th, card)
        out[f"8c {name}"] = (m, p4.data, th, ms)

    (mg, dg), (mgc, dgc) = grid_problem(dev), grid_problem("cpu")
    thg = torch.tensor(np.stack([u(0.5, 1.5, GRID_C), u(0.2, 0.6, GRID_C),
                                 u(0.5, 1.5, GRID_C), u(0.5, 3.0, GRID_C),
                                 u(0.2, 0.6, GRID_C), u(0.02, 0.2, GRID_C)], -1),
                       dtype=torch.float64, device=dev)
    ms, _ = card_vs_cpu(f"8c 2 (SE(x1) RQ(x2)) + noise, 12 x 12 grid + 12 slopes (N = "
                        f"{dg.num_obs})", lambda t: mg.log_marginal_batch(t, dg),
                        lambda t: mgc.log_marginal_batch(t, dgc), thg, card)
    out["8c 2-D grid"] = (mg, dg, thg, ms)

    def chain_rule_se():
        return K.ChainRuleKernel(
            lambda v, t: t[..., 0] ** 2 * torch.exp(v),
            lambda x1, x2, t: -0.5 * torch.sum((x1 - x2) ** 2, -1) / t[..., 1] ** 2,
            1, ("sigma_f", "l_1"))

    p2 = configs.config2_se_deriv_nuts(dtype=torch.float64, device=dev)
    p2c = configs.config2_se_deriv_nuts(dtype=torch.float64, device="cpu")
    mcr, mcrc = GPModel(chain_rule_se()), GPModel(chain_rule_se())
    thc = torch.tensor(np.stack([u(0.5, 1.5), u(0.3, 1.0)], -1), dtype=torch.float64,
                       device=dev)
    ms, _ = card_vs_cpu(f"8c ChainRuleKernel(exp, -r^2 / 2 l^2), config 2's data (N = "
                        f"{p2.data.num_obs})", lambda t: mcr.log_marginal_batch(t, p2.data),
                        lambda t: mcrc.log_marginal_batch(t, p2c.data), thc, card)
    # the SE through the route on the CPU, outside the counted section
    se = GPModel(K.SquaredExponentialKernel(), evidence_backend="xla")
    v_cr = mcr.log_marginal_batch(thc, p2.data).cpu()
    v_se = se.log_marginal_batch(thc.cpu(), p2c.data)
    d_se = close(v_cr, v_se, 1e-9, 0.0)
    print(f"phase8 8c: the chain-rule SE against the SE, max |d| - 1e-9|v| = {d_se:.3e} "
          "(must be <= 0)")
    if not d_se <= 0.0:
        fail("phase8 8c: ChainRuleKernel(exp, -r^2 / 2 l^2) differs from the SE")
    out["8c ChainRuleKernel"] = (mcr, p2.data, thc, ms)

    def sorted_model():
        prior = (PR.LogNormalJointPrior([0.0], [0.75]) * PR.SortedUniformJointPrior(2, 0.01, 1.0)
                 * PR.LogNormalJointPrior([-2.3], [0.6]) * PR.UniformJointPrior([0.6], [1.1]))
        return GPModel(K.GibbsKernel1dGauss(hyperprior=prior))

    ms, msc = sorted_model(), sorted_model()
    draws = ms.hyperprior.sample(torch.Generator(device=dev).manual_seed(SEED), (ZOO_C,),
                                 torch.float64)
    if not bool((draws[:, 2] > draws[:, 1]).all()):
        fail("phase8 8c: the sorted-uniform prior's draws are not sorted")
    us = ms.u_of_theta(draws)
    card_vs_cpu("8c GibbsKernel1dGauss under a SortedUniformJointPrior, log posterior in u "
                "(OrderedIntervalBijector)", lambda t: ms.log_posterior_u_batch(t, p4.data),
                lambda t: msc.log_posterior_u_batch(t, p4c.data), us, card)
    return out


def drop_graphs(models):
    """Free the per-chain route's CUDA graphs (and their memory pools) of
    the models of a finished part; the launch count below runs eagerly."""
    import torch

    for m, *_ in models.values():
        m.__dict__.pop("_route_graphs", None)
    torch.cuda.empty_cache()


def zoo_phase(dev, card):
    """Phase 8: 8a, 8b and 8c; returns their models for
    `zoo_launch_counts`."""
    models = {}
    walls = []
    for part in (free_nu_phase, zoo_map_phase, zoo_parity_phase):
        t0 = time.perf_counter()
        done_part = part(dev, card)
        drop_graphs(done_part)
        models.update(done_part)
        walls.append(time.perf_counter() - t0)
    t_a, t_b, t_c = walls
    print(f"phase8 walls: 8a {t_a:.1f} s, 8b {t_b:.1f} s, 8c {t_c:.1f} s")
    return models


def zoo_launch_counts(models):
    """Phase 8's last part, run after phase 10 (its torch.profiler session
    slows every later launch of the process on the host): the CUDA launches
    of one eager density call of each of phase 8's models."""
    from gptools_tpu_torch.models import gp as gp_mod

    # launches of one eager call of each model (a graph replay is one
    # launch of them all)
    keep = gp_mod._PER_CHAIN_GRAPHS
    gp_mod._PER_CHAIN_GRAPHS = 0
    try:
        for name, (m, data, th, ms) in models.items():
            _, launches = profiled(lambda: vag(lambda t: m.log_marginal_batch(t, data), th), 1)
            print(f"phase8 {name}: {launches:.0f} CUDA kernel launches per density call "
                  f"eagerly (value and gradient, C = {th.shape[0]}; torch.profiler); "
                  f"{ms:.3f} ms per call as a CUDA graph")
    finally:
        gp_mod._PER_CHAIN_GRAPHS = keep


def mesh_run(tag, config, chains, warmup, samples, dev, mesh):
    """One config through ``smc_then_chees`` (1024 particles, max_steps
    256, float64, seed `SEED`) with or without a mesh, the evidence and
    collective counts set to 0 just before and read just after. Returns
    (result, wall seconds, launches, plain-version calls, route calls,
    collectives)."""
    import torch

    from gptools_tpu_torch import configs
    from gptools_tpu_torch.infer.pipeline import smc_then_chees
    from gptools_tpu_torch.ops import evidence_cuda as ec
    from gptools_tpu_torch.parallel import mesh as pmesh

    prob = configs.ALL_CONFIGS[config](dtype=torch.float64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    ec.reset_counts()
    pmesh.reset_counts()
    t0 = time.perf_counter()
    res = smc_then_chees(prob.model, prob.data, gen, num_chains=chains, num_warmup=warmup,
                         num_samples=samples, num_particles=1024, max_steps=256, mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sum(ec.LAUNCHES.values())
    plain, routes = sum(ec.PLAIN_CALLS.values()), sum(ec.ROUTE_CALLS.values())
    coll = dict(pmesh.COLLECTIVE_CALLS)
    calls = launches or routes
    print(f"phase9 {tag}: wall {wall:.3f} s; evidence kernel launches {launches}, "
          f"plain-version calls {plain}, route calls {routes}, collectives {coll}; host wall "
          f"per density call {1e3 * wall / max(calls, 1):.3f} ms; SMC rounds "
          f"{res.diagnostics['smc_rounds']}, leapfrogs "
          f"{int(res.diagnostics['num_leapfrog_total'])}")
    return res, wall, launches, plain, routes, coll


def max_diff(a, b, tag):
    """max |a - b| of two draws stacks of one shape (raises otherwise)."""
    if a.shape != b.shape:
        fail(f"phase9 {tag}: shapes {tuple(a.shape)} and {tuple(b.shape)}")
    return float((a.to(b.device) - b).abs().max())


def width_models(dev, dtype):
    """9d's models and the path each density takes: config 3 (the evidence
    kernel with aux mu and w), warped_se_deriv (w and wp), se_noise (nd),
    config 5 (the chains-minor route), config 2 (the kernel with no aux
    channel: the control) and RQ + SE on config 1's data (the per-chain
    route)."""
    from gptools_tpu_torch import configs

    variants = {tag: (m, d) for tag, m, d in variant_problems(dev, dtype)}
    out = []
    for tag in ("config3", "warped_se_deriv", "se_noise", "config5", "config2"):
        if tag.startswith("config"):
            prob = configs.ALL_CONFIGS[int(tag[-1])](dtype=dtype, device=dev)
            model, data = prob.model, prob.data
        else:
            model, data = variants[tag]
        out.append((tag, model, data, "chains_minor" if tag == "config5" else "kernel"))
    model, data = rq_se_problem(dev, dtype)
    out.append(("rq_se", model, data, "per_chain"))
    return out


def width_diffs(model, data, u, splits):
    """``log_posterior_u_batch``'s value and gradient on all chains u (C, P)
    in one call against the same chains in blocks, a call each: per split,
    (largest value difference, largest gradient difference, both bitwise
    equal)."""
    import torch

    def vg(x):
        x = x.clone().requires_grad_(True)
        v = model.log_posterior_u_batch(x, data)
        (g,) = torch.autograd.grad(v.sum(), x)
        return v.detach(), g

    def diff(a, b):
        return float(torch.where(a == b, 0.0, a - b).abs().max())

    v, g = vg(u)
    out = {}
    for split in splits:
        parts = [vg(b) for b in u.split(list(split))]
        vb, gb = torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
        out[split] = (diff(vb, v), diff(gb, g), torch.equal(vb, v) and torch.equal(gb, g))
    return out


def width_phase(dev, card):
    """9d: for each model of `width_models`, in float64 and float32, the
    value and gradient of ``log_posterior_u_batch`` at `WIDTH_C` chains
    (u from a numpy seed) against the same chains in the blocks of each
    of `WIDTH_SPLITS`; each must be the same bits, and the density must
    take its path (the kernel: launches > 0, no plain or route call; the
    route: route calls > 0, no launch). Returns the kernel's launches by
    kind."""
    import torch

    from gptools_tpu_torch.ops import evidence_cuda as ec

    launches, bad = {}, []
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).replace("torch.", "")
        for tag, model, data, path in width_models(dev, dtype):
            rng = np.random.default_rng(SEED)
            u = torch.as_tensor(0.4 * rng.standard_normal((WIDTH_C, model.num_free_params)),
                                dtype=dtype, device=dev)
            torch.cuda.synchronize()
            ec.reset_counts()
            diffs = width_diffs(model, data, u, WIDTH_SPLITS)
            torch.cuda.synchronize()
            n, plain = dict(ec.LAUNCHES), sum(ec.PLAIN_CALLS.values())
            routes = dict(ec.ROUTE_CALLS)
            for split, (dv, dg, same) in diffs.items():
                print(f"phase9 9d {tag} {dname} C={WIDTH_C} against blocks "
                      f"{'+'.join(map(str, split))}: largest value difference {dv:.3e}, "
                      f"gradient {dg:.3e} ({card})")
                if not same:
                    bad.append(f"{tag} {dname} blocks {split}: value {dv}, gradient {dg}")
            print(f"phase9 9d {tag} {dname}: evidence kernel launches {n}, plain-version "
                  f"calls {plain}, route calls {routes}")
            took = sum(n.values())
            if not ((took > 0 and not any(routes.values())) if path == "kernel" else
                    (routes[path] > 0 and took == 0)) or plain:
                fail(f"phase9 9d {tag} {dname}: launches {n}, plain {plain}, routes {routes}")
            for k, c in n.items():
                launches[k] = launches.get(k, 0) + c
    if bad:
        fail("phase9 9d: a chain's bits depend on its batch: " + "; ".join(bad))
    return launches


def mesh_phase(dev, card):
    """Phase 9: the chains sharded over a mesh (`parallel.mesh`), float64,
    each sharded run against the unsharded run from the same seed (draws
    within `MESH_TOL`): (9a) config 4 at world size 1 on NCCL through
    ``smc_then_chees(mesh=make_mesh())`` (the evidence kernel's launches
    > 0, no plain call, no route call, collectives > 0; the walls and the
    host wall per density call); (9c) config 5 through the route at world
    size 1; 9a and 9c each unsharded, sharded, sharded, unsharded; (9b)
    config 4 at 2048 chains on two ranks sharing the card (gloo,
    `scripts/torch_mp_worker.py`), each rank's launches at C = 1024 (its
    half) and never at 2048, and config 5's route at 9c's chains, half a
    rank, against one unsharded call; (9d) `width_phase`; (9e) config 3
    (the kernel with aux mu and w) at 1024 chains, SMC + 25 + 25, on two
    ranks sharing the card, each rank's launches at C = 512, against one
    process's unsharded run. Returns the kernel's launches by kind (9a's
    two sharded runs, both ranks of 9b and of 9e, and 9d's)."""
    import importlib.util
    import tempfile

    import torch
    import torch.distributed as dist

    from gptools_tpu_torch import configs
    from gptools_tpu_torch.parallel import make_mesh

    t_start = time.perf_counter()
    mesh = make_mesh()
    print(f"phase9 mesh: {mesh} on backend {dist.get_backend()}")

    # 9a and 9c at world size 1 on NCCL, each run four times in the order
    # unsharded, sharded, sharded, unsharded, so that neither side inherits
    # the other's warm caches alone; every draw against the first run's
    launches = {"gibbs_tanh": 0, "se": 0, "matern52": 0}
    for part, config in (("9a", 4), ("9c", 5)):
        chains, warm, samp = MESH_RUNS[part]
        tag = (f"{part} config{config} smc_then_chees ({chains} chains, {warm} + {samp}, "
               f"f64{', the route' if config == 5 else ''})")
        runs = [mesh_run(f"{tag} {'mesh=make_mesh()' if m else 'unsharded'} (run {i + 1})",
                         config, chains, warm, samp, dev, mesh if m else None)
                for i, m in enumerate((False, True, True, False))]
        ref = runs[0][0]
        d = max(max_diff(r[0].thetas, ref.thetas, part) for r in runs[1:])
        w0, w1 = (runs[0][1], runs[3][1]), (runs[1][1], runs[2][1])
        print(f"phase9 {part}: sharded walls {w1[0]:.3f}, {w1[1]:.3f} s against unsharded "
              f"{w0[0]:.3f}, {w0[1]:.3f} s (mean {sum(w1) / sum(w0):.3f}x; runs 1 and 2 "
              f"{w1[0] / w0[0]:.3f}x, 3 and 4 {w1[1] / w0[1]:.3f}x); largest draw difference "
              f"{d:.3e} ({card})")
        for _, _, n, plain, routes, coll in runs[1:3]:
            ok = (n > 0 and routes == 0) if config == 4 else (routes > 0 and n == 0)
            if not (d <= MESH_TOL and ok and plain == 0 and coll["density"] > 0):
                fail(f"phase9 {part}: difference {d}, launches {n}, plain {plain}, routes "
                     f"{routes}, collectives {coll}")
            launches["gibbs_tanh"] += n
    dist.destroy_process_group()

    # 9b: config 4 at 2048 chains on two ranks sharing the card (gloo)
    chains, warm, samp = MESH_RUNS["9b"]
    tag = f"9b config4 smc_then_chees ({chains} chains, {warm} + {samp}, f64)"
    ref, wall0, *_ = mesh_run(tag + " unsharded, one process", 4, chains, warm, samp, dev,
                              None)
    # and config 5's route at 9c's chains, half a rank: its value and
    # gradient unsharded here, from the workers' seed
    spec = importlib.util.spec_from_file_location(
        "torch_mp_worker", os.path.join(ROOT, "scripts", "torch_mp_worker.py"))
    worker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(worker)
    route_c = MESH_RUNS["9c"][0]
    route_ll, route_grad, _ = worker.route_check(
        configs.ALL_CONFIGS[5](dtype=torch.float64, device=dev),
        torch.Generator(device=dev).manual_seed(SEED + 3), route_c)
    with tempfile.TemporaryDirectory() as out:
        wall, ranks = two_ranks("9b", [
            "--config", "4", "--chains", str(chains), "--particles", "1024", "--warmup",
            str(warm), "--samples", str(samp), "--route-chains", str(route_c)], dev, out)
    for r, (rep, got) in enumerate(ranks):
        d = max_diff(got["thetas"], ref.thetas, "9b")
        d5 = max(max_diff(got["route_ll"], route_ll, "9b route"),
                 max_diff(got["route_grad"], route_grad, "9b route"))
        print(f"phase9 9b rank {r}: pipeline {rep['pipeline_s']:.3f} s; evidence kernel "
              f"launches {rep['launches']} at C {rep['kernel_chains']}, plain-version "
              f"calls {rep['plain']}, route calls {rep['route']}, collectives "
              f"{rep['collectives']}; largest draw difference {d:.3e}; config 5's route "
              f"at {route_c // 2} thetas a rank ({rep['route_check_calls']} call) against "
              f"{route_c} in one call: largest ll and gradient difference {d5:.3e} ({card})")
        if not (d <= MESH_TOL and rep["launches"] > 0 and rep["plain"] == 0
                and rep["route"] == 0 and max(rep["kernel_chains"]) == chains // 2
                and chains // 2 in rep["kernel_chains"] and d5 <= MESH_TOL
                and rep["route_check_calls"] == 1):
            fail(f"phase9 9b rank {r}: {rep}, difference {d}, route difference {d5}")
        launches["gibbs_tanh"] += rep["launches"]
    print(f"phase9 9b: two ranks {wall:.3f} s from start to exit (processes, imports and "
          f"the library's load included); unsharded in this process {wall0:.3f} s")

    # 9d: each chain's bits in every block of a batch, in this process
    for k, n in width_phase(dev, card).items():
        launches[k] += n

    # 9e: config 3 (the kernel with aux mu and w) on two ranks sharing the card
    chains, warm, samp = MESH_RUNS["9e"]
    tag = f"9e config3 smc_then_chees ({chains} chains, {warm} + {samp}, f64)"
    ref, wall0, *_ = mesh_run(tag + " unsharded, one process", 3, chains, warm, samp, dev,
                              None)
    with tempfile.TemporaryDirectory() as out:
        wall, ranks = two_ranks("9e", [
            "--config", "3", "--chains", str(chains), "--particles", "1024", "--warmup",
            str(warm), "--samples", str(samp)], dev, out)
    for r, (rep, got) in enumerate(ranks):
        d = max_diff(got["thetas"], ref.thetas, "9e")
        print(f"phase9 9e rank {r}: pipeline {rep['pipeline_s']:.3f} s; evidence kernel "
              f"launches {rep['launches']} at C {rep['kernel_chains']}, plain-version "
              f"calls {rep['plain']}, route calls {rep['route']}, collectives "
              f"{rep['collectives']}; largest draw difference {d:.3e} ({card})")
        if not (d <= MESH_TOL and rep["launches"] > 0 and rep["plain"] == 0
                and rep["route"] == 0 and rep["kernel_chains"] == [chains // 2]):
            fail(f"phase9 9e rank {r}: {rep}, difference {d}")
        launches["matern52"] += rep["launches"]
    print(f"phase9 9e: two ranks {wall:.3f} s from start to exit; unsharded in this "
          f"process {wall0:.3f} s")
    print(f"phase9 walls: {time.perf_counter() - t_start:.1f} s")
    return launches


def two_ranks(tag, args, dev, out):
    """Two ranks of `scripts/torch_mp_worker.py` sharing the card (gloo on
    127.0.0.1), seed `SEED`, each with ``args`` and its results in
    ``out``: (wall seconds from start to exit, [(report, saved tensors)] a
    rank)."""
    import socket

    import torch

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        env.pop(k, None)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "scripts", "torch_mp_worker.py"), "--rank",
         str(r), "--world", "2", "--port", str(port), "--device", dev.type, "--seed",
         str(SEED), "--out", out, *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=MESH_WORKER_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        fail(f"phase9 {tag}: the two ranks timed out")
    wall = time.perf_counter() - t0
    ranks = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0 or "MESH_WORKER " not in log:
            fail(f"phase9 {tag}: rank {r} exited {p.returncode}:\n{log[-4000:]}")
        ranks.append((json.loads(log.split("MESH_WORKER ", 1)[1].splitlines()[0]),
                      torch.load(os.path.join(out, f"rank{r}.pt"))))
    return wall, ranks


def example_run(tag, kind, fn, card):
    """``fn()`` (an example's ``main``) with the evidence counts set to 0
    just before and read just after, its output captured and echoed; gates
    the ``kind`` kernel's launches > 0 and no plain-version call. Returns
    (result, output, launches)."""
    import contextlib
    import io

    import torch

    from gptools_tpu_torch.ops import evidence_cuda as ec

    torch.cuda.synchronize()
    ec.reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"phase10 {tag} | {line}")
    launches, routes = dict(ec.LAUNCHES), dict(ec.ROUTE_CALLS)
    plain = dict(ec.PLAIN_CALLS)
    n = sum(launches.values())
    print(f"phase10 {tag}: wall {wall:.3f} s; evidence kernel launches {launches}, "
          f"plain-version calls {plain}, route calls {routes}; host wall per density call "
          f"{1e3 * wall / max(n, 1):.3f} ms ({card})")
    if launches[kind] <= 0 or sum(plain.values()):
        fail(f"phase10 {tag}: the {kind} kernel was not launched, or a plain version ran")
    return res, out, launches


def _theta_lines(out):
    return [ln for ln in out.splitlines() if ln.startswith("   MAP log posterior")
            or re.match(r"^\s+k\.\S+ = \S+$", ln)]


def examples_phase(dev, card):
    """Phase 10: the reference's entry points (`gptools_tpu_torch.examples`)
    on the card, float64, each ``main(argv)`` called in this process with
    the evidence counts set to 0 around it, then ``run_config 1`` as its
    own process. Returns {run: launches by kind}."""
    import torch

    from gptools_tpu_torch.examples import multimodal_pt, run_config
    from gptools_tpu_torch.examples import sine_derivative_constraint as sine
    from gptools_tpu_torch.utils.diagnostics import split_rhat

    t_start = time.perf_counter()
    out = {}

    # 10a: config 1's MAP (9 starts, 200 L-BFGS steps) against its golden
    res, text_a, out["10a"] = example_run("10a run_config 1", "se",
                                          lambda: run_config.main(["1"]), card)
    gold = golden(1)
    rel = float(np.max(np.abs(res.theta.cpu().numpy() / np.asarray(gold["theta"]) - 1.0)))
    print(f"phase10 10a: theta {res.theta.cpu().numpy().tolist()} (golden {gold['theta']}), "
          f"max rel err {rel:.3e} (tol 1e-6)")
    if not rel <= 1e-6:
        fail("phase10 10a: run_config 1's theta disagrees with tests/golden_config1.json")

    # 10b: config 4 through SMC (2048 particles, 8 mutations, uncut)
    res, text, out["10b"] = example_run("10b run_config 4", "gibbs_tanh",
                                        lambda: run_config.main(["4"]), card)
    gold = golden(4)
    rows = [re.match(_PARAM_LINE, ln) for ln in text.splitlines()]
    rows = {m.group(1): m for m in rows if m}
    means = np.array([float(rows[n].group(2)) if n in rows else np.nan
                      for n in gold["params"]])
    z = (means - np.asarray(gold["mean"])) / np.asarray(gold["std"])
    print(f"phase10 10b: printed means {means.tolist()}, golden {gold['mean']}, in "
          f"posterior stds z {np.round(z, 3).tolist()} (gate |z| <= {MEAN_GATE_STDS})")
    if not np.isfinite(means).all() or not np.all(np.abs(z) <= MEAN_GATE_STDS):
        fail("phase10 10b: run_config 4's means are not finite or not at the golden's")

    # 10c: the sine example (MAP, NUTS 8 chains 300 + 500, the slope at x = 1)
    res, text, out["10c"] = example_run("10c sine_derivative_constraint", "se",
                                        lambda: sine.main([]), card)
    rhat = float(split_rhat(res["posterior"].thetas).max())
    slope, sd, true = res["slope"], res["slope_std"], 2 * np.cos(2.0)
    print(f"phase10 10c: NUTS max split R-hat {rhat:.4f} (gate {RHAT_GATE}); slope at x = 1 "
          f"{slope:.4f} +- {sd:.4f}, true {true:.4f}, |d| / std "
          f"{abs(slope - true) / sd:.3f} (gate {SLOPE_GATE_STDS})")
    if not rhat <= RHAT_GATE or not abs(slope - true) <= SLOPE_GATE_STDS * sd:
        fail("phase10 10c: the sine example's NUTS R-hat or slope fails its gate")

    # 10e, the module entry from a clean process, runs beside 10d (its own
    # process and context on the card; it would add ~20 s of wall alone)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "gptools_tpu_torch.examples.run_config", "1"],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        # 10d: multimodal_pt, NUTS / PT / SMC+ChEES at 16 chains
        warm, samp = (str(v) for v in MULTIMODAL_CUT)
        res, text, out["10d"] = example_run(
            f"10d multimodal_pt --warmup {warm} --samples {samp} (10e beside it)", "gibbs_tanh",
            lambda: multimodal_pt.main(["--warmup", warm, "--samples", samp]), card)
        finite = all(bool(torch.isfinite(r.thetas).all()) for r in res.values())
        means = re.findall(r"mean\s+(\S+)\s+sd\s+(\S+)\s+R-hat (\S+)", text)
        finite = finite and len(means) == 15 and all(np.isfinite(float(v)) for m in means
                                                     for v in m)
        swap = res["pt"].diagnostics["swap_accept"].cpu().numpy()
        print(f"phase10 10d: PT swap acceptance per rung pair {np.round(swap, 4).tolist()}; "
              f"summaries finite: {finite}")
        if not finite or swap.shape != (5,) or not np.isfinite(swap).all():
            fail("phase10 10d: non-finite summaries or no swap acceptance per rung pair")
        stdout, stderr = proc.communicate(timeout=EXAMPLE_SUBPROCESS_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    same = _theta_lines(stdout) == _theta_lines(text_a) != []
    print(f"phase10 10e: python -m gptools_tpu_torch.examples.run_config 1: exit "
          f"{proc.returncode}, done {time.perf_counter() - t0:.3f} s after its start (beside "
          f"10d, which it waited for); theta lines {_theta_lines(stdout)}, the same as 10a's: "
          f"{same}")
    if proc.returncode != 0 or not same:
        print(stderr[-4000:], file=sys.stderr)
        fail("phase10 10e: the module entry failed or printed another optimum")
    print(f"phase10 walls: {time.perf_counter() - t_start:.1f} s")
    return out


KIND_IDS = {"0": "gibbs_tanh", "1": "se", "2": "matern52"}


def ptxas_report(log):
    """{evidence or covariance instantiation: (registers, stack frame, spill
    stores, spill loads, static smem bytes)} from the ``-Xptxas -v`` log."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"(evidence_kernel|cov_small_kernel|cov_band_kernel|cov_tile_kernel)"
                          r"I([fd])Li(\d)E",
                          m.group(1))
            name = (f"{k.group(1)}<{'float' if k.group(2) == 'f' else 'double'}, "
                    f"{KIND_IDS[k.group(3)]}>") if k else None
            if name:
                out[name] = [None] * 5
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name][1:4] = [int(v) for v in m.groups()]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name][0] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[name][4] = int(sm.group(1)) if sm else 0
    return out


def evidence_smem(n, item):
    """Bytes of dynamic shared memory of one evidence block (4 chains) at n
    points and `item` bytes an element, as `smem_bytes` in
    csrc/evidence_kernel.cu sizes its launch (`const_bytes`, and
    `chain_elems` of csrc/evidence_chain.cuh, float2/double2 vectors)."""
    def vec(k):
        return (k + 1) // 2 * 2

    nv = vec(n)
    ld = (nv // 2 | 1) * 2
    elems = 2 * n * ld + 12 * nv + vec(5 * 32 + 2 * 5 + 1)  # P_MAX = 5, LANES = 32
    return (n * (3 * 8 + 4) + n * (n + 1) + 15) // 16 * 16 + 4 * elems * item


def build_phase():
    """Phase 2: build both kernels; print the compiler's report and, per
    evidence instantiation, its registers, stack frame and spills (none
    allowed), and the dynamic shared memory of a block at the configs' N."""
    from gptools_tpu_torch.ops import evidence_cuda

    so = evidence_cuda.build()
    info = evidence_cuda.BUILD_INFO
    print(f"phase2 build: {'cached' if info.get('cached') else 'nvcc'} "
          f"{info.get('seconds', 0.0):.3f} s -> {so}")
    if info.get("cmd"):
        print(f"phase2 cmd: {info['cmd']}")
    log = info.get("log", "")
    for line in log.splitlines():
        if ("registers" in line or "stack frame" in line or "Compiling" in line
                or "smem" in line):
            print(f"phase2 ptxas: {line.strip()}")
    report = ptxas_report(log)
    # evidence: 3 kinds x 2 dtypes; covariance: 3 layouts x 2 kinds x 2 dtypes
    if not info.get("cached") and len(report) != 2 * len(evidence_cuda.KINDS) + 12:
        fail(f"ptxas report lists {sorted(report)}, not every kernel instantiation")
    for name, (regs, frame, st, ld, smem) in sorted(report.items()):
        item = 8 if "double" in name else 4
        extra = ""
        if name.startswith("evidence"):
            dyn = {n: evidence_smem(n, item) for n in (27, 32, 35, evidence_cuda.N_MAX)}
            extra = (f"; dynamic smem per block of 4 chains (bytes) at N = 27/32/35/48: "
                     f"{[dyn[n] for n in sorted(dyn)]}")
        print(f"phase2 {name}: {regs} registers, {frame} bytes stack frame, {st} bytes "
              f"spill stores, {ld} bytes spill loads, {smem} bytes static smem{extra}")
        if st or ld:
            fail(f"{name} spills registers")


def kernel_phase(dev, card):
    """Phase 3: the evidence kernel against its plain version at every
    shape of the module docstring, the -inf contract, determinism, and
    times. Returns the kernel table's evidence rows (float32 times at the
    main paths' C, float64 max abs error over every parity shape)."""
    import torch

    from gptools_tpu_torch import configs

    table = {}
    for config in (4, 2, 3):
        k = KIND_OF[config]
        tag = f"config{config} {k}"
        prob = configs.ALL_CONFIGS[config](dtype=torch.float64, device=dev)
        m, d = prob.model, prob.data
        errs = [parity(tag, m, d, posterior_draws(config, C, torch.float64, dev, seed=C))
                for C in PATHS[config][3]]
        neg_inf_contract(tag, m, d, posterior_draws(config, 8, torch.float64, dev, seed=1))
        C = PATHS[config][0]
        determinism(tag, m, d, posterior_draws(config, C, torch.float64, dev, seed=5))
        row = {"max_abs_err": max(errs)}
        for dtype in (torch.float32, torch.float64):
            t_k, t_dev, t_p, b_ms, b_by = kernel_times(
                tag, m, d, posterior_draws(config, C, dtype, dev, seed=3), card)
            if dtype == torch.float32:
                row.update(ms=t_k, device_ms=t_dev, plain_ms=t_p, bound_ms=b_ms,
                           bound_by=b_by)
            kernel_times(tag, m, d, posterior_draws(config, SMC_PARTICLES, dtype, dev, seed=4),
                         card, plain=False)
        table[k] = row
    prob = configs.config1_se_map(dtype=torch.float64, device=dev)
    for C in CONFIG1_C:
        th = posterior_draws(1, C, torch.float64, dev, seed=C)
        table["se"]["max_abs_err"] = max(table["se"]["max_abs_err"],
                                         parity("config1 se", prob.model, prob.data, th))
    neg_inf_contract("config1 se", prob.model, prob.data,
                     posterior_draws(1, 8, torch.float64, dev, seed=1))
    determinism("config1 se", prob.model, prob.data,
                posterior_draws(1, CONFIG1_C[0], torch.float64, dev, seed=5))
    for config, Cs in INFERENCE_C.items():
        prob = configs.ALL_CONFIGS[config](dtype=torch.float64, device=dev)
        for C in Cs:
            kernel_times(f"config{config} {KIND_OF[config]} (phase 7's C)", prob.model,
                         prob.data, posterior_draws(config, C, torch.float64, dev, seed=C + 7),
                         card)
    rng = np.random.default_rng(SEED)
    for tag, m, d in variant_problems(dev):
        if tag == "se_noise_n48":
            th = torch.tensor(rng.uniform(0.4, 1.2, (1023, m.num_params)), device=dev)
            err = parity(tag, m, d, th, f32=False)
            neg_inf_contract(tag, m, d, th)
            table["se"]["max_abs_err"] = max(table["se"]["max_abs_err"], err)
            kernel_times(tag, m, d, th, card, plain=False)
            continue
        th = torch.tensor(rng.uniform(0.4, 1.2, (256, m.num_params)), device=dev)
        err = parity(tag, m, d, th)
        neg_inf_contract(tag, m, d, th)
        table["se"]["max_abs_err"] = max(table["se"]["max_abs_err"], err)
        # the nd and wp channels are on no config's path: timed here at the
        # configs' C = 4096
        for dtype in (torch.float32, torch.float64):
            kernel_times(tag, m, d, torch.tensor(
                rng.uniform(0.4, 1.2, (4096, m.num_params)), dtype=dtype, device=dev), card)
    return table


def main():
    import torch

    t_start = time.perf_counter()

    def done(phase):
        print(f"phase {phase} done: {time.perf_counter() - t_start:.1f} s since the start")

    # ---- phase 1: device -------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from gptools_tpu_torch import configs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"phase1 device: {kind}; nvidia-smi: {card}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; devices {torch.cuda.device_count()}")

    # ---- phase 2: build --------------------------------------------------
    build_phase()

    done("2")

    # ---- phase 3: kernel parity and times --------------------------------
    table = kernel_phase(dev, card)

    done("3")

    # ---- phase 7, run here: the reference's own inference routes ---------
    # Host-paced: it runs before the first torch.profiler session (phase
    # 3b), after which every launch of this process costs more on the host
    # (PERF.md, PR 7). Its launches join the kernels line after phase 4's.
    inference = inference_phase(dev, card)

    done("7")

    # ---- phase 8: the rest of the kernel zoo, through the per-chain route -
    # Host-paced like phase 7, so before phase 3b's profiler sessions; it
    # launches neither CUDA kernel. Its launch counts, a profiler session,
    # wait until after phase 10.
    zoo_models = zoo_phase(dev, card)

    done("8")

    # ---- phase 9: chains sharded over a mesh -----------------------------
    mesh_launches = mesh_phase(dev, card)

    done("9")

    # ---- phase 10: the reference's entry points -------------------------
    # Host-paced like phases 7-9, so before phase 3b's profiler sessions.
    example_launches = examples_phase(dev, card)

    done("10")

    # ---- phase 8's launch counts: the first torch.profiler session ------
    zoo_launch_counts(zoo_models)

    # ---- phase 3b: covariance-kernel parity and times --------------------
    cov_table = {}
    for config in (4, 2):
        k = COV_KIND_OF[config]
        errs = []
        for B in (1, SERVE_MAX_SAMPLES):
            prob = configs.ALL_CONFIGS[config](dtype=torch.float64, device=dev)
            res = cov_parity(k, prob.data.Xf.reshape(-1), prob.data.nid,
                             posterior_draws(config, B, torch.float64, dev, seed=B), card)
            errs.append(res[torch.float64][0])
            if B == SERVE_MAX_SAMPLES:
                err, t_k, t_dev, t_p, b_ms, b_by = res[torch.float64]
                cov_table[k] = dict(ms=t_k, device_ms=t_dev, plain_ms=t_p, bound_ms=b_ms,
                                    bound_by=b_by)
        # (16, 1001): tiles with a ragged edge (1001 = 15 * 64 + 41) and odd
        # rows (every other float64 row starts off a 16-byte boundary);
        # (256, 1024): the large shape of every earlier run
        for n_points, B, plain_reps in ((999, 16, 30), (1022, 256, 5)):
            big = configs.ALL_CONFIGS[config](n_points=n_points, dtype=torch.float64,
                                              device=dev)
            res = cov_parity(k, big.data.Xf.reshape(-1), big.data.nid,
                             posterior_draws(config, B, torch.float64, dev, seed=B), card,
                             time_plain_reps=plain_reps)
            errs.append(res[torch.float64][0])
            del big, res
            torch.cuda.empty_cache()
        cov_table[k]["max_abs_err"] = max(errs)  # float64, as the row's times
    # config 5's served states: its 47 latent points (odd: every other
    # float64 row starts off a 16-byte boundary), thetas from its golden
    prob5 = configs.config5_multihost_profile(dtype=torch.float64, device=dev)
    for B in (1, SERVE_MAX_SAMPLES):
        res = cov_parity("gibbs_tanh", prob5.data.Xf.reshape(-1), prob5.data.nid,
                         posterior_draws(5, B, torch.float64, dev, seed=B), card)
        row = cov_table["gibbs_tanh"]
        row["max_abs_err"] = max(row["max_abs_err"], res[torch.float64][0])

    done("3b")

    # ---- phase 3c: the route on the card ---------------------------------
    route_phase(dev, card)

    done("3c")

    # ---- phase 4: main paths (float32, as the reference's bench) ---------
    for config in (4, 2, 3):
        table[KIND_OF[config]]["launches"] = run_pipeline(
            config, torch.float32, dev, card, enforce_golden=False)[0]

    done("4")

    # ---- phase 5: the same pipelines in float64 against the x64 goldens --
    # In float32 the reference's own relative jitter (100 * eps32 * max(mean
    # diag, 1), ~1.2e-5 on every diagonal entry) shifts the config-4 sigma_f
    # posterior mean by ~-0.004 (-3.5% in its std): the reference's f32
    # runs on its TPU show it at 512 chains (BASELINE.md, z -2.7 to -3.3),
    # and at 12288 chains the run's own standard error is small enough that
    # the shift exceeds 4 of the golden's standard errors. The goldens are
    # float64 posteriors, so their rule is held in float64. Config 5 (1024
    # chains, 100 + 100 of the reference's 100 + 300) runs here only; its
    # evidence takes the route (T present), as in the reference.
    draws = {}
    for config in (4, 2, 3, 5):
        _, draws[config] = run_pipeline(config, torch.float64, dev, card,
                                        enforce_golden=True)
    leapfrog_wall(5, torch.float64, dev, card)
    diagnostics_phase(draws[4], configs.config4_gibbs_smc(device=dev).model.param_names,
                      card)

    done("5")

    # ---- phase 6: serving through the covariance kernel ------------------
    launches = {}
    for config in (4, 2, 3, 5):
        launches[config] = serve(config, draws[config], dev, card)
    cov_table["gibbs_tanh"]["launches"] = launches[4] + launches[5]
    cov_table["se"]["launches"] = launches[2]

    done("6")

    for row in table.values():
        row["launches_by_path"] = {"4": row["launches"]}
    for run, (k, n) in inference.items():
        table[k]["launches"] += n
        table[k]["launches_by_path"][run] = n
    for k, n in mesh_launches.items():
        if n:
            table[k]["launches"] += n
            table[k]["launches_by_path"]["9"] = n
    for run, by_kind in example_launches.items():
        for k, n in by_kind.items():
            if n:
                table[k]["launches"] += n
                table[k]["launches_by_path"][run] = n

    print(card)
    print(json.dumps({"kernels": [{
        "name": f"{k}_evidence",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES,
        "launches": row["launches"],  # phase 4's float32 path, phases 7, 9 and 10
        "launches_by_path": row["launches_by_path"],
        "max_abs_err": row["max_abs_err"],
        "ms": row["ms"],  # per call through the wrapper, as in every earlier run
        "device_ms": row["device_ms"],  # per launch, from a CUDA graph of 20
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this function
    } for k, row in table.items()] + [{
        "name": f"{k}_cov",
        "route": "cuda",
        "source": COV_SOURCE,
        "replaces": COV_REPLACES,
        "launches": row["launches"],
        "max_abs_err": row["max_abs_err"],
        "ms": row["ms"],  # float64 at (512, N), the serving path's dtype and B
        "device_ms": row["device_ms"],  # per launch, torch.profiler
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": None,  # no single PyTorch call builds this matrix
    } for k, row in cov_table.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
