#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; no phase falls back):

1. device: needs CUDA; prints the card's name and power limit
   (``nvidia-smi``); TF32 off for matmul and cuDNN.
2. build: compiles the evidence kernel from ``gptools_tpu_torch/csrc`` with
   ``nvcc`` for ``sm_90a`` (into ``gptools_tpu_torch/_build``).
3. kernel parity at the config-4 data (N = 27), C = 12288 and C = 1000
   (ragged edge): kernel vs plain PyTorch version on the card in float64
   (ll rtol 1e-9; grad rtol 1e-7, atol 1e-9) and in float32 (tolerance
   below), the -inf contract, and CUDA-event times of both.
4. main path: config 4 through ``smc_then_chees`` in float32 at 12288
   chains (75 warmup + 300 samples, 1024 particles, max_steps 256); every
   gradient must go through the kernel (launch counter up, plain-version
   counter unchanged); quality gates R-hat <= 1.1, divergences <= 1e-3 of
   draws; the posterior moments against tests/golden_config4.json are
   printed.
5. the same pipeline in float64, with the same gates and the moments held
   to the float64 golden by the rule of scripts/f32_parity.py (why not in
   float32: see the comment at phase 5).

The last two lines of standard output are the kernel table as JSON and
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 7
GOLDEN = os.path.join(ROOT, "tests", "golden_config4.json")
RHAT_GATE = 1.1
DIVERGENCE_FRAC_GATE = 1e-3
# float32 kernel vs float32 plain version on the same posterior-typical
# draws. Both factor the same f32 matrix; at config 4 cond(K) is ~1e4
# (err_y^2 floors the spectrum), so the two Cholesky orders may differ by
# up to n * eps32 * cond ~ 3e-2 relative in K^-1; measured on an H100
# (700 W) over 12288 draws: ll 4.6e-5 relative, gradient 9.8e-4. The
# bounds leave ~20x room on ll and ~10x on the gradient (norm over the 5
# parameters, per chain).
F32_LL_RTOL = 1e-3
F32_GRAD_RTOL = 1e-2


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


def posterior_draws(C, dtype, device, seed):
    """Golden mean +- 1 std (uniform), thetaT (5, C)."""
    import torch

    with open(GOLDEN) as f:
        gold = json.load(f)
    gm, gs = np.asarray(gold["mean"]), np.asarray(gold["std"])
    rng = np.random.default_rng(seed)
    th = gm + gs * rng.uniform(-1.0, 1.0, (C, 5))
    return torch.tensor(th.T.copy(), dtype=dtype, device=device)


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


def golden_rule(th, ess):
    """z-scores and pass flag of scripts/f32_parity.py's rule for
    (chains, samples, 5) samples against tests/golden_config4.json."""
    with open(GOLDEN) as f:
        gold = json.load(f)
    flat = th.reshape(-1, 5).double()
    m = flat.mean(0).cpu().numpy()
    s = flat.std(0).cpu().numpy()
    gm, gs, ge = (np.asarray(gold[k]) for k in ("mean", "std", "ess"))
    se = np.sqrt(s**2 / ess + gs**2 / ge)
    z = (m - gm) / se
    ok = bool(np.all(np.abs(z) <= 4.0)) and bool(
        np.all(np.abs(s - gs) <= 0.15 * gs + 4.0 * se)
    )
    return z, (s - gs) / gs, ok


def run_pipeline(dtype, dev, card, enforce_golden):
    """Config 4 through smc_then_chees at the bench shape on the card; the
    evidence must go through the kernel alone. Returns (launches, wall)."""
    import torch

    from gptools_tpu_torch import configs
    from gptools_tpu_torch.infer.pipeline import smc_then_chees
    from gptools_tpu_torch.ops import evidence_cuda
    from gptools_tpu_torch.utils.diagnostics import ess_and_rhat

    tag = f"config4 {str(dtype).replace('torch.', '')}"
    prob = configs.config4_gibbs_smc(dtype=dtype, device=dev)
    num_chains, num_warmup, num_samples = 12288, 75, 300
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    evidence_cuda.LAUNCHES = 0
    evidence_cuda.PLAIN_CALLS = 0
    t0 = time.perf_counter()
    res = smc_then_chees(
        prob.model, prob.data, gen, num_chains=num_chains,
        num_warmup=num_warmup, num_samples=num_samples, num_particles=1024,
        max_steps=256,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_calls = evidence_cuda.LAUNCHES, evidence_cuda.PLAIN_CALLS
    print(f"{tag}: evidence kernel launches {launches}, plain-version calls "
          f"{plain_calls}")
    if launches <= 0 or plain_calls != 0:
        fail("the main path did not run through the CUDA kernel alone")

    th = res.thetas
    if th.shape != (num_chains, num_samples, 5) or not torch.isfinite(th).all():
        fail(f"bad samples: shape {tuple(th.shape)}")
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
        fail(f"max R-hat {float(rhat.max())} > {RHAT_GATE}")
    if not divergences / draws <= DIVERGENCE_FRAC_GATE:
        fail(f"divergence fraction {divergences / draws} > {DIVERGENCE_FRAC_GATE}")
    z, std_rel, ok = golden_rule(th, ess)
    verdict = ("ok" if ok else "FAIL") if enforce_golden else (
        "reported, not gated: float32 model, see phase 5")
    print(f"{tag}: golden rule z {np.round(z, 3).tolist()}, std rel err "
          f"{np.round(std_rel, 4).tolist()} -> {verdict}")
    if enforce_golden and not ok:
        fail("posterior moments disagree with tests/golden_config4.json")
    return launches, wall


def main():
    import torch

    # ---- phase 1: device -------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from gptools_tpu_torch import configs
    from gptools_tpu_torch.ops import evidence_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"phase1 device: {kind}; nvidia-smi: {card}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; devices {torch.cuda.device_count()}")

    # ---- phase 2: build --------------------------------------------------
    so = evidence_cuda.build()
    info = evidence_cuda.BUILD_INFO
    print(f"phase2 build: {'cached' if info.get('cached') else 'nvcc'} "
          f"{info.get('seconds', 0.0):.3f} s -> {so}")
    if info.get("cmd"):
        print(f"phase2 cmd: {info['cmd']}")
    for line in info.get("log", "").splitlines():
        if "registers" in line or "stack frame" in line or "Compiling" in line:
            print(f"phase2 ptxas: {line.strip()}")

    # ---- phase 3: kernel parity ------------------------------------------
    prob64 = configs.config4_gibbs_smc(dtype=torch.float64, device=dev)
    ev = prob64.model._evidence_data(prob64.data)
    max_abs_err = 0.0
    for C in (12288, 1000):
        th = posterior_draws(C, torch.float64, dev, seed=C)
        llk, gk = evidence_cuda.loglik_vag_cuda(th, ev)
        llp, gp = evidence_cuda.loglik_vag_plain(th, ev)
        torch.cuda.synchronize()
        if not (torch.isfinite(llk).all() and torch.isfinite(gk).all()):
            fail(f"f64 C={C}: non-finite kernel output on posterior draws")
        ll_rel = float(((llk - llp).abs() / llp.abs()).max())
        g_margin = float(((gk - gp).abs() - (1e-9 + 1e-7 * gp.abs())).max())
        err = max(float((llk - llp).abs().max()), float((gk - gp).abs().max()))
        max_abs_err = max(max_abs_err, err)
        print(f"phase3 f64 C={C}: ll max rel err {ll_rel:.3e} (tol 1e-9); grad "
              f"max |d| - (1e-9 + 1e-7|g|) = {g_margin:.3e} (must be <= 0); "
              f"max abs err {err:.3e}")
        if not ll_rel <= 1e-9 or not g_margin <= 0.0:
            fail(f"f64 kernel/plain disagree at C={C}")

        th32 = th.float()
        llk32, gk32 = evidence_cuda.loglik_vag_cuda(th32, ev)
        llp32, gp32 = evidence_cuda.loglik_vag_plain(th32, ev)
        ll_rel32 = float(
            ((llk32 - llp32).abs() / llp32.abs().clamp(min=1.0)).max()
        )
        g_rel32 = float(
            ((gk32 - gp32).norm(dim=0) / gp32.norm(dim=0)).max()
        )
        vs64 = float((llk32.double() - llp).abs().median())
        print(f"phase3 f32 C={C}: kernel vs plain f32: ll max rel {ll_rel32:.3e} "
              f"(tol {F32_LL_RTOL}), grad max rel (norm) {g_rel32:.3e} (tol "
              f"{F32_GRAD_RTOL}); f32 kernel vs f64 plain ll median abs {vs64:.3e}")
        if not ll_rel32 <= F32_LL_RTOL or not g_rel32 <= F32_GRAD_RTOL:
            fail(f"f32 kernel/plain disagree at C={C}")

    for dtype in (torch.float64, torch.float32):
        th = posterior_draws(8, dtype, dev, seed=1)
        th[2, 1] = float("nan")
        ll, g = evidence_cuda.loglik_vag_cuda(th, ev)
        ok = (
            float(ll[1]) == -float("inf")
            and bool((g[:, 1] == 0).all())
            and bool(torch.isfinite(ll[[0, 2, 3, 4, 5, 6, 7]]).all())
            and bool(torch.isfinite(g).all())
        )
        print(f"phase3 -inf contract {dtype}: ll[1]={float(ll[1])}, "
              f"grad[:,1]={g[:, 1].tolist()} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("-inf contract")

    times = {}
    for dtype in (torch.float32, torch.float64):
        th = posterior_draws(12288, dtype, dev, seed=3)
        times[dtype] = (
            cuda_ms(lambda: evidence_cuda.loglik_vag_cuda(th, ev)),
            cuda_ms(lambda: evidence_cuda.loglik_vag_plain(th, ev)),
        )
        print(f"phase3 time C=12288 N=27 {dtype}: kernel {times[dtype][0]:.4f} ms, "
              f"plain {times[dtype][1]:.4f} ms (median of 30, CUDA events; {card})")

    # ---- phase 4: main path (float32, as the reference's bench) ----------
    launches, _ = run_pipeline(torch.float32, dev, card, enforce_golden=False)

    # ---- phase 5: the same pipeline in float64 against the x64 golden ----
    # In float32 the reference's own relative jitter (100 * eps32 * max(mean
    # diag, 1), ~1.2e-5 on every diagonal entry) shifts the sigma_f
    # posterior mean by ~-0.004 (-3.5% in its std): the reference's f32
    # runs on its TPU show it at 512 chains (BASELINE.md, z -2.7 to -3.3),
    # and at 12288 chains the run's own standard error is small enough
    # that the shift exceeds 4 of the golden's standard errors. The golden
    # is a float64 posterior, so its rule is held in float64.
    run_pipeline(torch.float64, dev, card, enforce_golden=True)

    print(card)
    t32 = times[torch.float32]
    print(json.dumps({"kernels": [{
        "name": "gibbs_tanh_evidence",
        "route": "cuda",
        "source": "gptools_tpu_torch/csrc/evidence_gibbs_tanh.cu",
        "replaces": "gptools_tpu/ops/evidence_pallas.py:475",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": t32[0],
        "plain_ms": t32[1],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
