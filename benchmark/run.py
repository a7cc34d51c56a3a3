"""The benchmark of the PyTorch + CUDA port: one cell, one run.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: a cell (an entry of ``workloads`` in
BENCHMARK.json) names a configuration (``configs/<config>.json``, and its
``.py``: data, the program's model, the plain reference) and a traffic mix
(``traffic/<traffic>.json``), the mix names its generator
(``generators/<generator>.py``), ``cells/<workload>.json`` holds the limits
of the cell's correctness check, and every metric is read by
``metrics/<name>.py``.

1. Set-up (``setup_s``): import the port, and let the generator build the
   program's model and data and warm up the cell's own shapes.
2. The window: the generator's, closed by the clock after ``--seconds``.
3. After it, untimed: with ``--trace 1`` one more unit of the window's work
   under the profiler; each unit's quality gates; the program's outputs
   against the plain reference; one JSON line.

Exits non-zero, with no result, without a CUDA device (or fewer than the
cell asks for) and if JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from types import SimpleNamespace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "gptools_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _card() -> dict:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return {"nvidia_smi": f"unread: {e}"}
    return {"nvidia_smi": out}


def _set_caches() -> None:
    """Kernel and build caches at fixed paths inside the checkout: the
    port's own library builds into its package's ``_build/``; PyTorch's
    runtime-compiled elementwise kernels (digamma and the like, compiled
    at first use) go to ``torch_kernels``."""
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = os.path.join(cache, "torch_kernels")
    os.makedirs(os.environ["PYTORCH_KERNEL_CACHE_PATH"], exist_ok=True)


def _metrics_of(bench: dict, workload: str, trace: bool) -> list:
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def _read_metric(name: str, ctx):
    mod = importlib.import_module(f"benchmark.metrics.{name}")
    value = mod.read(ctx)
    return None if value is None else float(value)


def judge(values: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}) for every limit the cell sets;
    a limit with no reading, or a reading that is not finite, fails."""
    table = {}
    ok = True
    for name, limit in limits.items():
        v = values.get(name, math.inf)
        table[name] = {"value": v, "limit": limit}
        ok = ok and math.isfinite(v) and v <= limit
    return ok, table


def _fmt(v) -> str:
    return f"{v:.6g}" if isinstance(v, float) else str(v)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             bench_root: str = ROOT, overrides: dict = None, program_hook=None,
             t0: float = None) -> dict:
    """One run of one cell; returns the result's fields. ``overrides``
    (``config`` / ``traffic`` dicts) and ``program_hook(model, data)``
    serve the CPU tests that drive a run at a small size or with a fault
    planted under the timed path."""
    import torch

    t0 = T0 if t0 is None else t0
    overrides = overrides or {}
    bench = _load_json(bench_root, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = {**_load_json(bench_root, cfg_entry["file"]), **overrides.get("config", {})}
    spec = {**_load_json(bench_root, "benchmark", "traffic", cell["traffic"] + ".json"),
            **overrides.get("traffic", {})}
    cell_spec = _load_json(bench_root, "benchmark", "cells", workload + ".json")
    cfg_mod = importlib.import_module(f"benchmark.configs.{cell['config']}")
    generator = importlib.import_module(f"benchmark.generators.{spec['generator']}")

    on_card = device == "cuda"
    session = generator.Session(spec, cfg, cfg_mod, cell["config"], device, seed,
                                program_hook=program_hook)
    setup_s = time.perf_counter() - t0
    _log(f"setup_s {setup_s:.3f} ({', '.join(f'{k} {_fmt(v)}' for k, v in session.info.items())})")

    win = session.window(seconds, seed)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    _log(f"window {win.window_s:.3f} s, {len(win.records)} units "
         f"({', '.join(f'{w:.3f}' for w in win.walls)} s), "
         f"{', '.join(f'{k} {v}' for k, v in win.counters.items())}, peak {peak} B")

    tr = None
    if trace:
        tr = session.profile(seed)
        _log(f"profiled unit: {tr.events} profiler events, wall {tr.wall_s:.3f} s, "
             f"span {tr.span_s:.3f} s, device busy {tr.busy_s:.3f} s, "
             f"{tr.calls} density calls, {len(tr.evidence_s)} evidence launches")
    session.release()

    stats = session.stats(win.records)
    for k, st in enumerate(stats):
        _log(f"unit {k}: " + ", ".join(f"{key} {_fmt(v)}" for key, v in st.items()))
    values = session.readings(win.records, seed, cell_spec)
    correct, table = judge(values, cell_spec["limits"])

    card = _card() if on_card else {}
    ctx = SimpleNamespace(
        cfg=cfg, dtype=session.dtype_name, setup_s=setup_s, window_s=win.window_s,
        units=len(win.records), stats=stats, trace=tr, card=card, **win.counters,
    )
    metrics = {}
    for m in _metrics_of(bench, workload, trace):
        v = _read_metric(m["name"], ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    result = {"correct": bool(correct), "attempted": len(stats),
              "failed": sum(not st["passed"] for st in stats), "metrics": metrics,
              "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.span_s
        result["breakdown"] = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
        result["profiled_events"] = tr.events
    result["units"] = stats
    result["setup"] = session.info
    result["card"] = card
    result["checks"] = {k: {"value": v["value"] if math.isfinite(v["value"]) else None,
                            "limit": v["limit"]} for k, v in table.items()}
    for name, v in table.items():
        _log(f"check {name} {v['value']!r} limit {v['limit']!r} "
             f"{'ok' if math.isfinite(v['value']) and v['value'] <= v['limit'] else 'FAILED'}")
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    _set_caches()
    sys.path.insert(0, ROOT)
    import torch

    bench = _load_json(ROOT, "BENCHMARK.json")
    need = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        _log(f"needs {need} CUDA device(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.set_num_threads(1)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        _log(f"loaded modules of JAX or the JAX package: {bad}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
