"""BENCHMARK.json: its shape, and every file it names found by name."""

import importlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_shape():
    b = _bench()
    assert set(b) == TOP
    assert b["command"][:2] == ["python3", "benchmark/run.py"]
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]] + [
        m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(b)) < 64 * 1024


def test_every_file_found_by_name():
    """A configuration's JSON and module, a mix's JSON, a cell's limits, a
    reference posterior and every metric's reader, each by its name."""
    b = _bench()
    for c in b["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        for key in c["reduced"]:
            assert cfg[key] != cfg["source_values"][key]
        mod = importlib.import_module(f"benchmark.configs.{c['name']}")
        assert callable(mod.make_data) and callable(mod.program) and callable(mod.reference)
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "reference", "posteriors",
                                           c["name"] + ".json"))
    for w in b["workloads"]:
        for part in (("traffic", w["traffic"]), ("cells", w["name"])):
            with open(os.path.join(ROOT, "benchmark", part[0], part[1] + ".json")) as f:
                json.load(f)
        with open(os.path.join(ROOT, "benchmark", "traffic", w["traffic"] + ".json")) as f:
            gen = importlib.import_module(f"benchmark.generators.{json.load(f)['generator']}")
        assert isinstance(gen.Session, type)
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(importlib.import_module(f"benchmark.metrics.{m['name']}").read)


SCRIPT = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
from benchmark import run
res = run.run_cell(sys.argv[3], 20261018, 0.0, False, device="cpu", bench_root=sys.argv[1],
                   overrides={"config": {"num_chains": 32, "num_warmup": 4, "num_samples": 8},
                              "traffic": {"num_particles": 32, "min_solves": 1}})
print(json.dumps({"metrics": res["metrics"], "units": res["units"], "file": run.__file__,
                  "forbidden": run.forbidden_modules()}))
"""


def _run_in_copy(tmp_path, bench, files, workload):
    """Run ``workload`` at a tiny size in a copy of the benchmark with
    ``bench`` as its BENCHMARK.json and ``files`` ({path: text}) added,
    nothing else changed."""
    copy = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    for rel, text in files.items():
        assert not (copy / rel).exists()
        (copy / rel).write_text(text)
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(copy), ROOT, workload],
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["file"].startswith(str(copy))
    assert got["forbidden"] == []
    return got


def test_metric_added_by_new_files_only(tmp_path):
    """A new metric is a reader file and an entry: in a copy of the
    benchmark, with nothing else changed, the run reports it."""
    b = _bench()
    b["end_to_end"].append({"name": "throwaway_solves", "unit": "solves", "better": "higher",
                            "bound": 0.25, "source": "host_clock",
                            "workloads": ["cfg4.chees.f64"]})
    got = _run_in_copy(tmp_path, b, {"benchmark/metrics/throwaway_solves.py":
                                     "def read(ctx):\n    return ctx.units\n"},
                       "cfg4.chees.f64")
    assert got["metrics"]["throwaway_solves"] == {"value": 1.0, "unit": "solves"}
    assert set(got["metrics"]) == {"ess_per_s", "solve_s", "setup_s", "throwaway_solves"}


def _new_cell(b, name, traffic):
    b["workloads"].append({"name": name, "config": "config4_gibbs_tanh", "traffic": traffic,
                           "chips": 1, "why": "a cell added by new files only"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(name)
    with open(os.path.join(ROOT, "benchmark", "cells", "cfg4.chees.f64.json")) as f:
        return f.read()


def test_mix_added_by_new_files_only(tmp_path):
    """A mix of another pipeline (SMC then NUTS) that the generator already
    reads is a data file, a cell's limits and entries: the run reports the
    cell's metrics and the pipeline's own diagnostics."""
    b = _bench()
    limits = _new_cell(b, "cfg4.nuts.f64", "smc_nuts_f64")
    with open(os.path.join(ROOT, "benchmark", "traffic", "smc_chees_f64.json")) as f:
        mix = json.load(f)
    for k in ("max_steps", "target_accept"):
        mix.pop(k)
    mix.update(pipeline="smc_then_nuts", max_depth=4)
    got = _run_in_copy(tmp_path, b, {"benchmark/traffic/smc_nuts_f64.json": json.dumps(mix),
                                     "benchmark/cells/cfg4.nuts.f64.json": limits},
                       "cfg4.nuts.f64")
    assert set(got["metrics"]) == {"ess_per_s", "solve_s", "setup_s"}
    assert "mean_tree_depth" in got["units"][0] and "trajectory_time" not in got["units"][0]


def test_generator_added_by_new_files_only(tmp_path):
    """A new kind of traffic is a generator module of its own, found by the
    name its mix gives, and a data file: nothing that is there changes."""
    b = _bench()
    limits = _new_cell(b, "cfg4.other.f64", "other_f64")
    with open(os.path.join(ROOT, "benchmark", "traffic", "smc_chees_f64.json")) as f:
        mix = {**json.load(f), "generator": "throwaway_gen"}
    gen = ("from benchmark.generators import posterior_solve\n\n\n"
           "class Session(posterior_solve.Session):\n"
           "    def stats(self, records):\n"
           "        return [{**s, 'throwaway': 1} for s in super().stats(records)]\n")
    got = _run_in_copy(tmp_path, b, {"benchmark/traffic/other_f64.json": json.dumps(mix),
                                     "benchmark/cells/cfg4.other.f64.json": limits,
                                     "benchmark/generators/throwaway_gen.py": gen},
                       "cfg4.other.f64")
    assert got["units"][0]["throwaway"] == 1
    assert set(got["metrics"]) == {"ess_per_s", "solve_s", "setup_s"}
