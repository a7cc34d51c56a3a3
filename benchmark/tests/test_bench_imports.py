"""A run loads no module of JAX or the JAX package, by whole top-level
names (the port's own name begins with the JAX package's)."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.tests.conftest import ROOT

SCRIPT = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from benchmark import run
res = run.run_cell(sys.argv[2], 7, 0.0, False, device="cpu",
                   overrides={"config": {"num_chains": 16, "num_warmup": 2, "num_samples": 4},
                              "traffic": {"num_particles": 16, "min_solves": 1}})
tops = sorted({m.split(".")[0] for m in sys.modules})
print(json.dumps({"tops": tops, "forbidden": run.forbidden_modules()}))
"""


@pytest.mark.parametrize("workload", ["cfg4.chees.f64", "cfg3.chees.f64"])
def test_no_jax_in_a_run(workload):
    out = subprocess.run([sys.executable, "-c", SCRIPT, ROOT, workload], capture_output=True,
                         text=True, timeout=600, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert "gptools_tpu_torch" in got["tops"]
    for name in ("jax", "jaxlib", "flax", "gptools_tpu"):
        assert name not in got["tops"]
    assert got["forbidden"] == []


def test_forbidden_compares_whole_names(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "gptools_tpu_torch_probe", sys)
    monkeypatch.setitem(sys.modules, "jaxfoo.bar", sys)
    assert "gptools_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gptools_tpu.ops", sys)
    assert run.forbidden_modules() == ["gptools_tpu"]


def test_no_card_no_result():
    """Without a CUDA device the command exits non-zero and prints nothing."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
                          "--workload", "cfg4.chees.f64", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
