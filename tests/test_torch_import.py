"""The port imports torch and numpy only: no jax, no triton, no kernel build
(the evidence and covariance kernels share one library)."""

import json
import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CODE = """
import json, pkgutil, importlib, sys
import gptools_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(gptools_tpu_torch.__path__, "gptools_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
print(json.dumps({"modules": mods, "jax": "jax" in sys.modules,
                  "triton": "triton" in sys.modules,
                  "gptools_tpu": "gptools_tpu" in sys.modules,
                  "unbuilt": sys.modules["gptools_tpu_torch.ops.evidence_cuda"]._LIB is None}))
"""


def test_import_leaves_out_jax_and_triton(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c", _CODE], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "gptools_tpu_torch.ops.evidence_cuda" in res["modules"]
    assert "gptools_tpu_torch.infer.pipeline" in res["modules"]
    for mod in ("ops.cov_cuda", "ops.assemble", "ops.derivs", "models.serve",
                "utils.bounds"):
        assert f"gptools_tpu_torch.{mod}" in res["modules"]
    assert not res["jax"]
    assert not res["triton"]
    assert not res["gptools_tpu"]
    assert res["unbuilt"]  # importing loads no kernel library
