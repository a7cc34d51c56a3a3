"""Gibbs-tanh evidence value-and-gradient: the hand-written CUDA kernel.

Counterpart of `gptools_tpu.ops.evidence_pallas` (kind ``gibbs_tanh``, no
aux inputs): ``vag(thetaT (5, C)) -> (ll (C,), grad (5, C))`` in the
reference's chains-minor layout, and `loglik`, a `torch.autograd.Function`
whose backward is ``g[None, :] * grad`` (the forward already computed the
gradient).

Routes, chosen by the device of ``thetaT`` and nothing else:

- CUDA: the kernel in ``csrc/`` (one thread per chain; see
  ``csrc/gibbs_tanh_chain.cuh``). It is compiled by ``nvcc`` for ``sm_90a``
  into a shared library with a plain C interface at the first CUDA call,
  cached under ``gptools_tpu_torch/_build/`` by a hash of the sources, and
  bound with ctypes. A build or launch failure raises.
- CPU: `loglik_vag_plain`, the plain PyTorch version (fused covariance build
  + `evidence.loglik_b`, gradient by autograd).

`LAUNCHES` counts kernel launches and `PLAIN_CALLS` calls of the plain
version, so a run can show which route it took.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

from gptools_tpu_torch.ops import evidence, fused

__all__ = [
    "EvidenceData",
    "N_MAX",
    "LAUNCHES",
    "PLAIN_CALLS",
    "build",
    "supported",
    "make_data",
    "loglik_vag_plain",
    "loglik_vag_cuda",
    "vag",
    "loglik",
]

N_MAX = 48  # gt::N_MAX in csrc/gibbs_tanh_chain.cuh
NUM_PARAMS = 5

LAUNCHES = 0
PLAIN_CALLS = 0

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
_SOURCES = ("gibbs_tanh_chain.cuh", "evidence_gibbs_tanh.cu")
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_LIB = None
BUILD_INFO: dict = {}


class EvidenceData(NamedTuple):
    """Observation constants of one dataset, on its device: X, y, err^2
    (N,) float64 and the derivative-order ids nid (N,) int32 in {0, 1}."""

    X: torch.Tensor
    nid: torch.Tensor
    y: torch.Tensor
    err2: torch.Tensor
    diag_factor: float

    @property
    def n(self) -> int:
        return self.X.shape[0]


def make_data(X, nid, y, err2, diag_factor: float, device) -> EvidenceData:
    """Upload the constants once; every call reuses the same tensors."""

    def f64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device).reshape(-1).contiguous()

    nid_t = torch.as_tensor(nid, device=device).reshape(-1).to(torch.int32).contiguous()
    ev = EvidenceData(f64(X), nid_t, f64(y), f64(err2), float(diag_factor))
    if not ev.n == nid_t.shape[0] == ev.y.shape[0] == ev.err2.shape[0]:
        raise ValueError("X, nid, y and err2 must have the same length")
    if not bool(((nid_t == 0) | (nid_t == 1)).all()):
        raise ValueError("nid must hold derivative-order ids 0 or 1")
    return ev


def supported(n: int) -> bool:
    return 1 <= n <= N_MAX


def _nvcc() -> str:
    cand = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
    )
    if not os.path.exists(cand):
        raise RuntimeError(f"nvcc not found (looked for {cand})")
    return cand


def build() -> Path:
    """Compile the kernel library if this source hash has not been built;
    return its path. `BUILD_INFO` records the command, seconds and the
    compiler's resource report (``-Xptxas -v``)."""
    h = hashlib.sha256()
    for name in _SOURCES:
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    so = _BUILD_DIR / f"libgt_evidence_{h.hexdigest()[:16]}.so"
    if so.exists():
        BUILD_INFO.update(path=str(so), seconds=0.0, cached=True)
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_CSRC / "evidence_gibbs_tanh.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, so)
    BUILD_INFO.update(
        path=str(so), seconds=secs, cached=False, cmd=" ".join(cmd),
        log=(proc.stdout + proc.stderr).strip(),
    )
    return so


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name in ("gt_gibbs_tanh_evidence_f32", "gt_gibbs_tanh_evidence_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [
                ctypes.c_int,     # n
                ctypes.c_void_p,  # X
                ctypes.c_void_p,  # nid
                ctypes.c_void_p,  # y
                ctypes.c_void_p,  # err2
                ctypes.c_double,  # diag_factor
                ctypes.c_void_p,  # thetaT
                ctypes.c_int,     # C
                ctypes.c_void_p,  # ll
                ctypes.c_void_p,  # grad
                ctypes.c_void_p,  # stream
            ]
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check_theta(thetaT: torch.Tensor):
    if thetaT.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"thetaT must be float32 or float64, got {thetaT.dtype}")
    if thetaT.ndim != 2 or thetaT.shape[0] != NUM_PARAMS:
        raise ValueError(f"thetaT must be ({NUM_PARAMS}, C), got {tuple(thetaT.shape)}")


def loglik_vag_cuda(thetaT: torch.Tensor, ev: EvidenceData):
    """Launch the kernel: thetaT (5, C) on a CUDA device -> (ll, grad)."""
    global LAUNCHES
    _check_theta(thetaT)
    if not supported(ev.n):
        raise ValueError(f"N = {ev.n} outside the kernel's range 1..{N_MAX}")
    for name, dtype in (("X", torch.float64), ("nid", torch.int32),
                        ("y", torch.float64), ("err2", torch.float64)):
        t = getattr(ev, name)
        if (t.device != thetaT.device or not t.is_contiguous()
                or t.dtype != dtype or t.shape != (ev.n,)):
            raise ValueError(
                f"evidence data {name} must be a contiguous ({ev.n},) {dtype} "
                f"tensor on {thetaT.device} (see make_data)"
            )
    if thetaT.device.type != "cuda":
        raise ValueError(f"thetaT must be a CUDA tensor, got {thetaT.device}")
    if not thetaT.is_contiguous():
        raise ValueError("thetaT must be contiguous")
    C = thetaT.shape[1]
    ll = torch.empty(C, dtype=thetaT.dtype, device=thetaT.device)
    grad = torch.empty((NUM_PARAMS, C), dtype=thetaT.dtype, device=thetaT.device)
    if C == 0:
        return ll, grad
    lib = _lib()
    fn = (
        lib.gt_gibbs_tanh_evidence_f64
        if thetaT.dtype == torch.float64
        else lib.gt_gibbs_tanh_evidence_f32
    )
    with torch.cuda.device(thetaT.device):
        stream = torch.cuda.current_stream(thetaT.device).cuda_stream
        rc = fn(
            ev.n, ev.X.data_ptr(), ev.nid.data_ptr(), ev.y.data_ptr(),
            ev.err2.data_ptr(), ev.diag_factor, thetaT.data_ptr(), C,
            ll.data_ptr(), grad.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"evidence kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return ll, grad


def loglik_vag_plain(thetaT: torch.Tensor, ev: EvidenceData):
    """Plain PyTorch version of the kernel on any device: the fused
    covariance build and `evidence.loglik_b`, gradient by autograd; a
    non-finite ll gives -inf and a zero gradient, as the kernel does."""
    global PLAIN_CALLS
    _check_theta(thetaT)
    PLAIN_CALLS += 1
    dtype = thetaT.dtype
    X, y, err2 = (a.to(dtype) for a in (ev.X, ev.y, ev.err2))
    with torch.enable_grad():
        th = thetaT.detach().requires_grad_(True)
        K = fused.gibbs_tanh_cov_fused_soa_sym(X, ev.nid, th)
        Kobs = K + torch.diag(err2)[:, :, None]
        r = y[:, None].expand(ev.n, th.shape[1])
        ll = evidence.loglik_b(Kobs, r, ev.diag_factor)
        (grad,) = torch.autograd.grad(ll.sum(), th)
    ll = ll.detach()
    ok = torch.isfinite(ll)
    ll = torch.where(ok, ll, torch.full_like(ll, -math.inf))
    return ll, torch.where(ok[None, :], grad, 0.0)


def vag(thetaT: torch.Tensor, ev: EvidenceData):
    """(ll, grad) by the route of ``thetaT``'s device: the kernel on CUDA,
    the plain version on CPU; any other device raises."""
    if thetaT.device.type == "cuda":
        return loglik_vag_cuda(thetaT, ev)
    if thetaT.device.type == "cpu":
        return loglik_vag_plain(thetaT, ev)
    raise ValueError(f"no evidence route for device {thetaT.device}")


class _Loglik(torch.autograd.Function):
    @staticmethod
    def forward(ctx, thetaT, ev):
        ll, grad = vag(thetaT.contiguous(), ev)
        ctx.save_for_backward(grad)
        return ll

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return g[None, :] * grad, None


def loglik(thetaT: torch.Tensor, ev: EvidenceData) -> torch.Tensor:
    """Differentiable ll (C,) of thetaT (5, C); backward is ``g * grad``."""
    return _Loglik.apply(thetaT, ev)
