"""GP evidence value-and-gradient: the hand-written CUDA kernel.

Counterpart of `gptools_tpu.ops.evidence_pallas` (kinds ``gibbs_tanh``,
``se`` and ``matern52``, with the aux channels ``mu``, ``nd``, ``w`` and
``wp``): ``vag(thetaT (P, C), ev, aux) -> (ll (C,), grad (P, C)[, gaux])``
in the reference's chains-minor layout, and `loglik`, a
`torch.autograd.Function` whose backward is ``g * grad`` for theta and
``g * gaux[name]`` for each aux input (the forward already computed them),
so autograd chains the aux cotangents through whatever produced the aux
inputs (mean, noise square, warp), as ``jax.custom_vjp`` does in the
reference.

Aux channels, each (N, C) in the theta dtype, as in the reference:

- ``mu``: the mean at each observation; dll/dmu = alpha.
- ``nd``: noise variance added to the diagonal before the jitter; dll/dnd
  = diag(dll/dK) + the jitter's trace term.
- ``w``: warped coordinates (``se`` / ``matern52`` only); pairs at
  d = w_i - w_j.
- ``wp``: warp slopes, present exactly when ``w`` is and the data hold
  slope rows; they scale the slope blocks.

Routes, chosen by the device of ``thetaT`` and nothing else:

- CUDA: the kernel in ``csrc/``, one warp per chain. A block of 4 warps
  serves 4 consecutive chains; each chain's matrices (K, then L and the
  pair cotangents in one n x ld square; Z^T = L^-T and then the second
  operand's cotangents in another) and per-point vectors live in the
  block's dynamic shared memory, which the C entry point sizes from n and
  the dtype (~33 KB a block at config 4's n = 27 in float32, ~181 KB at
  n = 48 in float64; above 48 KB by raising the kernel's limit once per
  device). The 32 lanes split every phase of the algorithm (pairs, rows,
  points; the Cholesky two columns a phase, with the solve and L^-1 as its
  extra rows) and sum across lanes in a fixed order, with no atomics, so
  a call is deterministic; see ``csrc/evidence_chain.cuh``. It is
  compiled by ``nvcc`` for ``sm_90a``
  at the first CUDA call, together with the covariance kernel
  (`ops.cov_cuda`), into one shared library with a plain C interface,
  cached under ``gptools_tpu_torch/_build/`` by a hash of the sources, and
  bound with ctypes (`build`, `library`). A build failure raises, and so
  does any nonzero ``cudaError`` from the entry point (a refused launch
  never runs); nothing falls back to the plain version.
- CPU: `loglik_vag_plain`, the plain PyTorch version (fused covariance build
  + `evidence.loglik_b`, gradients by autograd).

`LAUNCHES` counts kernel launches and `PLAIN_CALLS` calls of the plain
version, per kind, so a run can show which route it took. Where the kernel
does not apply (`models.gp.GPModel.log_marginal_batch` decides that from the
model and the data), the batch evidence takes the reference's XLA route in
torch instead; `ROUTE_CALLS` counts those calls, per route
(``chains_minor``, ``per_chain``), apart from both.
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
from typing import NamedTuple, Optional

import torch

from gptools_tpu_torch.ops import evidence, fused

__all__ = [
    "EvidenceData",
    "KINDS",
    "AUX_NAMES",
    "N_MAX",
    "LAUNCHES",
    "PLAIN_CALLS",
    "ROUTE_CALLS",
    "reset_counts",
    "build",
    "library",
    "bind",
    "supported",
    "make_data",
    "loglik_vag_plain",
    "loglik_vag_cuda",
    "vag",
    "loglik",
]

N_MAX = 48  # gt::N_MAX in csrc/evidence_chain.cuh
KINDS = {"gibbs_tanh": 5, "se": 2, "matern52": 2}  # theta rows per kind
AUX_NAMES = ("mu", "nd", "w", "wp")

LAUNCHES = {k: 0 for k in KINDS}
PLAIN_CALLS = {k: 0 for k in KINDS}
ROUTE_CALLS = {"chains_minor": 0, "per_chain": 0}

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
_SOURCES = ("pair_math.cuh", "evidence_chain.cuh", "cov_entry.cuh", "evidence_kernel.cu",
            "cov_kernel.cu")
_UNITS = ("evidence_kernel.cu", "cov_kernel.cu")  # compiled and linked by one nvcc
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_LIB = None
BUILD_INFO: dict = {}


def reset_counts() -> None:
    """Set every launch, plain-call and route-call count to 0."""
    for k in KINDS:
        LAUNCHES[k] = 0
        PLAIN_CALLS[k] = 0
    for k in ROUTE_CALLS:
        ROUTE_CALLS[k] = 0


class EvidenceData(NamedTuple):
    """Observation constants of one dataset, on its device: X, y, err^2
    (N,) float64, the derivative-order ids nid (N,) int32 in {0, 1}, and
    the pair kind of the model's kernel, and whether slope rows exist
    (read once here, so no call syncs with the device to learn it)."""

    X: torch.Tensor
    nid: torch.Tensor
    y: torch.Tensor
    err2: torch.Tensor
    diag_factor: float
    kind: str = "gibbs_tanh"
    has_slopes: bool = False

    @property
    def n(self) -> int:
        return self.X.shape[0]

    @property
    def num_params(self) -> int:
        return KINDS[self.kind]


def make_data(X, nid, y, err2, diag_factor: float, device, kind: str = "gibbs_tanh") -> EvidenceData:
    """Upload the constants once; every call reuses the same tensors."""
    if kind not in KINDS:
        raise ValueError(f"unknown evidence kind {kind!r}; kinds are {sorted(KINDS)}")

    def f64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device).reshape(-1).contiguous()

    nid_t = torch.as_tensor(nid, device=device).reshape(-1).to(torch.int32).contiguous()
    ev = EvidenceData(f64(X), nid_t, f64(y), f64(err2), float(diag_factor), kind,
                      bool((nid_t == 1).any()))
    if not ev.n == nid_t.shape[0] == ev.y.shape[0] == ev.err2.shape[0]:
        raise ValueError("X, nid, y and err2 must have the same length")
    if not bool(((nid_t == 0) | (nid_t == 1)).all()):
        raise ValueError("nid must hold derivative-order ids 0 or 1")
    return ev


def supported(n: int, kind: Optional[str] = None) -> bool:
    """True when the kernel covers N = ``n`` (and ``kind``, when given)."""
    return (kind is None or kind in KINDS) and 1 <= n <= N_MAX


def _nvcc() -> str:
    cand = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
    )
    if not os.path.exists(cand):
        raise RuntimeError(f"nvcc not found (looked for {cand})")
    return cand


def build() -> Path:
    """Compile the kernel library (the evidence and covariance kernels,
    every kind and dtype, one nvcc call) if this source hash has not been
    built; return its path. `BUILD_INFO` records the command, seconds and
    the compiler's resource report (``-Xptxas -v``)."""
    h = hashlib.sha256()
    for name in _SOURCES:
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    so = _BUILD_DIR / f"libgt_kernels_{h.hexdigest()[:16]}.so"
    if so.exists():
        BUILD_INFO.update(path=str(so), seconds=0.0, cached=True)
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), *(str(_CSRC / u) for u in _UNITS)]
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


def library() -> ctypes.CDLL:
    """The kernel library, built and loaded at the first call, with the
    argument types of every entry point: the evidence kernel's here, the
    covariance kernel's (`ops.cov_cuda`) ``gt_{kind}_cov_{dtype}(n, X, nid,
    theta, B, out, stream)`` and ``gt_cov_layout(n, B, item, info)``."""
    global _LIB
    if _LIB is None:
        _LIB = bind(ctypes.CDLL(str(build())))
    return _LIB


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of every entry point of a kernel library."""
    for dt in ("f32", "f64"):
        for kind in KINDS:
            fn = getattr(lib, f"gt_{kind}_evidence_{dt}")
            fn.argtypes = (
                [ctypes.c_int]                 # n
                + [ctypes.c_void_p] * 4        # X, nid, y, err2
                + [ctypes.c_double]            # diag_factor
                + [ctypes.c_void_p, ctypes.c_int]  # thetaT, C
                + [ctypes.c_void_p] * 4        # mu, nd, w, wp
                + [ctypes.c_void_p] * 6        # ll, grad, gmu, gnd, gw, gwp
                + [ctypes.c_void_p]            # stream
            )
            fn.restype = ctypes.c_int
        for kind in ("se", "gibbs_tanh"):
            fn = getattr(lib, f"gt_{kind}_cov_{dt}")
            fn.argtypes = (
                [ctypes.c_int] + [ctypes.c_void_p] * 3  # n, X, nid, theta
                + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]  # B, out, stream
            )
            fn.restype = ctypes.c_int
    lib.gt_cov_layout.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.gt_cov_layout.restype = ctypes.c_int  # n, B, item, info[6]
    return lib


def _check_theta(thetaT: torch.Tensor, ev: EvidenceData):
    if thetaT.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"thetaT must be float32 or float64, got {thetaT.dtype}")
    P = ev.num_params
    if thetaT.ndim != 2 or thetaT.shape[0] != P:
        raise ValueError(
            f"thetaT must be ({P}, C) for kind {ev.kind}, got {tuple(thetaT.shape)}"
        )


def _check_aux(thetaT: torch.Tensor, ev: EvidenceData, aux: dict):
    """The aux set must be one the reference builds: names among
    `AUX_NAMES`, ``w`` only for the stationary kinds, ``wp`` exactly when
    ``w`` is given and slope rows exist; each (N, C) like thetaT."""
    extra = set(aux) - set(AUX_NAMES)
    if extra:
        raise ValueError(f"unknown aux channels {sorted(extra)}; known {AUX_NAMES}")
    if "w" in aux and ev.kind == "gibbs_tanh":
        raise ValueError("gibbs_tanh cannot be input-warped (aux 'w')")
    if ("wp" in aux) != ("w" in aux and ev.has_slopes):
        raise ValueError(
            "aux 'wp' is required exactly when 'w' is given and the data hold "
            "slope rows"
        )
    for name, a in aux.items():
        if a.shape != (ev.n, thetaT.shape[1]) or a.dtype != thetaT.dtype or a.device != thetaT.device:
            raise ValueError(
                f"aux {name} must be ({ev.n}, {thetaT.shape[1]}) {thetaT.dtype} "
                f"on {thetaT.device}, got {tuple(a.shape)} {a.dtype} on {a.device}"
            )


def loglik_vag_cuda(thetaT: torch.Tensor, ev: EvidenceData, aux: Optional[dict] = None):
    """Launch the kernel: thetaT (P, C) on a CUDA device (P the kind's
    theta rows) and the aux channels -> (ll, grad), or (ll, grad, gaux)
    when aux channels are given."""
    aux = dict(aux or {})
    _check_theta(thetaT, ev)
    _check_aux(thetaT, ev, aux)
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
    if not thetaT.is_contiguous() or not all(a.is_contiguous() for a in aux.values()):
        raise ValueError("thetaT and the aux channels must be contiguous")
    C = thetaT.shape[1]
    ll = torch.empty(C, dtype=thetaT.dtype, device=thetaT.device)
    grad = torch.empty_like(thetaT)
    gaux = {name: torch.empty_like(a) for name, a in aux.items()}
    if C > 0:
        lib = library()
        fn = getattr(lib, f"gt_{ev.kind}_evidence_{'f64' if thetaT.dtype == torch.float64 else 'f32'}")

        def ptr(d, name):
            return d[name].data_ptr() if name in d else None

        with torch.cuda.device(thetaT.device):
            stream = torch.cuda.current_stream(thetaT.device).cuda_stream
            rc = fn(
                ev.n, ev.X.data_ptr(), ev.nid.data_ptr(), ev.y.data_ptr(),
                ev.err2.data_ptr(), ev.diag_factor, thetaT.data_ptr(), C,
                *(ptr(aux, a) for a in AUX_NAMES),
                ll.data_ptr(), grad.data_ptr(),
                *(ptr(gaux, a) for a in AUX_NAMES),
                stream,
            )
        if rc != 0:
            raise RuntimeError(f"evidence kernel launch failed: cudaError {rc}")
        LAUNCHES[ev.kind] += 1
    return (ll, grad, gaux) if aux else (ll, grad)


def _plain_cov(ev: EvidenceData, thetaT, aux):
    """The kernel's covariance (before err^2 and noise) by the fused builds."""
    X = ev.X.to(thetaT.dtype)
    if ev.kind == "gibbs_tanh":
        return fused.gibbs_tanh_cov_fused_soa_sym(X, ev.nid, thetaT)
    if "w" in aux:
        return fused.coords_cov_soa_sym(ev.kind, aux["w"], aux.get("wp"), ev.nid, thetaT)
    if ev.kind == "se":
        return fused.se_cov_fused_soa_sym(X, ev.nid, thetaT)
    return fused.matern52_cov_fused_soa_sym(X, ev.nid, thetaT)


def loglik_vag_plain(thetaT: torch.Tensor, ev: EvidenceData, aux: Optional[dict] = None):
    """Plain PyTorch version of the kernel on any device: the fused
    covariance build, noise on the diagonal, `evidence.loglik_b` on the
    residual y - mu, gradients into theta and every aux channel by
    autograd; a non-finite ll gives -inf and zero gradients, as the kernel
    does. Returns what `loglik_vag_cuda` returns."""
    aux = dict(aux or {})
    _check_theta(thetaT, ev)
    _check_aux(thetaT, ev, aux)
    PLAIN_CALLS[ev.kind] += 1
    dtype = thetaT.dtype
    n, C = ev.n, thetaT.shape[1]
    y, err2 = ev.y.to(dtype), ev.err2.to(dtype)
    with torch.enable_grad():
        th = thetaT.detach().requires_grad_(True)
        ax = {k: v.detach().requires_grad_(True) for k, v in aux.items()}
        K = _plain_cov(ev, th, ax) + torch.diag(err2)[:, :, None]
        if "nd" in ax:
            K = K + torch.diag_embed(ax["nd"].T).permute(1, 2, 0)
        r = y[:, None] - ax["mu"] if "mu" in ax else y[:, None].expand(n, C)
        ll = evidence.loglik_b(K, r, ev.diag_factor)
        grads = torch.autograd.grad(ll.sum(), [th, *ax.values()])
    ll = ll.detach()
    ok = torch.isfinite(ll)
    ll = torch.where(ok, ll, torch.full_like(ll, -math.inf))
    grad, *gaux = (torch.where(ok[None, :], g, 0.0) for g in grads)
    if not aux:
        return ll, grad
    return ll, grad, dict(zip(ax, gaux))


def vag(thetaT: torch.Tensor, ev: EvidenceData, aux: Optional[dict] = None):
    """(ll, grad[, gaux]) by the route of ``thetaT``'s device: the kernel on
    CUDA, the plain version on CPU; any other device raises."""
    if thetaT.device.type == "cuda":
        return loglik_vag_cuda(thetaT, ev, aux)
    if thetaT.device.type == "cpu":
        return loglik_vag_plain(thetaT, ev, aux)
    raise ValueError(f"no evidence route for device {thetaT.device}")


class _Loglik(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ev, names, thetaT, *aux_tensors):
        aux = {k: a.contiguous() for k, a in zip(names, aux_tensors)}
        out = vag(thetaT.contiguous(), ev, aux)
        grads = (out[1], *(out[2][k] for k in names)) if names else (out[1],)
        ctx.save_for_backward(*grads)
        return out[0]

    @staticmethod
    def backward(ctx, g):
        return (None, None, *(g[None, :] * t for t in ctx.saved_tensors))


def loglik(thetaT: torch.Tensor, ev: EvidenceData, aux: Optional[dict] = None) -> torch.Tensor:
    """Differentiable ll (C,) of thetaT (P, C) and the aux channels;
    backward is ``g * grad`` and ``g * gaux``."""
    names = tuple(aux or ())
    return _Loglik.apply(ev, names, thetaT, *(aux[k] for k in names))
