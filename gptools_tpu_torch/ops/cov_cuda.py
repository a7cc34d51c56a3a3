"""GP covariance matrices with {value, slope} blocks: the CUDA kernel.

Counterpart of `gptools_tpu.ops.pallas_cov` (``se_cov``,
``gibbs_tanh_cov``, their VJPs, ``pallas_supported`` and
``cov_matrix_flagship``): for a theta (P,) or a batch (B, P), the (N, N)
or (B, N, N) covariance of one 1-D point set X (N,) whose order ids nid
(N,) pick the block of each entry (0 value, 1 slope; any other id gives an
exact zero).

Routes, chosen by the device of theta and nothing else:

- CUDA: the kernel ``csrc/cov_kernel.cu`` (one launch for all B, where the
  reference ``vmap``s a single-theta Pallas call; each unordered pair
  evaluated once and written at (i, j) and (j, i), so K is exactly
  symmetric; a block per theta for N <= 64, 64 x 64 tiles of the lower
  triangle above, see ``csrc/cov_entry.cuh``). It is built with the
  evidence kernel into one library (`evidence_cuda.build`); a build or
  launch failure raises. X is passed in float64 and rounded to theta's
  dtype in the kernel.
- CPU: the plain version, the single-theta fused builders
  (`fused.se_cov_fused`, `fused.gibbs_tanh_cov_fused`) on X in theta's
  dtype.

The per-dataset work can be done once: `points` turns (X, nid) into
float64 points and int32 order ids, contiguous on their device, and
`cov_vjp` takes them (a `GPModel` keeps a dataset's points beside it). A
call then checks theta, allocates the output and launches; the four entry
points are bound once.

`se_cov_vjp` / `gibbs_tanh_cov_vjp` are differentiable in theta: the
forward takes the route above, the backward runs autograd through the
plain builder (as the reference's ``_make_vjp``); X and nid get no
gradient. Without a theta that requires grad they are the plain forward
call. `LAUNCHES` counts kernel launches and `PLAIN_CALLS` forward calls of
the plain version, per kind (the backward's builds are not counted).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from gptools_tpu_torch.ops import evidence_cuda, fused

__all__ = [
    "KINDS",
    "LAUNCHES",
    "PLAIN_CALLS",
    "CovPoints",
    "reset_counts",
    "points",
    "layout",
    "cov_plain",
    "cov_cuda",
    "se_cov",
    "gibbs_tanh_cov",
    "cov_vjp",
    "se_cov_vjp",
    "gibbs_tanh_cov_vjp",
    "cov_supported",
    "cov_matrix_flagship",
]

KINDS = {"se": 2, "gibbs_tanh": 5}  # theta entries per kind
_PLAIN = {"se": fused.se_cov_fused, "gibbs_tanh": fused.gibbs_tanh_cov_fused}

LAUNCHES = {k: 0 for k in KINDS}
PLAIN_CALLS = {k: 0 for k in KINDS}

_FNS: dict = {}  # (kind, dtype) -> the bound entry point


def reset_counts() -> None:
    """Set every launch and plain-call count to 0."""
    for k in KINDS:
        LAUNCHES[k] = 0
        PLAIN_CALLS[k] = 0


class CovPoints(NamedTuple):
    """One point set as the kernel takes it: X (N,) float64 and the order
    ids nid (N,) int32, contiguous, on one device, with their addresses."""

    X: torch.Tensor
    nid: torch.Tensor
    device: torch.device
    n: int
    X_ptr: int
    nid_ptr: int


def points(X: torch.Tensor, nid: torch.Tensor, multi_indices=None) -> CovPoints:
    """The kernel's points of X (N,) and nid (N,), or, with the dataset's
    ``multi_indices``, of its X (N, 1) and multi-index rows nid (their
    order ids)."""
    Xf, ids = X, nid
    if multi_indices is not None:
        Xf, ids = X.reshape(-1), fused._order_ids(nid, multi_indices)
    if Xf.ndim != 1 or ids.shape != Xf.shape:
        raise ValueError(f"X and nid must be (N,), got {tuple(Xf.shape)} and "
                         f"{tuple(ids.shape)}")
    if Xf.device != ids.device:
        raise ValueError(f"X on {Xf.device}, nid on {ids.device}")
    X64, ids32 = Xf.to(torch.float64).contiguous(), ids.to(torch.int32).contiguous()
    return CovPoints(X64, ids32, X64.device, X64.shape[0], X64.data_ptr(), ids32.data_ptr())


_DTYPES = (torch.float32, torch.float64)


def _check(kind: str, pts: CovPoints, theta: torch.Tensor) -> int:
    """Raise on a theta the kind does not take; return its batch B (1 for
    a single theta)."""
    if theta.dtype not in _DTYPES:
        raise TypeError(f"theta must be float32 or float64, got {theta.dtype}")
    P, shape = KINDS[kind], theta.shape
    if not (len(shape) in (1, 2) and shape[-1] == P):
        raise ValueError(f"theta must be ({P},) or (B, {P}) for kind {kind}, "
                         f"got {tuple(shape)}")
    if theta.device != pts.device:
        raise ValueError(f"X and nid on {pts.device}, theta on {theta.device}")
    return shape[0] if len(shape) == 2 else 1


def _plain(kind: str, pts: CovPoints, theta: torch.Tensor):
    _check(kind, pts, theta)
    PLAIN_CALLS[kind] += 1
    return _PLAIN[kind](pts.X.to(theta.dtype), pts.nid, theta)


def cov_plain(kind: str, X: torch.Tensor, nid: torch.Tensor, theta: torch.Tensor):
    """The plain PyTorch version on any device (differentiable)."""
    return _plain(kind, points(X, nid), theta)


def _bind(kind: str, dtype: torch.dtype):
    fn = getattr(evidence_cuda.library(),
                 f"gt_{kind}_cov_{'f64' if dtype == torch.float64 else 'f32'}")
    _FNS[kind, dtype] = fn
    return fn


def _launch(kind: str, pts: CovPoints, theta: torch.Tensor):
    B = _check(kind, pts, theta)
    dev = pts.device
    if dev.type != "cuda":
        raise ValueError(f"theta must be a CUDA tensor, got {dev}")
    th = theta if theta.is_contiguous() else theta.contiguous()
    n = pts.n
    out = th.new_empty((B, n, n) if theta.ndim == 2 else (n, n))
    if B > 0 and n > 0:
        fn = _FNS.get((kind, theta.dtype)) or _bind(kind, theta.dtype)
        # the current stream's handle, as torch's own generated kernels take
        # it (torch.cuda.current_stream builds a Stream object each call)
        idx = dev.index
        if idx == torch.cuda.current_device():
            rc = fn(n, pts.X_ptr, pts.nid_ptr, th.data_ptr(), B, out.data_ptr(),
                    torch._C._cuda_getCurrentRawStream(idx))
        else:
            with torch.cuda.device(idx):
                rc = fn(n, pts.X_ptr, pts.nid_ptr, th.data_ptr(), B, out.data_ptr(),
                        torch._C._cuda_getCurrentRawStream(idx))
        if rc != 0:
            raise RuntimeError(f"covariance kernel launch failed: cudaError {rc}")
        LAUNCHES[kind] += 1
    return out


def cov_cuda(kind: str, X: torch.Tensor, nid: torch.Tensor, theta: torch.Tensor):
    """Launch the kernel: theta (P,) or (B, P) on a CUDA device ->
    (N, N) or (B, N, N) in theta's dtype."""
    return _launch(kind, points(X, nid), theta)


def layout(n: int, B: int, dtype: torch.dtype) -> dict:
    """The layout a launch at (N, B) in ``dtype`` takes, as the kernel
    library reports it (``gt_cov_layout``; builds the library): "small"
    (a block per theta, the image), "bands" (a block per 4 rows of a
    theta, direct stores) or "tiles"; grid, threads and shared bytes a
    block."""
    info = (ctypes.c_int * 5)()
    rc = evidence_cuda.library().gt_cov_layout(n, B, 8 if dtype == torch.float64 else 4, info)
    if rc != 0:
        raise ValueError(f"no covariance layout for N = {n}, B = {B}: cudaError {rc}")
    return dict(zip(("layout", "grid_x", "grid_yz", "threads", "smem_bytes"), info),
                layout=("small", "tiles", "bands")[info[0]])


def _route(kind: str, pts: CovPoints, theta: torch.Tensor):
    if theta.device.type == "cuda":
        return _launch(kind, pts, theta)
    if theta.device.type == "cpu":
        return _plain(kind, pts, theta)
    raise ValueError(f"no covariance route for device {theta.device}")


def se_cov(X: torch.Tensor, nid: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """SE covariance: X (N,), nid (N,), theta [sigma_f, l] (2,) or (B, 2)
    -> (N, N) or (B, N, N), by the route of theta's device."""
    return _route("se", points(X, nid), theta)


def gibbs_tanh_cov(X: torch.Tensor, nid: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Gibbs-tanh covariance: theta [sigma_f, l1, l2, lw, x0] (5,) or
    (B, 5) -> (N, N) or (B, N, N), by the route of theta's device."""
    return _route("gibbs_tanh", points(X, nid), theta)


class _CovVJP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kind, pts, theta):
        ctx.kind, ctx.pts = kind, pts
        ctx.save_for_backward(theta)
        return _route(kind, pts, theta)

    @staticmethod
    def backward(ctx, gK):
        (theta,) = ctx.saved_tensors
        with torch.enable_grad():
            th = theta.detach().requires_grad_(True)
            K = _PLAIN[ctx.kind](ctx.pts.X.to(th.dtype), ctx.pts.nid, th)
            (g,) = torch.autograd.grad(K, th, gK.to(th.dtype))
        return None, None, g


def cov_vjp(kind: str, pts: CovPoints, theta: torch.Tensor) -> torch.Tensor:
    """The kind's covariance of `points` ``pts``, differentiable in theta
    (backward: autograd of the plain builder); with no gradient to take,
    the forward route alone."""
    if theta.requires_grad and torch.is_grad_enabled():
        return _CovVJP.apply(kind, pts, theta)
    return _route(kind, pts, theta)


def se_cov_vjp(X: torch.Tensor, nid: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """`se_cov`, differentiable in theta (backward: autograd of the plain
    builder)."""
    return cov_vjp("se", points(X, nid), theta)


def gibbs_tanh_cov_vjp(X: torch.Tensor, nid: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """`gibbs_tanh_cov`, differentiable in theta."""
    return cov_vjp("gibbs_tanh", points(X, nid), theta)


def cov_supported(kernel, data) -> bool:
    """True when (kernel, data) take the covariance kernel: 1-D points,
    orders within {(0,), (1,)}, an SE or a Gibbs-tanh kernel (narrower than
    `fused.fused_supported`, as the reference's ``pallas_supported``)."""
    from gptools_tpu_torch.ops.kernels import GibbsKernel, SquaredExponentialKernel, TanhWarp

    if not fused.fused_supported(kernel, data.multi_indices, data.num_dim):
        return False
    if type(kernel) is SquaredExponentialKernel:
        return True
    return isinstance(kernel, GibbsKernel) and type(kernel.warp) is TanhWarp


def cov_matrix_flagship(kernel, theta: torch.Tensor, data) -> torch.Tensor:
    """K_ff over the dataset's points for an SE or Gibbs-tanh kernel
    (order ids 0 for (0,) and 1 for (1,), as the sorted multi-index table
    gives them). A Gibbs kernel with another warp raises."""
    from gptools_tpu_torch.ops.kernels import GibbsKernel, SquaredExponentialKernel, TanhWarp

    if isinstance(kernel, GibbsKernel) and type(kernel.warp) is not TanhWarp:
        raise ValueError(
            "cov_matrix_flagship only implements the TanhWarp Gibbs kernel; "
            f"got GibbsKernel with warp {type(kernel.warp).__name__}"
        )
    pts = points(data.Xf, data.nid, data.multi_indices)
    if type(kernel) is SquaredExponentialKernel:
        return _route("se", pts, theta)
    if isinstance(kernel, GibbsKernel):
        return _route("gibbs_tanh", pts, theta)
    raise ValueError(f"no covariance kernel for {type(kernel).__name__}")
