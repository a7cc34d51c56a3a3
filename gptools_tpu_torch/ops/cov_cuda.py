"""GP covariance matrices with {value, slope} blocks: the CUDA kernel.

Counterpart of `gptools_tpu.ops.pallas_cov` (``se_cov``,
``gibbs_tanh_cov``, their VJPs, ``pallas_supported`` and
``cov_matrix_flagship``): for a theta (P,) or a batch (B, P), the (N, N)
or (B, N, N) covariance of one 1-D point set X (N,) whose order ids nid
(N,) pick the block of each entry (0 value, 1 slope; any other id gives an
exact zero).

Routes, chosen by the device of theta and nothing else:

- CUDA: the kernel ``csrc/cov_kernel.cu`` (one thread per entry, the theta
  batch on the grid; one launch for all B, where the reference ``vmap``s a
  single-theta Pallas call). It is built with the evidence kernel into one
  library (`evidence_cuda.build`); a build or launch failure raises. X is
  passed in float64 and rounded to theta's dtype in the kernel.
- CPU: the plain version, the single-theta fused builders
  (`fused.se_cov_fused`, `fused.gibbs_tanh_cov_fused`) on X in theta's
  dtype.

`se_cov_vjp` / `gibbs_tanh_cov_vjp` are differentiable in theta: the
forward takes the route above, the backward runs autograd through the
plain builder (as the reference's ``_make_vjp``); X and nid get no
gradient. `LAUNCHES` counts kernel launches and `PLAIN_CALLS` forward calls
of the plain version, per kind (the backward's builds are not counted).
"""

from __future__ import annotations

import torch

from gptools_tpu_torch.ops import evidence_cuda, fused

__all__ = [
    "KINDS",
    "LAUNCHES",
    "PLAIN_CALLS",
    "reset_counts",
    "cov_plain",
    "cov_cuda",
    "se_cov",
    "gibbs_tanh_cov",
    "se_cov_vjp",
    "gibbs_tanh_cov_vjp",
    "cov_supported",
    "cov_matrix_flagship",
]

KINDS = {"se": 2, "gibbs_tanh": 5}  # theta entries per kind
_PLAIN = {"se": fused.se_cov_fused, "gibbs_tanh": fused.gibbs_tanh_cov_fused}

LAUNCHES = {k: 0 for k in KINDS}
PLAIN_CALLS = {k: 0 for k in KINDS}


def reset_counts() -> None:
    """Set every launch and plain-call count to 0."""
    for k in KINDS:
        LAUNCHES[k] = 0
        PLAIN_CALLS[k] = 0


def _check(kind: str, X: torch.Tensor, nid: torch.Tensor, theta: torch.Tensor):
    if theta.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"theta must be float32 or float64, got {theta.dtype}")
    P = KINDS[kind]
    if theta.ndim not in (1, 2) or theta.shape[-1] != P:
        raise ValueError(f"theta must be ({P},) or (B, {P}) for kind {kind}, "
                         f"got {tuple(theta.shape)}")
    if X.ndim != 1 or nid.shape != X.shape:
        raise ValueError(f"X and nid must be (N,), got {tuple(X.shape)} and "
                         f"{tuple(nid.shape)}")
    if X.device != theta.device or nid.device != theta.device:
        raise ValueError(f"X on {X.device}, nid on {nid.device}, theta on {theta.device}")


def cov_plain(kind: str, X: torch.Tensor, nid: torch.Tensor, theta: torch.Tensor):
    """The plain PyTorch version on any device (differentiable)."""
    _check(kind, X, nid, theta)
    PLAIN_CALLS[kind] += 1
    return _PLAIN[kind](X.to(theta.dtype), nid, theta)


def cov_cuda(kind: str, X: torch.Tensor, nid: torch.Tensor, theta: torch.Tensor):
    """Launch the kernel: theta (P,) or (B, P) on a CUDA device ->
    (N, N) or (B, N, N) in theta's dtype."""
    _check(kind, X, nid, theta)
    if theta.device.type != "cuda":
        raise ValueError(f"theta must be a CUDA tensor, got {theta.device}")
    n = X.shape[0]
    th = theta.reshape(-1, KINDS[kind]).contiguous()
    B = th.shape[0]
    out = torch.empty((B, n, n), dtype=theta.dtype, device=theta.device)
    if B > 0 and n > 0:
        X64 = X.to(torch.float64).contiguous()
        ids = nid.to(torch.int32).contiguous()
        dt = "f64" if theta.dtype == torch.float64 else "f32"
        fn = getattr(evidence_cuda.library(), f"gt_{kind}_cov_{dt}")
        with torch.cuda.device(theta.device):
            stream = torch.cuda.current_stream(theta.device).cuda_stream
            rc = fn(n, X64.data_ptr(), ids.data_ptr(), th.data_ptr(), B,
                    out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"covariance kernel launch failed: cudaError {rc}")
        LAUNCHES[kind] += 1
    return out if theta.ndim == 2 else out[0]


def _route(kind: str, X, nid, theta):
    if theta.device.type == "cuda":
        return cov_cuda(kind, X, nid, theta)
    if theta.device.type == "cpu":
        return cov_plain(kind, X, nid, theta)
    raise ValueError(f"no covariance route for device {theta.device}")


def se_cov(X: torch.Tensor, nid: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """SE covariance: X (N,), nid (N,), theta [sigma_f, l] (2,) or (B, 2)
    -> (N, N) or (B, N, N), by the route of theta's device."""
    return _route("se", X, nid, theta)


def gibbs_tanh_cov(X: torch.Tensor, nid: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Gibbs-tanh covariance: theta [sigma_f, l1, l2, lw, x0] (5,) or
    (B, 5) -> (N, N) or (B, N, N), by the route of theta's device."""
    return _route("gibbs_tanh", X, nid, theta)


class _CovVJP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kind, X, nid, theta):
        ctx.kind = kind
        ctx.save_for_backward(X, nid, theta)
        return _route(kind, X, nid, theta)

    @staticmethod
    def backward(ctx, gK):
        X, nid, theta = ctx.saved_tensors
        with torch.enable_grad():
            th = theta.detach().requires_grad_(True)
            K = _PLAIN[ctx.kind](X.to(th.dtype), nid, th)
            (g,) = torch.autograd.grad(K, th, gK.to(th.dtype))
        return None, None, None, g


def se_cov_vjp(X: torch.Tensor, nid: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """`se_cov`, differentiable in theta (backward: autograd of the plain
    builder)."""
    return _CovVJP.apply("se", X, nid, theta)


def gibbs_tanh_cov_vjp(X: torch.Tensor, nid: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """`gibbs_tanh_cov`, differentiable in theta."""
    return _CovVJP.apply("gibbs_tanh", X, nid, theta)


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
    nid = fused._order_ids(data.nid, data.multi_indices)
    X = data.Xf.reshape(-1)
    if type(kernel) is SquaredExponentialKernel:
        return se_cov(X, nid, theta)
    if isinstance(kernel, GibbsKernel):
        return gibbs_tanh_cov(X, nid, theta)
    raise ValueError(f"no covariance kernel for {type(kernel).__name__}")
