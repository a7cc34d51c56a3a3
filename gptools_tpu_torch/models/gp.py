"""GP model: parameter bookkeeping and the batched densities.

Counterpart of the `GPModel` batch surface of `gptools_tpu.models.gp`. All
densities take a chain batch: ``thetas (C, P)`` or ``us (C, Pf)`` -> ``(C,)``.
The evidence goes by the dataset's device: a CUDA `Dataset` through the
hand-written kernel (`ops.evidence_cuda`), which must take the model or the
call raises; a CPU `Dataset` through the kernel's plain version. There is no
backend switch.

Not ported yet: noise kernels and mean functions (ROADMAP Queue 1 item 9),
the generic derivative assembly for kernels the fused builder does not
classify (item 10), and the single-theta surface and the `GaussianProcess`
wrapper (item 12).
"""

from __future__ import annotations

import torch

from gptools_tpu_torch.models.dataset import Dataset
from gptools_tpu_torch.ops import evidence_cuda, fused
from gptools_tpu_torch.ops.kernels import Kernel

__all__ = ["GPModel"]


class GPModel:
    """GP specification: kernel + parameter metadata + batched densities.

    ``theta`` is the flat kernel-parameter vector; its free entries map to
    the unconstrained sampler space through the hyperprior's bijector.
    """

    def __init__(
        self,
        kernel: Kernel,
        noise_kernel=None,
        mean=None,
        diag_factor: float = 1e2,
    ):
        if noise_kernel is not None or mean is not None:
            raise NotImplementedError(
                "noise kernels and mean functions are ROADMAP Queue 1 item 9"
            )
        self.kernel = kernel
        self.diag_factor = float(diag_factor)
        self.num_params = kernel.num_params
        self.param_names = tuple(f"k.{n}" for n in kernel.param_names)
        self.fixed_params = tuple(kernel.fixed_params)
        self.param_bounds = list(kernel.param_bounds)
        self.initial_params = tuple(kernel.initial_params)
        self.free_idx = tuple(i for i, f in enumerate(self.fixed_params) if not f)
        self.num_free_params = len(self.free_idx)
        self.hyperprior = kernel.hyperprior
        self.bijector = self.hyperprior.bijector()
        self._evidence_cache = None  # (Dataset, EvidenceData) last used

    # -- free/fixed embedding (last axis) ------------------------------------
    def _full(self, free: torch.Tensor, fill: torch.Tensor) -> torch.Tensor:
        if self.num_free_params == self.num_params:
            return free
        out = fill.expand(free.shape[:-1] + (self.num_params,)).clone()
        out[..., list(self.free_idx)] = free
        return out

    def _initial(self, like: torch.Tensor) -> torch.Tensor:
        return torch.tensor(self.initial_params, dtype=like.dtype, device=like.device)

    def embed_free(self, theta_free: torch.Tensor) -> torch.Tensor:
        """Scatter free parameters into the full vector (fixed at initial)."""
        return self._full(theta_free, self._initial(theta_free))

    def extract_free(self, theta_full: torch.Tensor) -> torch.Tensor:
        if self.num_free_params == self.num_params:
            return theta_full
        return theta_full[..., list(self.free_idx)]

    # -- unconstrained space -------------------------------------------------
    def u_of_theta(self, theta_full: torch.Tensor) -> torch.Tensor:
        return self.extract_free(self.bijector.inverse(theta_full))

    def _u_full(self, u_free: torch.Tensor) -> torch.Tensor:
        return self._full(u_free, self.bijector.inverse(self._initial(u_free)))

    def theta_of_u(self, u_free: torch.Tensor) -> torch.Tensor:
        return self.bijector.forward(self._u_full(u_free))

    # -- densities -----------------------------------------------------------
    def log_prior(self, theta_full: torch.Tensor) -> torch.Tensor:
        return self.hyperprior.log_prob(theta_full)

    def _batch_supported(self, data: Dataset) -> bool:
        # none of the ported kernels has white-noise (delta) terms
        return fused.fused_supported(self.kernel, data.multi_indices, data.num_dim)

    def _evidence_data(self, data: Dataset) -> evidence_cuda.EvidenceData:
        """The dataset's evidence constants, uploaded once and reused while
        the same `Dataset` comes back (every call of a sampler run)."""
        if self._evidence_cache is not None and self._evidence_cache[0] is data:
            return self._evidence_cache[1]
        ids = fused._order_ids(data.nid, data.multi_indices)
        ev = evidence_cuda.make_data(
            data.Xf[:, 0], ids, data.y, data.err_y.double() ** 2,
            self.diag_factor, data.device,
        )
        self._evidence_cache = (data, ev)
        return ev

    def log_marginal_batch(self, thetas: torch.Tensor, data: Dataset) -> torch.Tensor:
        """Batched log marginal likelihood: thetas (C, P) -> (C,)."""
        if not self._batch_supported(data):
            raise NotImplementedError(
                "only the Gibbs-tanh kernel on 1-D data with orders {0, 1} is "
                "ported; the generic assembly is ROADMAP Queue 1 item 10"
            )
        if thetas.device != data.device:
            raise ValueError(f"thetas on {thetas.device}, data on {data.device}")
        ev = self._evidence_data(data)
        if data.device.type == "cuda" and not evidence_cuda.supported(ev.n):
            raise ValueError(
                f"N = {ev.n} observations exceed the CUDA evidence kernel's "
                f"N_MAX = {evidence_cuda.N_MAX}"
            )
        return evidence_cuda.loglik(thetas.T, ev)

    def log_posterior_batch(self, thetas: torch.Tensor, data: Dataset) -> torch.Tensor:
        lp = self.log_prior(thetas)
        ll = torch.where(
            torch.isfinite(lp), self.log_marginal_batch(thetas, data), 0.0
        )
        return lp + ll

    def log_posterior_u_batch(self, us: torch.Tensor, data: Dataset) -> torch.Tensor:
        """Unconstrained-space log posterior: us (C, Pf) -> (C,),
        ll + log prior + log|det J|."""
        u_full = self._u_full(us)
        thetas = self.bijector.forward(u_full)
        ldj = self.bijector.log_det_jac(u_full)
        return self.log_posterior_batch(thetas, data) + ldj
