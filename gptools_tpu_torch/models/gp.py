"""GP model: parameter bookkeeping and the batched densities.

Counterpart of the `GPModel` batch surface of `gptools_tpu.models.gp`,
with its theta layout ``[kernel | noise kernel | mean]``. All densities
take a chain batch: ``thetas (C, P)`` or ``us (C, Pf)`` -> ``(C,)``.

The evidence always goes through the evidence kernel (`ops.evidence_cuda`)
under the reference's eligibility rules for its fused Pallas kernel
(`_pallas_evidence_fn`): a classified kernel (SE, Matern-5/2, Gibbs-tanh,
the stationary ones optionally under a BetaWarp / LinearWarp), any ported
mean function, an optional `DiagonalNoiseKernel` whose rows are purely
diagonal, 1-D data with orders {0, 1}. Only the kernel's base rows go to
the kernel; the mean (``mu``), the noise variance (``nd``) and the warped
coordinates (``w``, ``wp``) are computed here in torch and enter as aux
channels, and autograd chains the kernel's aux cotangents through them.
A CUDA `Dataset` takes the kernel (N <= its N_MAX or the call raises), a
CPU `Dataset` its plain version.

The reference falls back to its generic XLA path outside those rules. The
port has no generic path yet, so there it raises `NotImplementedError`
(ROADMAP Queue 1 item 10): other kernels, noise kernels other than a
purely diagonal `DiagonalNoiseKernel`, and observation transforms (T).
The single-theta surface and the `GaussianProcess` wrapper are item 12.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gptools_tpu_torch.models.dataset import Dataset
from gptools_tpu_torch.models.mean import MeanFunction, mean_vector
from gptools_tpu_torch.ops import evidence_cuda, fused
from gptools_tpu_torch.ops.kernels import DiagonalNoiseKernel, Kernel

__all__ = ["GPModel"]

_GENERIC = "the generic assembly is ROADMAP Queue 1 item 10"


class _EvidencePlan(NamedTuple):
    """What one dataset needs per evidence call: the kernel's constants and
    how to form its inputs from the full theta rows."""

    ev: evidence_cuda.EvidenceData
    n_base: int            # theta rows the kernel takes
    input_warp: object     # BetaWarp / LinearWarp, or None
    noise_mask: Optional[torch.Tensor]  # (N, 1) rows the noise applies to


class GPModel:
    """GP specification: kernel (+ noise kernel, + mean) with parameter
    metadata and batched densities.

    ``theta`` is the flat vector ``[kernel params | noise-kernel params |
    mean params]``; its free entries map to the unconstrained sampler space
    through the hyperprior's bijector.
    """

    def __init__(
        self,
        kernel: Kernel,
        noise_kernel: Optional[Kernel] = None,
        mean: Optional[MeanFunction] = None,
        diag_factor: float = 1e2,
    ):
        if noise_kernel is not None and type(noise_kernel) is not DiagonalNoiseKernel:
            raise NotImplementedError(
                f"noise kernel {type(noise_kernel).__name__}: only "
                f"DiagonalNoiseKernel is ported; {_GENERIC}"
            )
        self.kernel = kernel
        self.noise_kernel = noise_kernel
        self.mean = mean
        self.diag_factor = float(diag_factor)

        sizes = (
            kernel.num_params,
            noise_kernel.num_params if noise_kernel else 0,
            mean.num_params if mean else 0,
        )
        self._sizes = sizes
        self._offsets = (0, sizes[0], sizes[0] + sizes[1])
        self.num_params = sum(sizes)

        names = [f"k.{n}" for n in kernel.param_names]
        fixed = list(kernel.fixed_params)
        bounds = list(kernel.param_bounds)
        init = list(kernel.initial_params)
        parts = [kernel.hyperprior]
        if noise_kernel:
            names += [f"noise.{n}" for n in noise_kernel.param_names]
            fixed += list(noise_kernel.fixed_params)
            bounds += list(noise_kernel.param_bounds)
            init += list(noise_kernel.initial_params)
            if noise_kernel.num_params:
                parts.append(noise_kernel.hyperprior)
        if mean:
            names += [f"mu.{n}" for n in mean.param_names]
            fixed += list(mean.fixed_params)
            bounds += list(mean.param_bounds)
            init += list(mean.initial_params)
            if mean.num_params and mean.hyperprior is not None:
                parts.append(mean.hyperprior)
        self.param_names = tuple(names)
        self.fixed_params = tuple(fixed)
        self.param_bounds = bounds
        self.initial_params = tuple(init)
        self.free_idx = tuple(i for i, f in enumerate(self.fixed_params) if not f)
        self.num_free_params = len(self.free_idx)
        prior = parts[0]
        for p in parts[1:]:
            prior = prior * p
        self.hyperprior = prior
        self.bijector = self.hyperprior.bijector()
        self._plan_cache = None  # (Dataset, _EvidencePlan) last used

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

    def _evidence_plan(self, data: Dataset) -> _EvidencePlan:
        """The reference's eligibility rules and constants for one dataset,
        resolved once and reused while the same `Dataset` comes back (every
        call of a sampler run)."""
        if self._plan_cache is not None and self._plan_cache[0] is data:
            return self._plan_cache[1]
        if data.num_dim != 1 or not set(data.multi_indices) <= {(0,), (1,)}:
            raise NotImplementedError(
                f"{data.num_dim}-D data with orders {data.multi_indices}: the "
                f"evidence kernel takes 1-D values and slopes; {_GENERIC}"
            )
        cls = fused.classify_flagship(self.kernel)
        if cls is None or self.kernel.delta_terms():
            raise NotImplementedError(
                f"kernel {type(self.kernel).__name__} has no evidence-kernel "
                f"kind; {_GENERIC}"
            )
        kind, n_base, input_warp = cls
        X = data.Xf[:, 0].detach().cpu().double().numpy()
        nid = data.nid.cpu().numpy()
        ids = np.asarray(fused._order_ids(nid, data.multi_indices))
        noise_mask = None
        nk = self.noise_kernel
        if nk is not None:
            if len(set(zip(X.tolist(), ids.tolist()))) != X.shape[0]:
                raise NotImplementedError(
                    "DiagonalNoiseKernel on repeated (x, order) rows couples "
                    f"them off the diagonal; {_GENERIC}"
                )
            if nk.n_match is None:
                mask = np.ones(X.shape[0])
            elif nk.n_match in data.multi_indices:
                mask = (nid == data.multi_indices.index(nk.n_match)).astype(float)
            else:
                mask = None  # no observation of the matching order
            if mask is not None:
                noise_mask = torch.as_tensor(
                    mask[:, None], dtype=data.dtype, device=data.device
                )
        ev = evidence_cuda.make_data(
            X, ids, data.y, data.err_y.double() ** 2, self.diag_factor,
            data.device, kind,
        )
        plan = _EvidencePlan(ev, n_base, input_warp, noise_mask)
        self._plan_cache = (data, plan)
        return plan

    def _evidence_data(self, data: Dataset) -> evidence_cuda.EvidenceData:
        """The dataset's evidence-kernel constants (`_evidence_plan`)."""
        return self._evidence_plan(data).ev

    def _evidence_inputs(self, thetaT: torch.Tensor, data: Dataset):
        """The kernel's inputs from full theta rows thetaT (P, C): its base
        rows (n_base, C), its constants and the aux channels, each (N, C),
        computed in torch (as the reference's aux closure,
        ``gp.py :: _pallas_evidence_fn``)."""
        plan = self._evidence_plan(data)
        aux = {}
        if self.mean is not None:
            o, s = self._offsets[2], self._sizes[2]
            aux["mu"] = mean_vector(
                self.mean, thetaT[o : o + s], data.Xf.to(thetaT.dtype), data.nid,
                data.multi_indices,
            )
        if plan.noise_mask is not None:
            sn = thetaT[self._offsets[1]]
            aux["nd"] = (sn * sn)[None, :] * plan.noise_mask.to(thetaT.dtype)
        if plan.input_warp is not None:
            w, wp = fused.warp_coords(
                plan.input_warp, plan.ev.X.to(thetaT.dtype),
                thetaT[plan.n_base : self._sizes[0]], plan.ev.has_slopes,
            )
            aux["w"] = w
            if wp is not None:
                aux["wp"] = wp
        if plan.n_base < thetaT.shape[0]:  # a slice adds a backward node
            thetaT = thetaT[: plan.n_base]
        return thetaT, plan.ev, aux

    def log_marginal_batch(self, thetas: torch.Tensor, data: Dataset) -> torch.Tensor:
        """Batched log marginal likelihood: thetas (C, P) -> (C,)."""
        if thetas.device != data.device:
            raise ValueError(f"thetas on {thetas.device}, data on {data.device}")
        thetaT, ev, aux = self._evidence_inputs(thetas.T, data)
        if data.device.type == "cuda" and not evidence_cuda.supported(ev.n):
            raise ValueError(
                f"N = {ev.n} observations exceed the CUDA evidence kernel's "
                f"N_MAX = {evidence_cuda.N_MAX}"
            )
        return evidence_cuda.loglik(thetaT, ev, aux)

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
