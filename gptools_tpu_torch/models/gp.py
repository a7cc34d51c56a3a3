"""GP core: the model spec, its densities, prediction and the wrapper.

Counterpart of `gptools_tpu.models.gp`, with its theta layout
``[kernel | noise kernel | mean]``.

`GPModel` has two surfaces:

- the batch surface the samplers drive: ``thetas (C, P)`` or
  ``us (C, Pf)`` -> ``(C,)`` (`log_marginal_batch`, `log_posterior_batch`,
  `log_posterior_u_batch`);
- the single-theta surface: `compute_K_L_alpha_ll`, `log_marginal`,
  `log_posterior`, `log_posterior_u`, `predict` and `draw_sample`. Each
  takes theta (P,), or a leading batch (B, P) where the reference
  ``vmap``s it.

The batch evidence (`log_marginal_batch`) resolves its route from the
model and the data alone, before anything is launched, as the reference's
``_pallas_evidence_fn`` does:

- the evidence kernel (`ops.evidence_cuda`; on a CPU `Dataset` its plain
  version) where the reference's eligibility rules for its fused Pallas
  kernel hold: a classified kernel (SE, Matern-5/2, Gibbs-tanh, the
  stationary ones optionally under a BetaWarp / LinearWarp), any ported
  mean function, an optional `DiagonalNoiseKernel` whose rows are purely
  diagonal, 1-D data with orders {0, 1}, N <= the kernel's N_MAX, no
  transformed observations T and no ``solve_dtype``. Only the kernel's
  base rows go to the kernel; the mean (``mu``), the noise variance
  (``nd``) and the warped coordinates (``w``, ``wp``) are computed here in
  torch and enter as aux channels, and autograd chains the kernel's aux
  cotangents through them;
- otherwise the route, the reference's XLA path written in torch: the
  chains-minor twin (`fused.flagship_cov_soa`, any noise kernel through
  `ops.assemble`, ``T K T^T``, `evidence.loglik_b`) for classified kernels
  on 1-D data with orders {0, 1}, and the per-chain route (the batched
  single-theta surface, in chunks) for every other kernel and for
  multi-dimensional data. Each call is counted in
  `evidence_cuda.ROUTE_CALLS`.

``evidence_backend``: ``"auto"`` and ``"fused_pallas"`` take the kernel
where it applies and the route otherwise; ``"xla"`` always takes the route.
The reference's ``"auto"`` resolves to ``"xla"`` off a TPU; the port's
keeps the kernel on the card. Both routes give the same numbers to 1e-9 in
float64, so the choice moves time, not results. A kernel that fails to
build or launch raises; nothing falls back.

The single-theta covariance follows ``cov_backend`` as in the reference:
``"fused"`` (the fused builders), ``"pallas"`` (the covariance kernel
`ops.cov_cuda` on the card, its plain version on the CPU; SE and
Gibbs-tanh only, the other kinds take the fused build) or ``"generic"``
(`ops.assemble`); ``"auto"`` resolves to ``"fused"``. Predictions build
the star-data and star-star blocks with the generic assembly on every
backend, as the reference does. ``solve_dtype`` casts the observation
covariance and the residual before the factorization. `GaussianProcess`
is the reference's stateful wrapper; `models.serve` holds the frozen
predictors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from gptools_tpu_torch.models.dataset import (
    Dataset,
    DatasetBuilder,
    normalize_multi_index,
    resolve_device,
)
from gptools_tpu_torch.models.mean import MeanFunction, mean_vector
from gptools_tpu_torch.ops import assemble, cov_cuda, evidence, evidence_cuda, fused
from gptools_tpu_torch.ops.kernels import DiagonalNoiseKernel, Kernel
from gptools_tpu_torch.infer.hmc import ValueWithGrad
from gptools_tpu_torch.parallel.mesh import ShardedDensity
from gptools_tpu_torch.utils.bounds import CombinedBounds, MaskedBounds

__all__ = ["GPModel", "GaussianProcess", "Prediction"]

# cov_backend="auto" resolves as the reference does (gptools_tpu/models/
# gp.py:50), a choice the reference made from its own TPU measurement.
# chip_smoke.py times both backends on the H100 (phase 6); change this only
# on those numbers.
_AUTO_COV_BACKEND = "fused"
_COV_BACKENDS = ("auto", "generic", "fused", "pallas")
_EVIDENCE_BACKENDS = ("auto", "xla", "fused_pallas")
# The per-chain route evaluates at most this many covariance entries
# (chains x Q^2) at once, divided by the kernels' ``entry_cost`` (a
# quadrature's nodes per entry): its jvp towers keep several intermediates
# of that size alive, so a sampler's C is taken in chunks of this budget.
# 2^23 (64 MiB per float64 intermediate) keeps the free-nu Matern's
# 8-chain NUTS at N = 32 (8 x 32^2 x 768 entries) in one chunk; two would
# double its launches (chip_smoke.py phase 8a prints its peak memory).
_PER_CHAIN_ENTRIES = 1 << 23
# On the card the per-chain route's value and gradient run as a CUDA graph,
# one per (data, shape of thetas), at most this many kept per model:
# eagerly, each call is thousands of launches paced by the host
# (chip_smoke.py phase 8 prints both).
_PER_CHAIN_GRAPHS = 4


class Prediction(NamedTuple):
    """Posterior predictive summary (the reference's ``predict`` tuple)."""

    mean: torch.Tensor
    std: Optional[torch.Tensor] = None
    cov: Optional[torch.Tensor] = None


def _merge_multi_indices(base: Tuple, extra) -> Tuple:
    """Union of multi-index tables, keeping the base ids."""
    table = list(base)
    for m in extra:
        if m not in table:
            table.append(m)
    return tuple(table)


class _EvidencePlan(NamedTuple):
    """What one dataset needs per evidence call: the kernel's constants and
    how to form its inputs from the full theta rows."""

    ev: evidence_cuda.EvidenceData
    n_base: int            # theta rows the kernel takes
    input_warp: object     # BetaWarp / LinearWarp, or None
    noise_mask: Optional[torch.Tensor]  # (N, 1) rows the noise applies to


def _chunked_vag(fn, chunk: int, thetas: torch.Tensor):
    """``fn`` over thetas (C, P) in chunks of rows: (values (C,), their
    gradients (C, P)), each chunk's value and gradient taken together."""
    lls, grads = [], []
    for t in thetas.split(chunk):
        with torch.enable_grad():
            t = t.detach().requires_grad_(True)
            ll = fn(t)
            (g,) = torch.autograd.grad(ll.sum(), t)
        lls.append(ll.detach())
        grads.append(g)
    return torch.cat(lls), torch.cat(grads)


class _GraphedVag:
    """`_chunked_vag` of one density on the card, captured once in a CUDA
    graph for one shape of thetas and replayed for each call: the route's
    thousands of small launches (jvp towers, the factorization and their
    backward) become one graph launch. The inputs are copied into a
    static buffer; the outputs are copied out of the graph's."""

    def __init__(self, fn, chunk: int, like: torch.Tensor):
        self.static = like.detach().clone()
        # MAGMA's batched solves (the default behind cholesky_inverse) copy
        # to the host, which a capture refuses: capture cuSOLVER's instead
        linalg = torch.backends.cuda.preferred_linalg_library()
        torch.backends.cuda.preferred_linalg_library("cusolver")
        try:
            # warm-up off the capture: handles, workspaces, cached constants
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(2):
                    _chunked_vag(fn, chunk, self.static)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.ll, self.grad = _chunked_vag(fn, chunk, self.static)
        finally:
            torch.backends.cuda.preferred_linalg_library(linalg)

    def __call__(self, thetas: torch.Tensor):
        self.static.copy_(thetas)
        self.graph.replay()
        return self.ll.clone(), self.grad.clone()


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
        solve_dtype=None,
        cov_backend: str = "auto",
        evidence_backend: str = "auto",
    ):
        if cov_backend not in _COV_BACKENDS:
            raise ValueError(f"unknown cov_backend {cov_backend!r}")
        if evidence_backend not in _EVIDENCE_BACKENDS:
            raise ValueError(f"unknown evidence_backend {evidence_backend!r}")
        self.kernel = kernel
        self.noise_kernel = noise_kernel
        self.mean = mean
        self.diag_factor = float(diag_factor)
        self.solve_dtype = solve_dtype
        self.cov_backend = cov_backend
        self.evidence_backend = evidence_backend

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
        bound_views = [kernel.param_bounds]
        init = list(kernel.initial_params)
        parts = [kernel.hyperprior]
        if noise_kernel:
            names += [f"noise.{n}" for n in noise_kernel.param_names]
            fixed += list(noise_kernel.fixed_params)
            bound_views.append(noise_kernel.param_bounds)
            init += list(noise_kernel.initial_params)
            if noise_kernel.num_params:
                parts.append(noise_kernel.hyperprior)
        if mean:
            names += [f"mu.{n}" for n in mean.param_names]
            fixed += list(mean.fixed_params)
            bound_views.append(mean.param_bounds)
            init += list(mean.initial_params)
            if mean.num_params and mean.hyperprior is not None:
                parts.append(mean.hyperprior)
        self.param_names = tuple(names)
        self.fixed_params = tuple(fixed)
        # a live view over the components' own bounds lists: writing through
        # it mutates the owning kernel or mean (the bijector and the prior
        # keep what they saw when the model was built)
        self.param_bounds = CombinedBounds(*bound_views)
        self.initial_params = tuple(init)
        self.free_idx = tuple(i for i, f in enumerate(self.fixed_params) if not f)
        self.num_free_params = len(self.free_idx)
        prior = parts[0]
        for p in parts[1:]:
            prior = prior * p
        self.hyperprior = prior
        self.bijector = self.hyperprior.bijector()
        self._plan_cache = None  # (Dataset, _EvidencePlan) last used
        self._points_cache = None  # (Dataset, cov_cuda.CovPoints) last used

    # -- theta slicing (last axis) -------------------------------------------
    def _theta_k(self, theta):
        return theta[..., : self._sizes[0]]

    def _theta_noise(self, theta):
        o = self._offsets[1]
        return theta[..., o : o + self._sizes[1]]

    def _theta_mean(self, theta):
        o = self._offsets[2]
        return theta[..., o : o + self._sizes[2]]

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

    def _check_matern_nu_support(self, data: Dataset) -> None:
        """Free-nu Matern with derivative observations needs nu > 1
        wherever the sampler (the prior's support) or the optimizer
        (``param_bounds``) can reach: the (1,1) block diverges at
        coincidence for nu <= 1, so such a run would turn -inf / NaN
        midway. Warns once per model, on static metadata, as the
        reference does (a warning, since evaluating at a safe nu stays
        legitimate)."""
        from gptools_tpu_torch.ops.kernels import MaternGeneralKernel

        if getattr(self, "_nu_support_warned", False):
            return
        if not isinstance(self.kernel, MaternGeneralKernel):
            return
        if all(sum(m) == 0 for m in data.multi_indices):
            return  # value-only data: any nu > 0 is fine
        i_nu = self.kernel.param_names.index("nu")
        lo_bound = float(self.kernel.param_bounds[i_nu][0])
        lo_prior = float(self.kernel.hyperprior.bounds[i_nu][0])
        lo = min(lo_bound, lo_prior)
        if lo <= 1.0:
            import warnings

            self._nu_support_warned = True
            warnings.warn(
                "MaternGeneralKernel with derivative observations requires "
                "nu > 1 wherever the sampler/optimizer can reach (the (1,1) "
                "covariance block diverges at coincidence for nu <= 1), but "
                f"the searchable nu lower bound is {lo:.4g} (param_bounds "
                f"{lo_bound:.4g}, prior support {lo_prior:.4g}). Tighten the "
                "nu prior/bounds to (1 + delta, hi) — e.g. "
                "UniformJointPrior([1.01], [30.0]) — or use the fixed "
                "half-integer MaternKernel.",
                stacklevel=3,
            )

    def _evidence_plan(self, data: Dataset) -> Optional[_EvidencePlan]:
        """The evidence kernel's constants for one dataset, or None where
        the reference's eligibility rules send the batch evidence to the
        route; resolved once and reused while the same `Dataset` comes back
        (every call of a sampler run)."""
        if self.evidence_backend == "xla" or self.solve_dtype is not None:
            return None
        if self._plan_cache is not None and self._plan_cache[0] is data:
            return self._plan_cache[1]
        plan = self._make_plan(data)
        self._plan_cache = (data, plan)
        return plan

    def _make_plan(self, data: Dataset) -> Optional[_EvidencePlan]:
        if data.T is not None:
            return None
        if data.num_dim != 1 or not set(data.multi_indices) <= {(0,), (1,)}:
            return None
        cls = fused.classify_flagship(self.kernel)
        if cls is None or self.kernel.delta_terms():
            return None
        if not evidence_cuda.supported(data.num_latent):
            return None
        kind, n_base, input_warp = cls
        X = data.Xf[:, 0].detach().cpu().double().numpy()
        nid = data.nid.cpu().numpy()
        ids = np.asarray(fused._order_ids(nid, data.multi_indices))
        noise_mask = None
        nk = self.noise_kernel
        if nk is not None:
            if type(nk) is not DiagonalNoiseKernel:
                return None
            # on repeated (x, order) rows the noise couples them off the
            # diagonal, which the kernel's nd channel cannot hold
            if len(set(zip(X.tolist(), ids.tolist()))) != X.shape[0]:
                return None
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
        return _EvidencePlan(ev, n_base, input_warp, noise_mask)

    def _require_plan(self, data: Dataset) -> _EvidencePlan:
        plan = self._evidence_plan(data)
        if plan is None:
            raise ValueError(
                "the evidence kernel does not apply to this model and data "
                f"(evidence_backend {self.evidence_backend!r}); "
                "log_marginal_batch takes the route"
            )
        return plan

    def _evidence_data(self, data: Dataset) -> evidence_cuda.EvidenceData:
        """The dataset's evidence-kernel constants (`_evidence_plan`)."""
        return self._require_plan(data).ev

    def _evidence_inputs(self, thetaT: torch.Tensor, data: Dataset):
        """The kernel's inputs from full theta rows thetaT (P, C): its base
        rows (n_base, C), its constants and the aux channels, each (N, C),
        computed in torch (as the reference's aux closure,
        ``gp.py :: _pallas_evidence_fn``)."""
        plan = self._require_plan(data)
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

    def log_marginal_batch(self, thetas: torch.Tensor, data: Dataset, mesh=None,
                           mesh_axis: Optional[str] = None) -> torch.Tensor:
        """Batched log marginal likelihood: thetas (C, P) -> (C,), by the
        evidence kernel where it applies, else by the route (module
        docstring). ``mesh``: a `DeviceMesh` whose ``mesh_axis`` (default:
        its first dimension) shards the chains: each rank computes its block
        (one kernel launch, or one route call, on C / W chains) and every
        rank returns the gathered (C,) (`parallel.mesh.ShardedDensity`)."""
        if mesh is not None:
            return ShardedDensity(lambda t: self.log_marginal_batch(t, data), mesh,
                                  mesh_axis)(thetas)
        if thetas.device != data.device:
            raise ValueError(f"thetas on {thetas.device}, data on {data.device}")
        self._check_matern_nu_support(data)
        if self._evidence_plan(data) is not None:
            thetaT, ev, aux = self._evidence_inputs(thetas.T, data)
            return evidence_cuda.loglik(thetaT, ev, aux)
        if not fused.fused_supported(self.kernel, data.multi_indices, data.num_dim):
            return self._per_chain_batch(thetas, data)
        return self._chains_minor_batch(thetas, data)

    def _chains_minor_batch(self, thetas: torch.Tensor, data: Dataset) -> torch.Tensor:
        """The reference's chains-minor XLA path (``gp.py:556-597``): the
        fused (Q, Q, C) build, the noise kernel by the generic assembly, the
        mean, ``T K T^T`` and ``T mu``, err_y^2 on the diagonal, the
        ``solve_dtype`` cast and `evidence.loglik_b`."""
        evidence_cuda.ROUTE_CALLS["chains_minor"] += 1
        thetaT = thetas.T
        Xf = data.Xf.to(thetas.dtype)
        mi = data.multi_indices
        Kff = fused.flagship_cov_soa(
            self.kernel, thetaT[: self._sizes[0]], Xf, data.nid, mi
        )  # (Q, Q, C)
        if self.noise_kernel is not None:
            Kn = assemble.cov_matrix(
                self.noise_kernel, self._theta_noise(thetas), Xf, data.nid, Xf,
                data.nid, mi,
            )  # (C, Q, Q)
            Kff = Kff + Kn.permute(1, 2, 0)
        if self.mean is not None:
            o, s = self._offsets[2], self._sizes[2]
            mu = mean_vector(self.mean, thetaT[o : o + s], Xf, data.nid, mi)  # (Q, C)
        else:
            mu = torch.zeros((Kff.shape[0], 1), dtype=Kff.dtype, device=Kff.device)
        if data.T is not None:
            T = data.T.to(Kff.dtype)
            Kobs = torch.einsum("mi,ijc,nj->mnc", T, Kff, T)
            mu = T @ mu
        else:
            Kobs = Kff
        err = (data.err_y * data.err_y).to(Kobs.dtype)
        Kobs = Kobs + torch.diag(err)[:, :, None]
        r = data.y.to(mu.dtype)[:, None] - mu
        if self.solve_dtype is not None:
            Kobs = Kobs.to(self.solve_dtype)
            r = r.to(self.solve_dtype)
        r = r.expand(Kobs.shape[0], Kobs.shape[-1])
        return evidence.loglik_b(Kobs, r, self.diag_factor)

    def _per_chain_batch(self, thetas: torch.Tensor, data: Dataset) -> torch.Tensor:
        """The reference's ``vmap(log_marginal)`` for kernels the fused
        builders do not cover and for multi-dimensional data: the batched
        single-theta `log_marginal` over chunks of chains, each chunk at
        most `_PER_CHAIN_ENTRIES` covariance entries over the kernels'
        ``entry_cost``. Under autograd each chunk's gradient is taken at
        once, so the assembly's intermediates never outlive their chunk;
        on the card the value and gradient of all chunks replay a CUDA
        graph (`_GraphedVag`) captured at the first call of each shape."""
        evidence_cuda.ROUTE_CALLS["per_chain"] += 1
        cost = self.kernel.entry_cost + (
            self.noise_kernel.entry_cost if self.noise_kernel is not None else 0)
        chunk = max(1, _PER_CHAIN_ENTRIES // (cost * data.num_latent**2))

        def fn(t):
            return self.log_marginal(t, data)

        if torch.is_grad_enabled() and thetas.requires_grad:
            if thetas.is_cuda and _PER_CHAIN_GRAPHS:
                return ValueWithGrad.apply(self._graphed_vag(fn, chunk, thetas, data), thetas)
            if thetas.shape[0] > chunk:
                return ValueWithGrad.apply(lambda t: _chunked_vag(fn, chunk, t), thetas)
        if thetas.shape[0] <= chunk:
            return fn(thetas)
        return torch.cat([fn(t) for t in thetas.split(chunk)])

    def _graphed_vag(self, fn, chunk: int, thetas: torch.Tensor, data: Dataset):
        """The `_GraphedVag` of this model's route on ``data`` for the shape
        and dtype of thetas, captured at its first use (a later change of
        the model's metadata does not reach it); at most
        `_PER_CHAIN_GRAPHS` kept (the oldest dropped)."""
        graphs = self.__dict__.setdefault("_route_graphs", {})
        key = (id(data), tuple(thetas.shape), thetas.dtype, thetas.device)
        entry = graphs.get(key)
        if entry is None or entry[0] is not data:
            if len(graphs) >= _PER_CHAIN_GRAPHS:
                graphs.pop(next(iter(graphs)))
            entry = (data, _GraphedVag(fn, chunk, thetas))
            graphs[key] = entry
        return entry[1]

    def log_posterior_batch(self, thetas: torch.Tensor, data: Dataset, mesh=None,
                            mesh_axis: Optional[str] = None) -> torch.Tensor:
        """Batched log posterior: thetas (C, P) -> (C,); ``mesh`` as in
        `log_marginal_batch`."""
        if mesh is not None:
            return ShardedDensity(lambda t: self.log_posterior_batch(t, data), mesh,
                                  mesh_axis)(thetas)
        lp = self.log_prior(thetas)
        ll = torch.where(
            torch.isfinite(lp), self.log_marginal_batch(thetas, data), 0.0
        )
        return lp + ll

    def log_posterior_u_batch(self, us: torch.Tensor, data: Dataset, mesh=None,
                              mesh_axis: Optional[str] = None) -> torch.Tensor:
        """Unconstrained-space log posterior: us (C, Pf) -> (C,),
        ll + log prior + log|det J|; ``mesh`` as in `log_marginal_batch`."""
        if mesh is not None:
            return ShardedDensity(lambda u: self.log_posterior_u_batch(u, data), mesh,
                                  mesh_axis)(us)
        u_full = self._u_full(us)
        thetas = self.bijector.forward(u_full)
        ldj = self.bijector.log_det_jac(u_full)
        return self.log_posterior_batch(thetas, data) + ldj

    # -- single-theta surface -------------------------------------------------
    def _check_device(self, theta: torch.Tensor, data: Dataset) -> None:
        if theta.device != data.device:
            raise ValueError(f"theta on {theta.device}, data on {data.device}")

    def _mean_at(self, theta, X, nid, multi_indices):
        """The mean at points X (N, D) of orders nid: theta (P,) -> (N,),
        (B, P) -> (B, N)."""
        return assemble.mean_vector(self.mean, self._theta_mean(theta), X.to(theta.dtype), nid,
                                    multi_indices)

    def _cov_points(self, data: Dataset) -> cov_cuda.CovPoints:
        """The covariance kernel's points of one dataset, made once and
        reused while the same `Dataset` comes back (every state build of a
        predictor on it)."""
        if self._points_cache is None or self._points_cache[0] is not data:
            self._points_cache = (
                data, cov_cuda.points(data.Xf, data.nid, data.multi_indices)
            )
        return self._points_cache[1]

    def _latent_cov(self, theta, data: Dataset, include_noise: bool):
        """K over the data's points: the kernel (and the noise kernel if
        asked), by ``cov_backend``."""
        self._check_matern_nu_support(data)
        backend = self.cov_backend
        if backend == "auto":
            backend = _AUTO_COV_BACKEND
        tk = self._theta_k(theta)
        if backend in ("fused", "pallas") and fused.fused_supported(
            self.kernel, data.multi_indices, data.num_dim
        ):
            Kff = fused.flagship_cov(
                self.kernel, tk, data.Xf, data.nid, data.multi_indices, backend=backend,
                points=self._cov_points(data) if backend == "pallas" else None,
            )
            if self.kernel.delta_terms():
                Kff = Kff + assemble.delta_matrix(
                    self.kernel, tk, data.Xf, data.nid, data.Xf, data.nid,
                    data.multi_indices,
                )
        else:
            Kff = assemble.cov_matrix(
                self.kernel, tk, data.Xf, data.nid, data.Xf, data.nid, data.multi_indices
            )
        if include_noise and self.noise_kernel is not None:
            Kff = Kff + assemble.cov_matrix(
                self.noise_kernel, self._theta_noise(theta), data.Xf, data.nid,
                data.Xf, data.nid, data.multi_indices,
            )
        return Kff

    def _latent_mean(self, theta, data: Dataset):
        """The mean at the latent points: (..., Q)."""
        if self.mean is None:
            return torch.zeros(theta.shape[:-1] + (data.num_latent,), dtype=theta.dtype,
                               device=theta.device)
        return self._mean_at(theta, data.Xf, data.nid, data.multi_indices)

    def obs_cov_and_resid(self, theta_full: torch.Tensor, data: Dataset):
        """Observation covariance (``T K T^T`` of the kernel and the noise
        kernel, err_y^2 on the diagonal) and the residual ``y - T mu``:
        (..., M, M) and (..., M)."""
        self._check_device(theta_full, data)
        Kobs = self._latent_cov(theta_full, data, include_noise=True)
        mu = self._latent_mean(theta_full, data)
        if data.T is not None:
            T = data.T.to(Kobs.dtype)
            Kobs = T @ Kobs @ T.T
            mu = (T @ mu[..., None])[..., 0]
        Kobs = Kobs + torch.diag(data.err_y * data.err_y).to(Kobs.dtype)
        r = data.y.to(Kobs.dtype) - mu
        return Kobs, r

    def _solve_inputs(self, theta_full: torch.Tensor, data: Dataset):
        Kobs, r = self.obs_cov_and_resid(theta_full, data)
        if self.solve_dtype is not None:
            Kobs, r = Kobs.to(self.solve_dtype), r.to(self.solve_dtype)
        return Kobs, r

    def compute_K_L_alpha_ll(self, theta_full: torch.Tensor, data: Dataset) -> evidence.CholState:
        """Build K, factor it (in ``solve_dtype`` when given), alpha and the
        log marginal likelihood (the reference's cached quadruple);
        differentiable by autograd."""
        return evidence.gaussian_loglik(*self._solve_inputs(theta_full, data), self.diag_factor)

    def log_marginal(self, theta_full: torch.Tensor, data: Dataset) -> torch.Tensor:
        """The value of `compute_K_L_alpha_ll`'s ll, with the analytic
        backward (`evidence.loglik`)."""
        return evidence.loglik(*self._solve_inputs(theta_full, data), self.diag_factor)

    def log_posterior(self, theta_full: torch.Tensor, data: Dataset) -> torch.Tensor:
        lp = self.log_prior(theta_full)
        ll = torch.where(torch.isfinite(lp), self.log_marginal(theta_full, data), 0.0)
        return lp + ll

    def log_posterior_u(self, u_free: torch.Tensor, data: Dataset) -> torch.Tensor:
        """Unconstrained-space log posterior, ll + log prior + log|det J|."""
        u_full = self._u_full(u_free)
        theta = self.bijector.forward(u_full)
        return self.log_posterior(theta, data) + self.bijector.log_det_jac(u_full)

    # -- prediction -----------------------------------------------------------
    def _star_ids(self, data: Dataset, Xstar, nstar):
        """Star points (Ns, D) on the data's device, their order ids and
        the data's multi-index table with the star orders merged in."""
        Xs = torch.as_tensor(Xstar, dtype=data.Xf.dtype, device=data.device)
        if Xs.ndim < 2:
            Xs = Xs.reshape(1, -1)
        if Xs.shape[-1] != data.num_dim:
            if data.num_dim != 1:
                raise ValueError("Xstar dimensionality mismatch")
            Xs = Xs.reshape(-1, 1)
        ns = Xs.shape[0]
        arr = np.asarray(nstar)
        if arr.ndim == 0:
            mis = [normalize_multi_index(int(arr), data.num_dim)] * ns
        elif arr.ndim == 1 and data.num_dim == 1:
            if len(arr) == 1:
                mis = [normalize_multi_index(int(arr[0]), 1)] * ns
            else:
                mis = [normalize_multi_index(int(v), 1) for v in arr]
        elif arr.ndim == 1 and len(arr) == data.num_dim:
            mis = [normalize_multi_index([int(v) for v in arr], data.num_dim)] * ns
        elif arr.ndim == 2:
            mis = [normalize_multi_index([int(v) for v in row], data.num_dim) for row in arr]
        else:
            raise ValueError("bad nstar")
        table = _merge_multi_indices(data.multi_indices, mis)
        sid = torch.tensor([table.index(m) for m in mis], dtype=torch.int32,
                           device=data.device)
        return Xs, sid, table

    def predict(
        self,
        theta_full: torch.Tensor,
        data: Dataset,
        Xstar,
        n=0,
        noise: bool = False,
        return_std: bool = True,
        return_cov: bool = False,
        output_transform=None,
        state: Optional[evidence.CholState] = None,
    ) -> Prediction:
        """Posterior predictive at ``Xstar`` with derivative orders ``n``.

        ``noise=True`` adds the noise kernel to the predictive covariance;
        ``output_transform`` (M, Ns) maps the prediction linearly; ``state``
        is a `compute_K_L_alpha_ll` result to reuse. With transformed
        observations the star-data block is ``K_sf T^T``. With a theta batch
        (B, P) every output gains the leading B axis."""
        Xs, sid, table = self._star_ids(data, Xstar, n)
        if state is None:
            state = self.compute_K_L_alpha_ll(theta_full, data)
        tk = self._theta_k(theta_full)
        Ksf = assemble.cov_matrix(self.kernel, tk, Xs, sid, data.Xf, data.nid, table)
        if noise and self.noise_kernel is not None:
            Ksf = Ksf + assemble.cov_matrix(
                self.noise_kernel, self._theta_noise(theta_full), Xs, sid,
                data.Xf, data.nid, table,
            )
        if data.T is not None:
            Ksf = Ksf @ data.T.T.to(Ksf.dtype)  # star-observation block
        Ksf = Ksf.to(torch.promote_types(Ksf.dtype, state.L.dtype))  # solve_dtype
        if self.mean is not None:
            mu_star = self._mean_at(theta_full, Xs, sid, table)
        else:
            mu_star = torch.zeros(Ksf.shape[:-1], dtype=Ksf.dtype, device=Ksf.device)
        mean = mu_star + (Ksf @ state.alpha[..., None])[..., 0]

        std = cov = None
        if return_std or return_cov:
            Kss = assemble.cov_matrix(self.kernel, tk, Xs, sid, Xs, sid, table)
            if noise and self.noise_kernel is not None:
                Kss = Kss + assemble.cov_matrix(
                    self.noise_kernel, self._theta_noise(theta_full), Xs, sid, Xs,
                    sid, table,
                )
            V = torch.linalg.solve_triangular(state.L, Ksf.mT, upper=False)
            cov = Kss - V.mT @ V
        if output_transform is not None:
            O = torch.as_tensor(output_transform, dtype=mean.dtype, device=mean.device)
            mean = (O @ mean[..., None])[..., 0]
            if cov is not None:
                cov = O @ cov @ O.T
        if cov is not None:
            std = torch.sqrt(torch.clamp(torch.diagonal(cov, dim1=-2, dim2=-1), min=0.0))
        return Prediction(
            mean=mean,
            std=std if return_std else None,
            cov=cov if return_cov else None,
        )

    def draw_sample(
        self,
        generator: torch.Generator,
        theta_full: torch.Tensor,
        data: Dataset,
        Xstar,
        n=0,
        num_samp: int = 1,
        method: str = "cholesky",
        num_eig: Optional[int] = None,
        modify_sign: bool = False,
        noise: bool = False,
        output_transform=None,
        state: Optional[evidence.CholState] = None,
    ) -> torch.Tensor:
        """Joint posterior function draws, (num_points, num_samp) (a theta
        batch adds a leading axis), the normals from ``generator``.
        ``method``: ``"cholesky"`` (jittered factor) or ``"eig"`` (the
        ``num_eig`` largest modes); ``modify_sign`` flips each eigenvector
        so its largest-magnitude component is positive."""
        pred = self.predict(
            theta_full, data, Xstar, n=n, noise=noise, return_std=False,
            return_cov=True, output_transform=output_transform, state=state,
        )
        mean, cov = pred.mean, pred.cov
        z = torch.randn((mean.shape[-1], int(num_samp)), generator=generator,
                        dtype=mean.dtype, device=mean.device)
        if method == "cholesky":
            return mean[..., None] + evidence.chol_factor(cov, self.diag_factor) @ z
        if method != "eig":
            raise ValueError(f"unknown method {method!r}")
        w, V = torch.linalg.eigh(cov)
        if num_eig is not None:
            k = int(num_eig)
            w, V = w[..., -k:], V[..., -k:]
            z = z[: w.shape[-1]]
        if modify_sign:
            idx = torch.argmax(V.abs(), dim=-2, keepdim=True)
            signs = torch.sign(torch.gather(V, -2, idx))
            V = V * torch.where(signs == 0, 1.0, signs)
        w = torch.clamp(w, min=0.0)
        return mean[..., None] + V @ (torch.sqrt(w)[..., :, None] * z)


class GaussianProcess:
    """Stateful wrapper with the reference's API surface.

        >>> gp = GaussianProcess(SquaredExponentialKernel())   # on the card
        >>> gp.add_data(x, y, err_y=err)
        >>> gp.add_data(0.0, 0.0, n=1)         # slope constraint at the edge
        >>> gp.sample_hyperparameter_posterior(sampler="smc+chees", ...)
        >>> mean, std = gp.predict_MCMC(xstar)

    The data are built on ``device`` (the card unless ``"cpu"`` is given)
    in ``dtype`` (float64 unless given); theta lives there too.
    ``cov_backend`` is handed to `GPModel`.
    """

    def __init__(
        self,
        k: Kernel,
        noise_k: Optional[Kernel] = None,
        mu: Optional[MeanFunction] = None,
        diag_factor: float = 1e2,
        solve_dtype=None,
        cov_backend: str = "auto",
        device="cuda",
        dtype: torch.dtype = torch.float64,
    ):
        self.model = GPModel(k, noise_kernel=noise_k, mean=mu, diag_factor=diag_factor,
                             solve_dtype=solve_dtype, cov_backend=cov_backend)
        self.device = resolve_device(device)
        self.dtype = dtype
        self.builder = DatasetBuilder(k.num_dim)
        self._data: Optional[Dataset] = None
        self.theta = self._tensor(self.model.initial_params)
        self._state: Optional[evidence.CholState] = None
        self.sample_result = None  # the last sampler result

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    # -- data ---------------------------------------------------------------
    @property
    def num_dim(self):
        return self.model.kernel.num_dim

    @property
    def X(self):
        """Latent evaluation points (Q, D)."""
        return self.data.Xf

    @property
    def y(self):
        return self.data.y

    @property
    def err_y(self):
        return self.data.err_y

    @property
    def n(self):
        """Derivative multi-index of each point, (N, D) numpy."""
        return np.asarray([self.data.multi_indices[i] for i in self.data.nid.tolist()])

    @property
    def T(self):
        """Observation matrix (M, Q), or None."""
        return self.data.T

    @property
    def K(self):
        """Observation covariance at the current hyperparameters."""
        return self.model.obs_cov_and_resid(self.theta, self.data)[0]

    @property
    def L(self):
        return self.compute_K_L_alpha_ll().L

    @property
    def alpha(self):
        return self.compute_K_L_alpha_ll().alpha

    @property
    def params(self):
        """Current hyperparameter values."""
        return self.theta

    @property
    def free_params(self):
        return self.model.extract_free(self.theta)

    @free_params.setter
    def free_params(self, value):
        self.theta = self.model.embed_free(self._tensor(value))
        self._state = None

    @property
    def param_names(self):
        return self.model.param_names

    @property
    def free_param_names(self):
        return tuple(self.model.param_names[i] for i in self.model.free_idx)

    @property
    def param_bounds(self):
        """Live view of the concatenated component bounds: writes go
        through to the owning kernel or mean."""
        return self.model.param_bounds

    @property
    def free_param_bounds(self):
        """Live view of the free parameters' bounds."""
        return MaskedBounds(self.model.param_bounds, self.model.free_idx)

    @property
    def hyperprior(self):
        return self.model.hyperprior

    @property
    def k(self):
        return self.model.kernel

    @property
    def noise_k(self):
        return self.model.noise_kernel

    @property
    def mu(self):
        return self.model.mean

    def add_data(self, X, y, err_y=0.0, n=0, T=None):
        self.builder.add(X, y, err_y=err_y, n=n, T=T)
        self._data = None
        self._state = None
        return self

    @property
    def data(self) -> Dataset:
        if self._data is None:
            self._data = self.builder.build(self.dtype, self.device)
        return self._data

    def remove_outliers(self, thresh: float = 3.0) -> int:
        """Drop observations whose standardized residual exceeds
        ``thresh``, then refresh; returns the number removed."""
        data = self.data
        if data.T is not None:
            raise NotImplementedError(
                "remove_outliers with transformed observations is not supported"
            )
        with torch.no_grad():
            pred = self.model.predict(self.theta, data, data.Xf, n=0, return_std=True)
        err = data.err_y.cpu().numpy()
        resid = np.abs(data.y.cpu().numpy() - pred.mean.cpu().numpy())
        scale = np.sqrt(err**2 + pred.std.cpu().numpy() ** 2)
        keep = resid <= thresh * np.maximum(scale, 1e-300)
        n_removed = int((~keep).sum())
        if n_removed:
            nb = DatasetBuilder(data.num_dim)
            mi = [data.multi_indices[i] for i in data.nid.tolist()]
            nb.add(data.Xf.cpu().numpy()[keep], data.y.cpu().numpy()[keep],
                   err_y=err[keep], n=np.asarray([mi[i] for i in np.where(keep)[0]]))
            self.builder = nb
            self._data = None
            self._state = None
        return n_removed

    # -- likelihood ---------------------------------------------------------
    def update_hyperparameters(self, theta_full) -> torch.Tensor:
        """Set the parameters and return the negative log posterior (the
        MAP objective)."""
        self.theta = self._tensor(theta_full)
        self._state = None
        ll = self.model.log_marginal(self.theta, self.data)
        return -(ll + self.model.log_prior(self.theta))

    def compute_K_L_alpha_ll(self) -> evidence.CholState:
        if self._state is None:
            self._state = self.model.compute_K_L_alpha_ll(self.theta, self.data)
        return self._state

    @property
    def ll(self):
        return self.compute_K_L_alpha_ll().ll

    # -- inference ----------------------------------------------------------
    def optimize_hyperparameters(self, random_starts: int = 8,
                                 generator: Optional[torch.Generator] = None, **opt_kwargs):
        """Multi-start MAP (`infer.map_fit.optimize`: the current point and
        ``random_starts`` prior draws, all optimized at once by a batched
        L-BFGS); leaves the wrapper at the best start and returns the
        `MAPResult`. ``generator`` defaults to one seeded with 0 on the
        wrapper's device."""
        from gptools_tpu_torch.infer import map_fit

        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        result = map_fit.optimize(self.model, self.data, generator,
                                  random_starts=random_starts, **opt_kwargs)
        self.theta = result.theta
        self._state = None
        return result

    def sample_hyperparameter_posterior(
        self,
        nsamp: int = 1000,
        burn: int = 500,
        num_chains: int = 8,
        sampler: str = "nuts",
        sampler_type: Optional[str] = None,
        thin: int = 1,
        generator: Optional[torch.Generator] = None,
        **kwargs,
    ):
        """Sample the hyperparameter posterior (`infer.run_sampler`). The
        reference's spellings ``sampler_type``, ``nwalkers``, ``ntemps``
        and ``num_proc`` are accepted; ``generator`` defaults to one seeded
        with 0 on the wrapper's device."""
        from gptools_tpu_torch.infer import run_sampler

        if sampler_type is not None:
            sampler = {"ensemble": "nuts"}.get(sampler_type, sampler_type)
        if "ntemps" in kwargs:
            kwargs["num_temps"] = kwargs.pop("ntemps")
        if "nwalkers" in kwargs:
            num_chains = kwargs.pop("nwalkers")
        kwargs.pop("num_proc", None)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        result = run_sampler(
            self.model, self.data, generator, sampler=sampler, num_chains=num_chains,
            num_samples=nsamp, num_warmup=burn, **kwargs,
        )
        if thin > 1:
            result = result._replace(
                u=result.u[:, ::thin],
                thetas=None if result.thetas is None else result.thetas[:, ::thin],
                log_prob=result.log_prob[:, ::thin],
            )
        self.sample_result = result
        return result

    # -- prediction ---------------------------------------------------------
    def predict(
        self,
        Xstar,
        n=0,
        noise: bool = False,
        return_std: bool = True,
        return_cov: bool = False,
        output_transform=None,
        use_MCMC: bool = False,
        **mcmc_kwargs,
    ):
        """``(mean, std)`` by default, ``(mean, cov)`` with ``return_cov``,
        or just ``mean``; ``use_MCMC`` marginalizes over the posterior
        samples (`predict_MCMC`)."""
        if use_MCMC:
            return self.predict_MCMC(
                Xstar, n=n, noise=noise, return_std=return_std, return_cov=return_cov,
                output_transform=output_transform, **mcmc_kwargs,
            )
        pred = self.model.predict(
            self.theta, self.data, Xstar, n=n, noise=noise,
            return_std=return_std or return_cov, return_cov=return_cov,
            output_transform=output_transform, state=self.compute_K_L_alpha_ll(),
        )
        if return_cov:
            return pred.mean, pred.cov
        if return_std:
            return pred.mean, pred.std
        return pred.mean

    def draw_sample(self, Xstar, num_samp: int = 1,
                    generator: Optional[torch.Generator] = None, **kwargs):
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return self.model.draw_sample(
            generator, self.theta, self.data, Xstar, num_samp=num_samp,
            state=self.compute_K_L_alpha_ll(), **kwargs,
        )

    # -- fully-Bayesian prediction -------------------------------------------
    def _mcmc_thetas(self, thetas, thin: int) -> torch.Tensor:
        if thetas is None:
            if self.sample_result is None:
                raise ValueError("no MCMC samples available; run "
                                 "sample_hyperparameter_posterior first")
            thetas = self.sample_result.thetas
        return self._tensor(thetas).reshape(-1, self.model.num_params)[::thin]

    def compute_from_MCMC(self, Xstar, thetas=None, n=0, noise=False, thin=1):
        """Per-sample predictive means and stds, (S, Ns) each: one batched
        factorization and prediction over the S thetas."""
        th = self._mcmc_thetas(thetas, thin)
        pred = self.model.predict(th, self.data, Xstar, n=n, noise=noise,
                                  return_std=True, return_cov=False)
        return pred.mean, pred.std

    def predict_MCMC(self, Xstar, n=0, noise=False, return_std=True, return_cov=False,
                     output_transform=None, thetas=None, thin=1):
        """Predictive moments marginalized over the posterior samples (law
        of total mean and variance)."""
        th = self._mcmc_thetas(thetas, thin)
        preds = self.model.predict(
            th, self.data, Xstar, n=n, noise=noise, return_std=not return_cov,
            return_cov=return_cov, output_transform=output_transform,
        )
        mean = preds.mean.mean(0)
        if return_cov:
            dm = preds.mean - mean
            return mean, preds.cov.mean(0) + (dm.T @ dm) / preds.mean.shape[0]
        if return_std:
            var = (preds.std**2 + preds.mean**2).mean(0) - mean**2
            return mean, torch.sqrt(torch.clamp(var, min=0.0))
        return mean

    # -- serving --------------------------------------------------------------
    def freeze_predictor(self, bucket: int = 64):
        """A predictor with (L, alpha) precomputed at the current
        hyperparameters (`models.serve.FrozenPredictor`)."""
        from gptools_tpu_torch.models.serve import FrozenPredictor

        return FrozenPredictor(self.model, self.data, self.theta, bucket=bucket)

    def freeze_mcmc_predictor(self, thetas=None, max_samples: int = 512):
        """A posterior-marginalized predictor with a batch of states
        precomputed (`models.serve.FrozenMCMCPredictor`)."""
        from gptools_tpu_torch.models.serve import FrozenMCMCPredictor

        if thetas is None:
            if self.sample_result is None:
                raise ValueError("no MCMC samples available")
            thetas = self.sample_result.thetas
        return FrozenMCMCPredictor(self.model, self.data, thetas, max_samples=max_samples)

    # -- diagnostics ---------------------------------------------------------
    def compute_ll_matrix(self, bounds: Sequence[tuple], num_pts) -> tuple:
        """The log posterior on a grid over the free parameters, in one
        batched call. Returns ``(ll_grid, axes)``, ``ll_grid`` of shape
        ``num_pts``."""
        nf = self.model.num_free_params
        if len(bounds) != nf:
            raise ValueError(f"need {nf} bounds")
        if isinstance(num_pts, int):
            num_pts = [num_pts] * nf
        axes = [torch.linspace(lo, hi, int(k), dtype=self.dtype, device=self.device)
                for (lo, hi), k in zip(bounds, num_pts)]
        grids = torch.meshgrid(*axes, indexing="ij")
        flat = torch.stack([g.reshape(-1) for g in grids], dim=-1)
        vals = self.model.log_posterior(self.model.embed_free(flat), self.data)
        return vals.reshape([int(v) for v in num_pts]), axes
