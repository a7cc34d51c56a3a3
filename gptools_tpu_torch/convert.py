"""Carry the JAX package's objects across to this one.

The functions read the reference objects by duck typing (attribute names
and ``np.asarray`` on their arrays), so this module imports no jax: a
`gptools_tpu` model and dataset become their `gptools_tpu_torch`
counterparts, and both packages can be driven with the same problem.
"""

from __future__ import annotations

import numpy as np
import torch

from gptools_tpu_torch.models import mean as means
from gptools_tpu_torch.models.dataset import Dataset
from gptools_tpu_torch.models.gp import GPModel
from gptools_tpu_torch.ops import kernels
from gptools_tpu_torch.utils import priors

__all__ = ["dataset_from_jax", "model_from_jax", "thetas_from_numpy"]

_MEANS = {
    "ConstantMeanFunction": means.ConstantMeanFunction,
    "LinearMeanFunction": means.LinearMeanFunction,
    "MtanhMeanFunction1d": means.MtanhMeanFunction1d,
}


def thetas_from_numpy(a, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def dataset_from_jax(data, dtype: torch.dtype, device) -> Dataset:
    """A `gptools_tpu.models.dataset.Dataset` as a `Dataset` on ``device``,
    with its observation matrix T when it has one."""
    T = getattr(data, "T", None)
    return Dataset(
        thetas_from_numpy(data.Xf, dtype, device),
        torch.tensor(np.asarray(data.nid, dtype=np.int32), device=device),
        thetas_from_numpy(data.y, dtype, device),
        thetas_from_numpy(data.err_y, dtype, device),
        data.multi_indices,
        T=None if T is None else thetas_from_numpy(T, dtype, device),
    )


def _prior_from_jax(prior):
    if prior is None:
        return None
    parts = []
    for p in getattr(prior, "parts", (prior,)):
        name = type(p).__name__
        if name == "LogNormalJointPrior":
            parts.append(priors.LogNormalJointPrior(p.mu, p.sigma))
        elif name == "NormalJointPrior":
            parts.append(priors.NormalJointPrior(p.mu, p.sigma))
        elif name == "UniformJointPrior":
            parts.append(priors.UniformJointPrior(p.lb, p.ub))
        else:
            raise NotImplementedError(f"{name} is ROADMAP Queue 1 item 11")
    return parts[0] if len(parts) == 1 else priors.ProductJointPrior(parts)


def _meta(obj) -> dict:
    """The parameter metadata every kernel and mean takes as keywords."""
    return dict(
        hyperprior=_prior_from_jax(obj.hyperprior),
        initial_params=tuple(obj.initial_params),
        fixed_params=tuple(obj.fixed_params),
        param_bounds=list(obj.param_bounds),
    )


def _warp_from_jax(w):
    name = type(w).__name__
    if name == "BetaWarp":
        return kernels.BetaWarp()
    if name == "LinearWarp":
        return kernels.LinearWarp(w.a, w.b)
    raise NotImplementedError(f"input warp {name} is ROADMAP Queue 1 item 11")


def _kernel_from_jax(k):
    name = type(k).__name__
    if name == "GibbsKernel1dTanh":
        return kernels.GibbsKernel1dTanh(**_meta(k))
    if name == "SquaredExponentialKernel":
        return kernels.SquaredExponentialKernel(k.num_dim, **_meta(k))
    if name == "Matern52Kernel":
        return kernels.Matern52Kernel(k.num_dim, **_meta(k))
    if name == "MaternKernel":
        return kernels.MaternKernel(k.nu, k.num_dim, **_meta(k))
    if name == "DiagonalNoiseKernel":
        return kernels.DiagonalNoiseKernel(k.num_dim, n=k.n_match, **_meta(k))
    if name == "WarpedKernel":
        return kernels.WarpedKernel(
            _kernel_from_jax(k.base), _warp_from_jax(k.input_warp), **_meta(k)
        )
    raise NotImplementedError(f"{name} is ROADMAP Queue 1 item 11")


def _mean_from_jax(m):
    name = type(m).__name__
    if name not in _MEANS:
        raise NotImplementedError(f"mean {name} is ROADMAP Queue 1 item 11")
    if name == "MtanhMeanFunction1d":
        return _MEANS[name](**_meta(m))
    return _MEANS[name](m.num_dim, **_meta(m))


def _dtype_from_jax(dtype):
    """A numpy-compatible dtype (the reference's ``solve_dtype``) as the
    torch dtype of the same name; None stays None."""
    return None if dtype is None else getattr(torch, np.dtype(dtype).name)


def model_from_jax(model) -> GPModel:
    """A `gptools_tpu.models.gp.GPModel` as a `GPModel`: kernel, noise
    kernel and mean types, prior parts, initial and fixed parameters,
    bounds, ``diag_factor``, ``solve_dtype``, ``cov_backend`` and
    ``evidence_backend``."""
    nk = getattr(model, "noise_kernel", None)
    mu = getattr(model, "mean", None)
    return GPModel(
        _kernel_from_jax(model.kernel),
        noise_kernel=None if nk is None else _kernel_from_jax(nk),
        mean=None if mu is None else _mean_from_jax(mu),
        diag_factor=model.diag_factor,
        solve_dtype=_dtype_from_jax(getattr(model, "solve_dtype", None)),
        cov_backend=getattr(model, "cov_backend", "auto"),
        evidence_backend=getattr(model, "evidence_backend", "auto"),
    )
