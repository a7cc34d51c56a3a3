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

_CALLABLE = ("ArbitraryKernel", "ChainRuleKernel", "ArbitraryWarp", "ArbitraryMeanFunction")


def _refuse(name):
    """A type the port has no counterpart for, or one that holds a JAX
    callable (which cannot be carried across)."""
    if name in _CALLABLE:
        raise TypeError(
            f"{name} holds a JAX callable, which cannot be carried across: build the "
            f"port's {name} with a torch callable instead"
        )
    raise TypeError(f"{name} has no counterpart in gptools_tpu_torch")


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


def _dist_from_jax(d):
    """One of the reference's 1-D distributions of `IndependentJointPrior`."""
    name = type(d).__name__
    p = getattr(d, "_p", None)
    if name == "Uniform":
        return priors.Uniform(*d.bounds)
    if name in ("Normal", "LogNormal"):
        return getattr(priors, name)(p.mu[0], p.sigma[0])
    if name == "Gamma":
        return priors.Gamma(p.a[0], p.b[0])
    if name == "Exponential":
        return priors.Exponential(p.rate[0])
    _refuse(name)


def _part_from_jax(p):
    name = type(p).__name__
    if name in ("LogNormalJointPrior", "NormalJointPrior"):
        return getattr(priors, name)(p.mu, p.sigma)
    if name == "UniformJointPrior":
        return priors.UniformJointPrior(p.lb, p.ub)
    if name == "GammaJointPriorAlt":
        return priors.GammaJointPriorAlt(p.mode, p.std)
    if name == "ExponentialJointPrior":
        return priors.ExponentialJointPrior(p.rate)
    if name == "GammaJointPrior":
        return priors.GammaJointPrior(p.a, p.b)
    if name in ("SortedUniformJointPrior", "CoreEdgeJointPrior"):
        return getattr(priors, name)(p.dim, p.lb, p.ub)
    if name == "IndependentJointPrior":
        return priors.IndependentJointPrior([_dist_from_jax(d) for d in p.univariates])
    _refuse(name)


def _prior_from_jax(prior):
    if prior is None:
        return None
    parts = [_part_from_jax(p) for p in getattr(prior, "parts", (prior,))]
    return parts[0] if len(parts) == 1 else priors.ProductJointPrior(parts)


def _meta(obj) -> dict:
    """The parameter metadata every kernel and mean takes as keywords."""
    return dict(
        hyperprior=_prior_from_jax(obj.hyperprior),
        initial_params=tuple(obj.initial_params),
        fixed_params=tuple(obj.fixed_params),
        param_bounds=list(obj.param_bounds),
    )


def _with_meta(obj, ref):
    """``obj`` (a combination built from its parts) with ``ref``'s own
    metadata, which may have been changed after it was built."""
    for key, value in _meta(ref).items():
        setattr(obj, key, value)
    return obj


def _warp_from_jax(w):
    name = type(w).__name__
    if name == "BetaWarp":
        return kernels.BetaWarp()
    if name == "LinearWarp":
        return kernels.LinearWarp(w.a, w.b)
    _refuse(name)


def _length_warp_from_jax(w):
    name = type(w).__name__
    if name == "InterpolatedWarp":
        return kernels.InterpolatedWarp(w.knots)
    if name in ("TanhWarp", "GaussWarp", "ExpWarp"):
        return getattr(kernels, name)()
    _refuse(name)


_PLAIN_KERNELS = ("SquaredExponentialKernel", "Matern52Kernel", "MaternGeneralKernel",
                  "RationalQuadraticKernel", "ConstantKernel")


def _kernel_from_jax(k):
    name = type(k).__name__
    if name in ("GibbsKernel1dTanh", "GibbsKernel1dGauss", "GibbsKernel1dExp"):
        return getattr(kernels, name)(**_meta(k))
    if name == "GibbsKernel":
        return kernels.GibbsKernel(_length_warp_from_jax(k.warp), **_meta(k))
    if name in _PLAIN_KERNELS:
        return getattr(kernels, name)(k.num_dim, **_meta(k))
    if name == "MaternKernel":
        return kernels.MaternKernel(k.nu, k.num_dim, **_meta(k))
    if name == "ZeroKernel":
        return kernels.ZeroKernel(k.num_dim)
    if name == "DiagonalNoiseKernel":
        return kernels.DiagonalNoiseKernel(k.num_dim, n=k.n_match, **_meta(k))
    if name == "WarpedKernel":
        return kernels.WarpedKernel(
            _kernel_from_jax(k.base), _warp_from_jax(k.input_warp), **_meta(k)
        )
    if name in ("SumKernel", "ProductKernel"):
        combined = getattr(kernels, name)(_kernel_from_jax(k.k1), _kernel_from_jax(k.k2))
        return _with_meta(combined, k)
    if name == "ScaledKernel":
        return _with_meta(kernels.ScaledKernel(_kernel_from_jax(k.base), k.factor), k)
    if name == "MaskedKernel":
        return _with_meta(
            kernels.MaskedKernel(_kernel_from_jax(k.base), k.num_dim, k.active_dims), k)
    _refuse(name)


def _mean_from_jax(m):
    name = type(m).__name__
    if name == "SumMeanFunction":
        return _with_meta(means.SumMeanFunction(_mean_from_jax(m.m1), _mean_from_jax(m.m2)), m)
    if name == "MtanhMeanFunction1d":
        return means.MtanhMeanFunction1d(**_meta(m))
    if name in ("ConstantMeanFunction", "LinearMeanFunction"):
        return getattr(means, name)(m.num_dim, **_meta(m))
    _refuse(name)


def _dtype_from_jax(dtype):
    """A numpy-compatible dtype (the reference's ``solve_dtype``) as the
    torch dtype of the same name; None stays None."""
    return None if dtype is None else getattr(torch, np.dtype(dtype).name)


def model_from_jax(model) -> GPModel:
    """A `gptools_tpu.models.gp.GPModel` as a `GPModel`: kernel, noise
    kernel and mean types (combinations recursively), prior parts, initial
    and fixed parameters, bounds, ``diag_factor``, ``solve_dtype``,
    ``cov_backend`` and ``evidence_backend``. A part that holds a JAX
    callable (`ArbitraryKernel`, `ChainRuleKernel`, `ArbitraryWarp`,
    `ArbitraryMeanFunction`) raises `TypeError`: the port's classes of the
    same names take torch callables."""
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
