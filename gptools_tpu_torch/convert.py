"""Carry the JAX package's objects across to this one.

The functions read the reference objects by duck typing (attribute names
and ``np.asarray`` on their arrays), so this module imports no jax: a
`gptools_tpu` model and dataset become their `gptools_tpu_torch`
counterparts, and both packages can be driven with the same problem.
"""

from __future__ import annotations

import numpy as np
import torch

from gptools_tpu_torch.models.dataset import Dataset
from gptools_tpu_torch.models.gp import GPModel
from gptools_tpu_torch.ops import kernels
from gptools_tpu_torch.utils import priors

__all__ = ["dataset_from_jax", "model_from_jax", "thetas_from_numpy"]

_KERNELS = {"GibbsKernel1dTanh": kernels.GibbsKernel1dTanh}


def thetas_from_numpy(a, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def dataset_from_jax(data, dtype: torch.dtype, device) -> Dataset:
    """A `gptools_tpu.models.dataset.Dataset` as a `Dataset` on ``device``."""
    if getattr(data, "T", None) is not None:
        raise NotImplementedError(
            "transformed observations (T) are ROADMAP Queue 1 item 10"
        )
    return Dataset(
        thetas_from_numpy(data.Xf, dtype, device),
        torch.tensor(np.asarray(data.nid, dtype=np.int32), device=device),
        thetas_from_numpy(data.y, dtype, device),
        thetas_from_numpy(data.err_y, dtype, device),
        data.multi_indices,
    )


def _prior_from_jax(prior):
    parts = []
    for p in getattr(prior, "parts", (prior,)):
        name = type(p).__name__
        if name == "LogNormalJointPrior":
            parts.append(priors.LogNormalJointPrior(p.mu, p.sigma))
        elif name == "UniformJointPrior":
            parts.append(priors.UniformJointPrior(p.lb, p.ub))
        else:
            raise NotImplementedError(f"{name} is ROADMAP Queue 1 item 11")
    return parts[0] if len(parts) == 1 else priors.ProductJointPrior(parts)


def model_from_jax(model) -> GPModel:
    """A `gptools_tpu.models.gp.GPModel` as a `GPModel`: kernel type, prior
    parts, initial and fixed parameters, bounds and ``diag_factor``."""
    if getattr(model, "noise_kernel", None) is not None or getattr(model, "mean", None) is not None:
        raise NotImplementedError(
            "noise kernels and mean functions are ROADMAP Queue 1 item 9"
        )
    k = model.kernel
    name = type(k).__name__
    if name not in _KERNELS:
        raise NotImplementedError(f"{name} is ROADMAP Queue 1 items 9-11")
    kernel = _KERNELS[name](
        hyperprior=_prior_from_jax(k.hyperprior),
        initial_params=tuple(k.initial_params),
        fixed_params=tuple(k.fixed_params),
        param_bounds=list(k.param_bounds),
    )
    return GPModel(kernel, diag_factor=model.diag_factor)
