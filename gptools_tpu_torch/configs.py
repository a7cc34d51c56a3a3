"""The flagship benchmark configuration, config 4.

Counterpart of `gptools_tpu.configs.config4_gibbs_smc`: the same numpy data
generation (a 25-point pedestal profile plus two slope constraints, N = 27)
and the same prior, built on an explicit device and dtype. Configs 1-3 and
5 are ROADMAP Queue 1 item 15.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["BaselineProblem", "config4_gibbs_smc"]


@dataclasses.dataclass(frozen=True)
class BaselineProblem:
    """A fully specified inference problem: model + data + recommended
    inference settings."""

    name: str
    description: str
    model: object            # GPModel
    data: object             # Dataset
    sampler: Optional[str]
    sampler_kwargs: dict
    truth: dict


def _pedestal_profile(x, x0=0.9, lam=0.05):
    prof = 1.0 - 0.5 * np.minimum(x, x0) ** 2
    edge = x > x0
    return np.where(edge, (1.0 - 0.5 * x0**2) * np.exp(-(x - x0) / lam), prof)


def config4_gibbs_smc(
    seed: int = 0,
    n_points: int = 25,
    dtype: torch.dtype = torch.float64,
    device="cpu",
) -> BaselineProblem:
    """Gibbs tanh-warp kernel profile fit with edge derivative constraints."""
    from gptools_tpu_torch.models.dataset import DatasetBuilder
    from gptools_tpu_torch.models.gp import GPModel
    from gptools_tpu_torch.ops.kernels import GibbsKernel1dTanh
    from gptools_tpu_torch.utils.priors import LogNormalJointPrior, UniformJointPrior

    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 1.2, n_points)
    prof = _pedestal_profile(x)
    err = 0.03
    y = prof + err * rng.standard_normal(n_points)
    b = DatasetBuilder(1)
    b.add(x, y, err_y=err)
    b.add(np.array([0.0]), np.array([0.0]), err_y=0.01, n=1)
    b.add(np.array([1.2]), np.array([0.0]), err_y=0.05, n=1)
    prior = (
        LogNormalJointPrior([0.0], [0.75])
        * LogNormalJointPrior([-1.0], [0.6])
        * LogNormalJointPrior([-2.3], [0.6])
        * LogNormalJointPrior([-2.3], [0.6])
        * UniformJointPrior([0.6], [1.1])
    )
    model = GPModel(GibbsKernel1dTanh(hyperprior=prior))
    return BaselineProblem(
        name="config4_gibbs_smc",
        description="Gibbs tanh kernel profile fit with edge derivative "
        "constraints; SMC",
        model=model,
        data=b.build(dtype, device),
        sampler="smc",
        sampler_kwargs=dict(num_particles=2048, num_mutations=8),
        truth=dict(profile=prof, X=x, err=err),
    )
