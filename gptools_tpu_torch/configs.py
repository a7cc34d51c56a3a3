"""Benchmark configurations 1 to 5.

Counterparts of `gptools_tpu.configs`: the same numpy data generation from
the seed, the same priors and the same ``sampler`` / ``sampler_kwargs``
metadata, built in a given dtype on the card unless the caller passes
``device="cpu"``. Config 1 is an SE GP on 40 values of sin 2x, fitted by
MAP alone (``sampler`` None, 8 random starts), config 2 is an SE GP with two slope constraints (N = 32),
config 3 a BetaWarp-ed Matern-5/2 GP with a linear mean (N = 35), config 4
the Gibbs-tanh pedestal fit (N = 27), config 5 the same model family with
a line-integral observation (M = 32 observations of Q = 47 latent points,
through the observation matrix T). The reference runs config 5's 1024
chains sharded over a mesh; here they run on one card, or sharded over
cards through ``mesh=`` (`parallel`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gptools_tpu_torch.models.dataset import resolve_device

__all__ = [
    "BaselineProblem",
    "config1_se_map",
    "config2_se_deriv_nuts",
    "config3_matern_mean_warp_hmc",
    "config4_gibbs_smc",
    "config5_multihost_profile",
    "ALL_CONFIGS",
]


@dataclasses.dataclass(frozen=True)
class BaselineProblem:
    """A fully specified inference problem: model + data + recommended
    inference settings."""

    name: str
    description: str
    model: object            # GPModel
    data: object             # Dataset
    sampler: Optional[str]   # None: MAP only
    sampler_kwargs: dict
    truth: dict


def config1_se_map(
    seed: int = 0,
    n_points: int = 40,
    dtype: torch.dtype = torch.float64,
    device="cuda",
) -> BaselineProblem:
    """1-D SE GP regression, MAP hyperparameter fit."""
    from gptools_tpu_torch.models.dataset import DatasetBuilder
    from gptools_tpu_torch.models.gp import GPModel
    from gptools_tpu_torch.ops.kernels import SquaredExponentialKernel
    from gptools_tpu_torch.utils.priors import LogNormalJointPrior

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    X = np.linspace(0, 3, n_points)
    f = np.sin(2.0 * X)
    err = 0.1
    y = f + err * rng.standard_normal(n_points)
    b = DatasetBuilder(1)
    b.add(X, y, err_y=err)
    model = GPModel(
        SquaredExponentialKernel(
            hyperprior=LogNormalJointPrior([0.0, -0.7], [1.0, 1.0])
        )
    )
    return BaselineProblem(
        name="config1_se_map",
        description="1D SE-kernel GP regression, MAP fit",
        model=model,
        data=b.build(dtype, dev),
        sampler=None,
        sampler_kwargs=dict(random_starts=8),
        truth=dict(f=f, X=X, err=err),
    )


def config2_se_deriv_nuts(
    seed: int = 0,
    n_points: int = 30,
    dtype: torch.dtype = torch.float64,
    device="cuda",
) -> BaselineProblem:
    """SE GP with derivative (slope-constraint) observations at both ends."""
    from gptools_tpu_torch.models.dataset import DatasetBuilder
    from gptools_tpu_torch.models.gp import GPModel
    from gptools_tpu_torch.ops.kernels import SquaredExponentialKernel
    from gptools_tpu_torch.utils.priors import LogNormalJointPrior

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    X = np.linspace(0, 3, n_points)
    f = np.sin(1.5 * X)
    err = 0.1
    y = f + err * rng.standard_normal(n_points)
    b = DatasetBuilder(1)
    b.add(X, y, err_y=err)
    b.add(np.array([0.0]), np.array([1.5]), err_y=0.05, n=1)
    b.add(np.array([3.0]), np.array([1.5 * np.cos(4.5)]), err_y=0.05, n=1)
    model = GPModel(
        SquaredExponentialKernel(
            hyperprior=LogNormalJointPrior([0.0, -0.5], [0.75, 0.75])
        )
    )
    return BaselineProblem(
        name="config2_se_deriv_nuts",
        description="SE GP with derivative observations; NUTS",
        model=model,
        data=b.build(dtype, dev),
        sampler="nuts",
        sampler_kwargs=dict(num_chains=8, num_warmup=500, num_samples=1000),
        truth=dict(f=f, X=X, err=err),
    )


def config3_matern_mean_warp_hmc(
    seed: int = 0,
    n_points: int = 35,
    dtype: torch.dtype = torch.float64,
    device="cuda",
) -> BaselineProblem:
    """Matern-5/2 GP + linear mean + beta-CDF input warping."""
    from gptools_tpu_torch.models.dataset import DatasetBuilder
    from gptools_tpu_torch.models.gp import GPModel
    from gptools_tpu_torch.models.mean import LinearMeanFunction
    from gptools_tpu_torch.ops.kernels import BetaWarp, Matern52Kernel, WarpedKernel
    from gptools_tpu_torch.utils.priors import (
        LogNormalJointPrior,
        NormalJointPrior,
        UniformJointPrior,
    )

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    X = np.linspace(0.02, 0.98, n_points)
    f = 0.8 * X + 0.3 * np.sin(8.0 * X**2)
    err = 0.05
    y = f + err * rng.standard_normal(n_points)
    b = DatasetBuilder(1)
    b.add(X, y, err_y=err)
    kern = WarpedKernel(
        Matern52Kernel(hyperprior=LogNormalJointPrior([0.0, -1.0], [0.75, 0.75])),
        BetaWarp(),
        hyperprior=LogNormalJointPrior([0.0, -1.0], [0.75, 0.75])
        * UniformJointPrior([0.3, 0.3], [3.0, 3.0]),
    )
    mean = LinearMeanFunction(hyperprior=NormalJointPrior([0.0, 0.0], [2.0, 2.0]))
    return BaselineProblem(
        name="config3_matern_mean_warp_hmc",
        description="Matern-5/2 + mean function + input warping; multi-chain HMC",
        model=GPModel(kern, mean=mean),
        data=b.build(dtype, dev),
        sampler="hmc",
        sampler_kwargs=dict(num_chains=16, num_warmup=500, num_samples=800),
        truth=dict(f=f, X=X, err=err),
    )


def _pedestal_profile(x, x0=0.9, lam=0.05):
    prof = 1.0 - 0.5 * np.minimum(x, x0) ** 2
    edge = x > x0
    return np.where(edge, (1.0 - 0.5 * x0**2) * np.exp(-(x - x0) / lam), prof)


def config4_gibbs_smc(
    seed: int = 0,
    n_points: int = 25,
    dtype: torch.dtype = torch.float64,
    device="cuda",
) -> BaselineProblem:
    """Gibbs tanh-warp kernel profile fit with edge derivative constraints."""
    from gptools_tpu_torch.models.dataset import DatasetBuilder
    from gptools_tpu_torch.models.gp import GPModel
    from gptools_tpu_torch.ops.kernels import GibbsKernel1dTanh
    from gptools_tpu_torch.utils.priors import LogNormalJointPrior, UniformJointPrior

    dev = resolve_device(device)
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
        data=b.build(dtype, dev),
        sampler="smc",
        sampler_kwargs=dict(num_particles=2048, num_mutations=8),
        truth=dict(profile=prof, X=x, err=err),
    )


def config5_multihost_profile(
    seed: int = 0,
    n_points: int = 30,
    dtype: torch.dtype = torch.float64,
    device="cuda",
) -> BaselineProblem:
    """Tokamak-style profile fit with a line-integrated observation over
    the chord (16 quadrature points, a dense row of T) and 1024 chains
    through ``smc+chees``; the priors of config 4."""
    from gptools_tpu_torch.models.dataset import DatasetBuilder
    from gptools_tpu_torch.models.gp import GPModel
    from gptools_tpu_torch.ops.kernels import GibbsKernel1dTanh
    from gptools_tpu_torch.utils.priors import LogNormalJointPrior, UniformJointPrior

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 1.2, n_points)
    prof = _pedestal_profile(x)
    err = 0.03
    y = prof + err * rng.standard_normal(n_points)
    b = DatasetBuilder(1)
    b.add(x, y, err_y=err)
    b.add(np.array([0.0]), np.array([0.0]), err_y=0.01, n=1)
    xq = np.linspace(0.0, 1.2, 16)
    w = np.full(16, 1.2 / 16)
    true_integral = np.trapezoid(_pedestal_profile(xq), xq)
    b.add(xq, y=[true_integral + 0.02 * rng.standard_normal()], T=w[None, :], err_y=0.02)
    prior = (
        LogNormalJointPrior([0.0], [0.75])
        * LogNormalJointPrior([-1.0], [0.6])
        * LogNormalJointPrior([-2.3], [0.6])
        * LogNormalJointPrior([-2.3], [0.6])
        * UniformJointPrior([0.6], [1.1])
    )
    return BaselineProblem(
        name="config5_multihost_profile",
        description="1024 chains on a tokamak-style profile fit with a "
        "line-integral observation",
        model=GPModel(GibbsKernel1dTanh(hyperprior=prior)),
        data=b.build(dtype, dev),
        sampler="smc+chees",
        sampler_kwargs=dict(num_chains=1024, num_warmup=100, num_samples=300),
        truth=dict(profile=prof, X=x, err=err, integral=true_integral),
    )


ALL_CONFIGS = {
    1: config1_se_map,
    2: config2_se_deriv_nuts,
    3: config3_matern_mean_warp_hmc,
    4: config4_gibbs_smc,
    5: config5_multihost_profile,
}
