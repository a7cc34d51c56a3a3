"""Config 3: a Matern-5/2 GP under a beta-CDF input warp with a linear mean.

`make_data` is a NumPy copy of the data the repository's config 3 makes
(35 noisy values of 0.8 x + 0.3 sin(8 x^2) on [0.02, 0.98]); `program`
builds the model from those arrays through the port's public API;
`reference` gives the plain float64 posterior of the same arrays.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def make_data(cfg: dict) -> dict:
    """Observed rows: x, derivative order, y and err."""
    rng = np.random.default_rng(cfg["data_seed"])
    x = np.linspace(cfg["x_lo"], cfg["x_hi"], cfg["n_points"])
    f = 0.8 * x + 0.3 * np.sin(8.0 * x**2)
    y = f + cfg["err_y"] * rng.standard_normal(cfg["n_points"])
    return {"x": x, "order": np.zeros(x.size, np.int64), "y": y,
            "err": np.full(x.size, cfg["err_y"])}


def program(cfg: dict, arrays: dict, dtype, device):
    """(model, data) of the program under test."""
    from gptools_tpu_torch.models.dataset import DatasetBuilder
    from gptools_tpu_torch.models.gp import GPModel
    from gptools_tpu_torch.models.mean import LinearMeanFunction
    from gptools_tpu_torch.ops.kernels import BetaWarp, Matern52Kernel, WarpedKernel
    from gptools_tpu_torch.utils.priors import (
        LogNormalJointPrior,
        NormalJointPrior,
        UniformJointPrior,
    )

    (_, m0, s0), (_, m1, s1), (_, a_lo, a_hi), (_, b_lo, b_hi), mean_a, mean_b = cfg["priors"]
    kern_prior = LogNormalJointPrior([m0, m1], [s0, s1]) * UniformJointPrior(
        [a_lo, b_lo], [a_hi, b_hi])
    kern = WarpedKernel(Matern52Kernel(hyperprior=LogNormalJointPrior([m0, m1], [s0, s1])),
                        BetaWarp(), hyperprior=kern_prior)
    mean = LinearMeanFunction(hyperprior=NormalJointPrior([mean_a[1], mean_b[1]],
                                                          [mean_a[2], mean_b[2]]))
    b = DatasetBuilder(1)
    b.add(arrays["x"], arrays["y"], err_y=arrays["err"])
    model = GPModel(kern, mean=mean, diag_factor=cfg["diag_factor"])
    return model, b.build(dtype, device)


def _warped_matern52(x1, x2, th):
    """sigma_f^2 (1 + s + s^2 / 3) exp(-s), s = sqrt(5) |w(x) - w(x')| / l,
    w(x) = I_x(a, b)."""
    from benchmark.reference.special import betainc

    sf, ell, a, b = (th[..., i] for i in range(4))
    d = betainc(a, b, x1) - betainc(a, b, x2)
    zero = d == 0
    s = math.sqrt(5.0) * torch.abs(torch.where(zero, torch.ones_like(d), d)) / ell
    k = (1.0 + s + s * s / 3.0) * torch.exp(-s)
    return sf * sf * torch.where(zero, torch.ones_like(k), k)


def _linear_mean(x, th):
    return th[..., 4] * x + th[..., 5]


def reference(cfg: dict, arrays: dict, device):
    """The plain float64 posterior of the same arrays."""
    from benchmark.reference.gp import GPPosterior, Priors

    return GPPosterior(Priors(cfg["priors"]), _warped_matern52, arrays["x"], arrays["order"],
                       arrays["y"], arrays["err"], mean=_linear_mean,
                       diag_factor=cfg["diag_factor"], device=device)
