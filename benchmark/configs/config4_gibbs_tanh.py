"""Config 4: the Gibbs-tanh pedestal fit with slope constraints.

`make_data` is a NumPy copy of the data the repository's config 4 makes
(a pedestal profile, 25 noisy values on [0, 1.2], two slope rows);
`program` builds the model from those arrays through the port's public
API; `reference` gives the plain float64 posterior of the same arrays.
"""

from __future__ import annotations

import numpy as np
import torch


def _pedestal(x, x0, lam):
    prof = 1.0 - 0.5 * np.minimum(x, x0) ** 2
    return np.where(x > x0, (1.0 - 0.5 * x0**2) * np.exp(-(x - x0) / lam), prof)


def make_data(cfg: dict) -> dict:
    """Observed rows: x, derivative order, y and err, value rows first."""
    rng = np.random.default_rng(cfg["data_seed"])
    x = np.linspace(cfg["x_lo"], cfg["x_hi"], cfg["n_points"])
    y = _pedestal(x, cfg["pedestal_x0"], cfg["pedestal_lam"]) + cfg["err_y"] * rng.standard_normal(
        cfg["n_points"])
    sx, sy, se = (np.array(c, dtype=np.float64) for c in zip(*cfg["slopes"]))
    return {
        "x": np.concatenate([x, sx]),
        "order": np.concatenate([np.zeros(x.size, np.int64), np.ones(sx.size, np.int64)]),
        "y": np.concatenate([y, sy]),
        "err": np.concatenate([np.full(x.size, cfg["err_y"]), se]),
    }


def _prior(cfg: dict):
    from gptools_tpu_torch.utils.priors import LogNormalJointPrior, UniformJointPrior

    parts = [LogNormalJointPrior([a], [b]) if kind == "lognormal" else UniformJointPrior([a], [b])
             for kind, a, b in cfg["priors"]]
    prior = parts[0]
    for p in parts[1:]:
        prior = prior * p
    return prior


def program(cfg: dict, arrays: dict, dtype, device):
    """(model, data) of the program under test."""
    from gptools_tpu_torch.models.dataset import DatasetBuilder
    from gptools_tpu_torch.models.gp import GPModel
    from gptools_tpu_torch.ops.kernels import GibbsKernel1dTanh

    b = DatasetBuilder(1)
    for o in (0, 1):
        sel = arrays["order"] == o
        b.add(arrays["x"][sel], arrays["y"][sel], err_y=arrays["err"][sel], n=o)
    model = GPModel(GibbsKernel1dTanh(hyperprior=_prior(cfg)), diag_factor=cfg["diag_factor"])
    return model, b.build(dtype, device)


def _gibbs_tanh(x1, x2, th):
    """sigma_f^2 sqrt(2 l l' / (l^2 + l'^2)) exp(-(x - x')^2 / (l^2 + l'^2)),
    l(x) = l1 + (l2 - l1) (1 + tanh((x - x0) / lw)) / 2."""
    sf, l1, l2, lw, x0 = (th[..., i] for i in range(5))

    def ell(x):
        return l1 + 0.5 * (l2 - l1) * (1.0 + torch.tanh((x - x0) / lw))

    a, b = ell(x1), ell(x2)
    s2 = a * a + b * b
    d = x1 - x2
    return sf * sf * torch.sqrt(2.0 * a * b / s2) * torch.exp(-d * d / s2)


def reference(cfg: dict, arrays: dict, device):
    """The plain float64 posterior of the same arrays."""
    from benchmark.reference.gp import GPPosterior, Priors

    return GPPosterior(Priors(cfg["priors"]), _gibbs_tanh, arrays["x"], arrays["order"],
                       arrays["y"], arrays["err"], diag_factor=cfg["diag_factor"], device=device)
