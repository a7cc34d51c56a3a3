"""Serving: predictors with their states precomputed, for repeated queries.

Counterpart of `gptools_tpu.models.serve`. The expensive state, the
Cholesky factor and ``alpha = K^{-1} (y - mu)`` (or a batch of them over
posterior samples), is computed once at construction; each query then
builds only the star blocks and solves against it, under ``no_grad``.

The reference jit-compiles each query and pads ragged query sizes to a
``bucket`` multiple to bound its compile cache. PyTorch runs eagerly and
keeps no such cache, so the port takes ``bucket`` and does not pad: the
outputs are the same, since every star point is predicted on its own
row.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["FrozenPredictor", "FrozenMCMCPredictor"]


class FrozenPredictor:
    """Point-estimate predictor for a fixed (model, data, theta)."""

    def __init__(self, model, data, theta, bucket: int = 64):
        self.model = model
        self.data = data
        self.theta = torch.as_tensor(theta, dtype=data.dtype, device=data.device)
        self.bucket = int(bucket)
        with torch.no_grad():
            self.state = model.compute_K_L_alpha_ll(self.theta, data)

    @torch.no_grad()
    def __call__(self, Xstar, n: int = 0, return_std: bool = True):
        """``(mean, std)`` at the star points, or the mean alone."""
        pred = self.model.predict(
            self.theta, self.data, Xstar,
            n=int(n), return_std=return_std, state=self.state,
        )
        return (pred.mean, pred.std) if return_std else pred.mean


class FrozenMCMCPredictor:
    """Posterior-marginalized predictor: up to ``max_samples`` posterior
    thetas (evenly spaced over the draws), their states built by one
    batched call (with ``cov_backend="pallas"`` on the card, one launch of
    the covariance kernel), and queries answered for all of them at once."""

    def __init__(self, model, data, thetas, max_samples: int = 512, bucket: int = 64):
        self.model = model
        self.data = data
        thetas = torch.as_tensor(thetas, dtype=data.dtype, device=data.device)
        thetas = thetas.reshape(-1, model.num_params)
        if thetas.shape[0] > max_samples:
            idx = np.linspace(0, thetas.shape[0] - 1, max_samples).astype(int)
            thetas = thetas[torch.as_tensor(idx, device=thetas.device)]
        self.thetas = thetas
        self.bucket = int(bucket)
        with torch.no_grad():
            self.states = model.compute_K_L_alpha_ll(thetas, data)

    @torch.no_grad()
    def __call__(self, Xstar, n: int = 0):
        """The posterior predictive mean and std at the star points (law of
        total mean and variance over the samples)."""
        pred = self.model.predict(
            self.thetas, self.data, Xstar,
            n=int(n), return_std=True, state=self.states,
        )
        mean = pred.mean.mean(0)
        var = (pred.std**2 + pred.mean**2).mean(0) - mean**2
        return mean, torch.sqrt(torch.clamp(var, min=0.0))
