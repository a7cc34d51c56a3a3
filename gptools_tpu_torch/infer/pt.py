"""Likelihood / prior split of the unconstrained density, batched.

Counterpart of `gptools_tpu.infer.pt.model_splits_batched` and of the prior
half of `model_splits`: likelihood tempering (SMC here) needs the two parts
separately. Parallel tempering itself (`pt.sample`, `geometric_ladder`) is
ROADMAP Queue 1 item 13.
"""

from __future__ import annotations

__all__ = ["model_splits_batched", "log_prior_u_batched"]


def model_splits_batched(model, data):
    """Batched u-space log-likelihood ``us (N, Pf) -> (N,)``."""

    def log_like_batched(us):
        return model.log_marginal_batch(model.theta_of_u(us), data)

    return log_like_batched


def log_prior_u_batched(model):
    """Batched u-space log prior plus log|det J|: ``us (N, Pf) -> (N,)``."""

    def log_prior_batched(us):
        u_full = model._u_full(us)
        theta = model.bijector.forward(u_full)
        return model.log_prior(theta) + model.bijector.log_det_jac(u_full)

    return log_prior_batched
