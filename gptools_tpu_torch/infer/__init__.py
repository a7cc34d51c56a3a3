"""Samplers over GP hyperparameters and their dispatch.

`run_sampler` is the counterpart of `gptools_tpu.infer.run_sampler` with
the routes the port has: ``"smc+chees"`` / ``"smc-chees"``
(`pipeline.smc_then_chees`) and ``"smc"`` (`smc.sample`). The other
samplers of the reference (NUTS, HMC, ChEES alone, PT, ADVI, SMC+NUTS) are
ROADMAP Queue 1 item 13 and raise.
"""

from __future__ import annotations

import torch

__all__ = ["run_sampler"]

_QUEUED = ("nuts", "hmc", "chees", "pt", "tempered", "advi", "smc+nuts", "smc-nuts")


def run_sampler(
    model,
    data,
    generator: torch.Generator,
    sampler: str = "nuts",
    num_chains: int = 8,
    num_samples: int = 1000,
    num_warmup: int = 500,
    init: str = "prior",
    **kwargs,
):
    """Sample the posterior of ``model`` on ``data``, randomness from
    ``generator``; returns a `SampleResult` whose ``thetas`` are
    (chains, samples, P). ``init`` is read by the queued samplers only."""
    from gptools_tpu_torch.infer import pipeline, smc

    if sampler in ("smc+chees", "smc-chees"):
        return pipeline.smc_then_chees(
            model, data, generator, num_chains=num_chains, num_samples=num_samples,
            num_warmup=num_warmup, **kwargs,
        )
    if sampler == "smc":
        num_particles = kwargs.pop("num_particles", max(num_chains * num_samples // 4, 256))
        return smc.sample(model, data, generator, num_particles=num_particles, **kwargs)
    if sampler in _QUEUED:
        raise NotImplementedError(f"sampler {sampler!r} is ROADMAP Queue 1 item 13")
    raise ValueError(f"unknown sampler {sampler!r}")
