"""Inference layer: MAP, HMC, NUTS, ChEES, SMC, parallel tempering and
ADVI, all driving the batched density
`gptools_tpu_torch.models.gp.GPModel.log_posterior_u_batch`.

Counterpart of `gptools_tpu.infer`. Every sampler and optimizer takes the
density batched, (C, P) -> (C,), and evaluates all of its rows (chains,
starts, rung-by-chain lanes or ELBO draws) in one call, which on the card
is one launch of the evidence kernel wherever the model and data allow it;
the reference ``vmap``s a scalar density instead. Randomness comes from the
caller's `torch.Generator`, drawn on the data's device.
"""

from __future__ import annotations

import torch

__all__ = [
    "run_sampler",
    "model_logp",
    "SampleResult",
    "hmc",
    "nuts",
    "smc",
    "chees",
    "advi",
    "map_fit",
    "pipeline",
    "pt",
]


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
    ``generator``. ``sampler`` is one of ``"nuts"``, ``"hmc"``,
    ``"chees"`` (from ``init``: prior draws, or jitter around the model's
    initial parameters), ``"pt"`` / ``"tempered"`` (replica exchange,
    `pt.sample`), ``"smc"``, ``"advi"``, ``"smc+nuts"`` / ``"smc-nuts"``
    and ``"smc+chees"`` / ``"smc-chees"`` (`pipeline`). Returns a
    `SampleResult` whose ``thetas`` are (chains, samples, P)."""
    if sampler in ("nuts", "hmc", "chees"):
        u0 = _initial_positions(model, generator, num_chains, init, data.dtype, data.device)
        run = {"nuts": nuts.sample, "hmc": hmc.sample, "chees": chees.sample}[sampler]
        result = run(model_logp(model, data), u0, generator, num_warmup=num_warmup,
                     num_samples=num_samples, **kwargs)
        return _attach_thetas(model, result)
    if sampler in ("smc+chees", "smc-chees"):
        return pipeline.smc_then_chees(
            model, data, generator, num_chains=num_chains, num_samples=num_samples,
            num_warmup=num_warmup, **kwargs,
        )
    if sampler in ("smc+nuts", "smc-nuts"):
        return pipeline.smc_then_nuts(
            model, data, generator, num_chains=num_chains, num_samples=num_samples,
            num_warmup=num_warmup, **kwargs,
        )
    if sampler in ("pt", "tempered"):
        return pt.sample(
            model, data, generator, num_chains=num_chains, num_samples=num_samples,
            num_warmup=num_warmup, init=init, **kwargs,
        )
    if sampler == "smc":
        num_particles = kwargs.pop("num_particles", max(num_chains * num_samples // 4, 256))
        return smc.sample(model, data, generator, num_particles=num_particles, **kwargs)
    if sampler == "advi":
        return advi.sample(model, data, generator, num_samples=num_samples, **kwargs)
    raise ValueError(f"unknown sampler {sampler!r}")


def _per_data(model, attr: str, data, build):
    """``build()`` cached on the model per dataset (at most 9 entries), so
    one (model, data) always gets the same object; the entry holds ``data``,
    so its id is not reused while it lives."""
    cache = model.__dict__.setdefault(attr, {})
    entry = cache.get(id(data))
    if entry is not None and entry[0] is data:
        return entry[1]
    if len(cache) > 8:
        cache.clear()
    value = build()
    cache[id(data)] = (data, value)
    return value


def model_logp(model, data):
    """The batched unconstrained-space target us (C, P) -> (C,) of ``model``
    on ``data`` (`GPModel.log_posterior_u_batch`), one function per (model,
    data) as in the reference."""

    def build():
        def logp(us):
            return model.log_posterior_u_batch(us, data)

        return logp

    return _per_data(model, "_model_logp_cache", data, build)


def _initial_positions(model, generator, num_chains, init, dtype, device):
    """(num_chains, P) starting points in u: prior draws (``init="prior"``),
    else the model's initial parameters plus 0.1 standard normal jitter."""
    if init == "prior":
        thetas = model.hyperprior.sample(generator, (num_chains,), dtype).to(device)
        return model.u_of_theta(thetas)
    u0 = model.u_of_theta(torch.tensor(model.initial_params, dtype=dtype, device=device))
    noise = torch.randn((num_chains, model.num_free_params), generator=generator, dtype=dtype,
                        device=generator.device).to(device)
    return u0[None, :] + 0.1 * noise


def _attach_thetas(model, result):
    """The result with its constrained draws (chains, samples, P)."""
    return result._replace(thetas=model.theta_of_u(result.u))


# The submodules import the helpers above from this package, so they come
# last.
from gptools_tpu_torch.infer import advi, chees, hmc, map_fit, nuts, pipeline, pt, smc  # noqa: E402
from gptools_tpu_torch.infer.hmc import SampleResult  # noqa: E402
