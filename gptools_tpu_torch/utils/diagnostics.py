"""Chain diagnostics: ESS, split-R-hat and posterior summaries.

Counterpart of `gptools_tpu.utils.diagnostics`: per-chain FFT
autocorrelation, Geyer's initial monotone positive sequence, combined
across chains (Vehtari et al. 2021 without rank normalization; the
rank-normalized "bulk" variant is `bulk_ess_per_param`). The torch
functions run where their samples live. `ess_and_rhat` and
`summarize_samples` dispatch as the reference does: samples on a card are
reduced there and only the per-parameter results are copied to the host;
samples on the host go through the native library (`utils.native`, the
repo's ``native/diagnostics.cpp``), or through the torch functions on the
CPU when ``native=False`` is asked for.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

__all__ = [
    "autocorr",
    "ess",
    "ess_per_param",
    "split_rhat",
    "ess_and_rhat",
    "summarize_samples",
    "rank_normalize",
    "bulk_ess_per_param",
]


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def _as_tensor(samples) -> torch.Tensor:
    """A tensor as is; anything else as a float64 CPU tensor."""
    if torch.is_tensor(samples):
        return samples
    return torch.as_tensor(np.asarray(samples, dtype=np.float64))


def _on_card(samples) -> bool:
    return torch.is_tensor(samples) and samples.device.type != "cpu"


def autocorr(x: torch.Tensor) -> torch.Tensor:
    """Normalized autocorrelation along the last axis, via FFT."""
    n = x.shape[-1]
    m = _next_pow2(n) * 2
    xc = x - x.mean(-1, keepdim=True)
    f = torch.fft.rfft(xc, n=m, dim=-1)
    acov = torch.fft.irfft(f * torch.conj(f), n=m, dim=-1)[..., :n]
    # zero-variance (stuck) series: autocorr = 0 instead of 0/0
    a0 = acov[..., :1]
    safe = torch.where(a0 > 0, a0, torch.ones_like(a0))
    return torch.where(a0 > 0, acov / safe, torch.zeros_like(acov))


def ess(chains: torch.Tensor) -> torch.Tensor:
    """Effective sample size of scalar chains, shape (num_chains,
    num_samples)."""
    chains = torch.atleast_2d(chains)
    m, n = chains.shape
    acov = autocorr(chains) * chains.var(-1, correction=0, keepdim=True)
    mean_acov = acov.mean(0)
    w = chains.var(-1, correction=1).mean()  # within-chain variance
    var_plus = w * (n - 1) / n
    if m > 1:
        b = n * chains.mean(-1).var(correction=1)
        var_plus = var_plus + b / n
    rho = 1.0 - (w - mean_acov) / var_plus

    # Geyer: sum consecutive pairs, keep while positive and monotone
    n_pairs = n // 2
    pair = rho[: 2 * n_pairs].reshape(n_pairs, 2).sum(1)
    pair_mono = torch.cummin(pair, 0).values
    keep = torch.cumprod((pair_mono > 0).to(pair.dtype), 0)
    tau = -1.0 + 2.0 * (pair_mono * keep).sum()
    tau = torch.clamp(tau, min=1.0 / n)
    return m * n / tau


def _as3(samples) -> torch.Tensor:
    s = _as_tensor(samples)
    return s if s.ndim == 3 else s[None]


def ess_per_param(samples) -> torch.Tensor:
    """ESS for each parameter of (num_chains, num_samples, dim) samples (or
    one chain's (num_samples, dim)), on the samples' device."""
    s = _as3(samples)
    return torch.stack([ess(s[:, :, i]) for i in range(s.shape[-1])])


def _split_rhat_core(samples: torch.Tensor) -> torch.Tensor:
    """Split-R-hat per parameter of (num_chains, num_samples, dim) samples."""
    c, n, d = samples.shape
    half = n // 2
    x = torch.cat([samples[:, :half], samples[:, half : 2 * half]], 0)
    n2 = half
    chain_mean = x.mean(1)
    chain_var = x.var(1, correction=1)
    w = chain_var.mean(0)
    b = n2 * chain_mean.var(0, correction=1)
    var_plus = (n2 - 1) / n2 * w + b / n2
    return torch.sqrt(var_plus / w)


def split_rhat(samples) -> torch.Tensor:
    """Split-R-hat per parameter, on the samples' device."""
    return _split_rhat_core(_as3(samples))


@torch.no_grad()
def ess_and_rhat(samples, native: bool = True):
    """(ESS, split-R-hat) per parameter of (num_chains, num_samples, dim)
    samples (or one chain's (num_samples, dim)) as numpy arrays: reduced on
    the card when the samples are there; host samples (a CPU tensor or an
    array) through the native library, or through the torch functions on
    the CPU with ``native=False``."""
    if _on_card(samples) or not native:
        s = _as3(samples)
        return ess_per_param(s).cpu().numpy(), _split_rhat_core(s).cpu().numpy()
    from gptools_tpu_torch.utils import native as _native

    s = np.asarray(samples.detach().cpu() if torch.is_tensor(samples) else samples,
                   dtype=np.float64)
    return _native.ess_batch(s), _native.split_rhat_batch(s)


def _quantiles(flat: torch.Tensor, qs):
    """Linear-interpolation quantiles along axis 0 (numpy's default
    method), from one sort; `torch.quantile` refuses inputs past 2^24
    elements, which a sampler's draws exceed."""
    srt = flat.sort(0).values
    n = srt.shape[0]
    out = []
    for q in qs:
        pos = q * (n - 1)
        lo = math.floor(pos)
        hi = min(lo + 1, n - 1)
        t = pos - lo
        out.append(srt[lo] + (srt[hi] - srt[lo]) * t)
    return out


@torch.no_grad()
def _device_moments(samples: torch.Tensor):
    """Pooled mean, std and the 5 / 50 / 95% quantiles per parameter where
    the samples live: (C, N, D) in, five (D,) tensors out."""
    flat = samples.reshape(-1, samples.shape[-1])
    return (flat.mean(0), flat.std(0, correction=1), *_quantiles(flat, (0.05, 0.50, 0.95)))


def summarize_samples(samples, param_names=None, wall_time: float | None = None,
                      native: bool = True) -> Dict:
    """Posterior summary table: mean, std, quantiles, ESS and R-hat per
    parameter, ESS/s when a wall time is given; a dict of numpy arrays.
    Samples on a card are reduced there (moments and diagnostics), host
    samples in numpy and through `ess_and_rhat`'s host path (``native``)."""
    if _on_card(samples):
        s3 = _as3(samples)
        c, n, d = s3.shape
        mean, std, q05, q50, q95 = (v.cpu().numpy() for v in _device_moments(s3))
        ess_v, rhat_v = ess_and_rhat(s3)
    else:
        s = np.asarray(samples.detach().cpu() if torch.is_tensor(samples) else samples)
        if s.ndim == 2:
            s = s[None]
        c, n, d = s.shape
        flat = s.reshape(-1, d)
        mean, std = flat.mean(axis=0), flat.std(axis=0, ddof=1)
        q05, q50, q95 = (np.quantile(flat, q, axis=0) for q in (0.05, 0.50, 0.95))
        ess_v, rhat_v = ess_and_rhat(s, native=native)
    names = list(param_names) if param_names is not None else [f"p{i}" for i in range(d)]
    out = {
        "params": names,
        "mean": mean,
        "std": std,
        "q05": q05,
        "q50": q50,
        "q95": q95,
        "ess": ess_v,
        "rhat": rhat_v,
        "num_chains": c,
        "num_samples": n,
    }
    if wall_time is not None:
        out["wall_time_s"] = float(wall_time)
        out["ess_per_s"] = ess_v / float(wall_time)
    return out


def rank_normalize(samples) -> torch.Tensor:
    """Rank-normalized draws (Vehtari et al. 2021): pooled ranks through the
    normal quantile function, with Blom's offset; (num_chains,
    num_samples[, dim]) in and out, ranked over the pooled draws."""
    s = _as_tensor(samples)
    shape = s.shape
    flat = s.reshape(-1, *shape[2:]) if s.ndim >= 2 else s
    n = flat.shape[0]
    order = torch.argsort(flat, dim=0, stable=True)
    ranks = torch.argsort(order, dim=0, stable=True).to(flat.dtype) + 1.0
    u = (ranks - 0.375) / (n + 0.25)
    z = math.sqrt(2.0) * torch.special.erfinv(2.0 * u - 1.0)
    return z.reshape(shape)


def bulk_ess_per_param(samples) -> torch.Tensor:
    """Rank-normalized ("bulk") ESS per parameter."""
    return ess_per_param(rank_normalize(_as3(samples)))
