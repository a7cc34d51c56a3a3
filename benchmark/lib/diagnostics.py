"""Frozen copy of the ESS and split R-hat arithmetic, in float64.

Copied from the port's ``utils/diagnostics.py`` (``ess``, ``autocorr``,
``_split_rhat_core``: per-chain FFT autocorrelation, Geyer's initial
monotone positive sequence, combined across chains as Vehtari et al. 2021
without rank normalization), so that a change to the program cannot move
the yardstick. It runs in float64 wherever its draws are (the card, in the
benchmark, after the timed window). The sum over chains of the
autocovariances is taken in the frequency domain, which is the same sum.
"""

from __future__ import annotations

import torch


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def ess(chains: torch.Tensor) -> torch.Tensor:
    """Effective sample size of scalar chains (num_chains, num_samples)."""
    chains = chains.to(torch.float64)
    m, n = chains.shape
    xc = chains - chains.mean(-1, keepdim=True)
    f = torch.fft.rfft(xc, n=_next_pow2(n) * 2, dim=-1)
    power = (f.real * f.real + f.imag * f.imag).mean(0)
    # mean over chains of each chain's autocovariance (the sum over t of
    # xc_t xc_{t+k}, over n); a stuck chain adds 0, as in the copied code
    mean_acov = torch.fft.irfft(power, n=_next_pow2(n) * 2)[:n] / n
    w = chains.var(-1, correction=1).mean()
    var_plus = w * (n - 1) / n
    if m > 1:
        var_plus = var_plus + chains.mean(-1).var(correction=1)
    rho = 1.0 - (w - mean_acov) / var_plus
    n_pairs = n // 2
    pair = rho[: 2 * n_pairs].reshape(n_pairs, 2).sum(1)
    pair_mono = torch.cummin(pair, 0).values
    keep = torch.cumprod((pair_mono > 0).to(pair.dtype), 0)
    tau = torch.clamp(-1.0 + 2.0 * (pair_mono * keep).sum(), min=1.0 / n)
    return m * n / tau


def ess_per_param(samples: torch.Tensor) -> torch.Tensor:
    """(P,) ESS of (num_chains, num_samples, P) draws."""
    return torch.stack([ess(samples[:, :, i]) for i in range(samples.shape[-1])])


def split_rhat(samples: torch.Tensor) -> torch.Tensor:
    """(P,) split R-hat of (num_chains, num_samples, P) draws."""
    s = samples.to(torch.float64)
    half = s.shape[1] // 2
    x = torch.cat([s[:, :half], s[:, half : 2 * half]], 0)
    w = x.var(1, correction=1).mean(0)
    b = half * x.mean(1).var(0, correction=1)
    var_plus = (half - 1) / half * w + b / half
    return torch.sqrt(var_plus / w)
