"""Chain diagnostics: ESS and split-R-hat, in torch on the samples' device.

Counterpart of `gptools_tpu.utils.diagnostics` (`autocorr`, `ess`,
`_split_rhat_core`, `ess_and_rhat`): per-chain FFT autocorrelation, Geyer's
initial monotone positive sequence, combined across chains (Vehtari et al.
2021 without rank normalization). Samples on a card are reduced there and
only the per-parameter results are copied to the host. The native C++ host
path of the reference and the other summaries are ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

import torch

__all__ = ["autocorr", "ess", "ess_and_rhat"]


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


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


@torch.no_grad()
def ess_and_rhat(samples: torch.Tensor):
    """(ESS, split-R-hat) per parameter of (num_chains, num_samples, dim)
    samples (or one chain's (num_samples, dim)), computed where the samples
    live; returned as numpy arrays."""
    s = samples if samples.ndim == 3 else samples[None]
    e = torch.stack([ess(s[:, :, i]) for i in range(s.shape[-1])])
    r = _split_rhat_core(s)
    return e.cpu().numpy(), r.cpu().numpy()
