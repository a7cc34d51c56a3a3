"""Sampler and predictive-envelope plotting, robust profile statistics.

Counterpart of `gptools_tpu.utils.plotting` (the original ``gptools/
utils.py :: summarize_sampler, plot_sampler, compute_stats,
univariate_envelope_plot``). Every function reads its tensors to the host
once and works on numpy arrays; matplotlib is imported lazily, with the
Agg backend, by the two plotting functions only.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = [
    "compute_stats",
    "summarize_sampler",
    "plot_sampler",
    "univariate_envelope_plot",
]


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _draws(result, burn: int) -> np.ndarray:
    """The constrained draws of a `SampleResult` (its ``u`` when it has no
    thetas), or a raw (C, S, P) / (S, P) stack, as (C, S - burn, P)."""
    thetas = getattr(result, "thetas", result)
    if thetas is None:
        thetas = result.u
    s = _host(thetas)
    if s.ndim == 2:
        s = s[None]
    return s[:, burn:, :]


def compute_stats(
    vals,
    check_nan: bool = False,
    robust: bool = False,
    axis: int = 0,
    plot_sample: bool = False,
    ci: float = 0.95,
):
    """Center and credible half-widths of sampled values along ``axis``:
    ``(mean, ci_low_width, ci_up_width)``, the widths ``z sd`` for the
    normal quantile of ``ci``; ``robust=True`` gives the median and its
    distances to the percentiles. ``check_nan`` masks non-finite values.
    ``plot_sample`` is accepted for the original API and unused."""
    v = _host(vals)
    if check_nan:
        v = np.ma.masked_invalid(v)
    lo_q = 100 * (1 - ci) / 2
    hi_q = 100 * (1 + ci) / 2
    if robust:
        center = np.median(v, axis=axis)
        lo = center - np.percentile(v, lo_q, axis=axis)
        hi = np.percentile(v, hi_q, axis=axis) - center
    else:
        from scipy.stats import norm

        center = np.mean(v, axis=axis)
        sd = np.std(v, axis=axis, ddof=1)
        lo = hi = norm.ppf(hi_q / 100) * sd
    return center, lo, hi


def summarize_sampler(result, param_names=None, burn: int = 0, ci: float = 0.95):
    """Posterior summary table of a `SampleResult` (or a raw stack): the
    per-parameter moments, quantiles, ESS and split R-hat of
    `utils.diagnostics.summarize_samples` on the host, plus the ``ci``
    interval's ends ``ci_low`` and ``ci_high``."""
    from gptools_tpu_torch.utils.diagnostics import summarize_samples

    s = _draws(result, burn)
    out = summarize_samples(s, param_names=param_names)
    flat = s.reshape(-1, s.shape[-1])
    out["ci_low"] = np.quantile(flat, (1 - ci) / 2, axis=0)
    out["ci_high"] = np.quantile(flat, (1 + ci) / 2, axis=0)
    return out


def plot_sampler(
    result,
    param_names: Optional[Sequence[str]] = None,
    burn: int = 0,
    path: Optional[str] = None,
    max_points: int = 5000,
):
    """Corner plot of the hyperparameter posterior (histograms on the
    diagonal, at most ``max_points`` draws below it). Returns the figure;
    saves it to ``path`` if given."""
    plt = _plt()
    s = _draws(result, burn)
    P = s.shape[-1]
    flat = s.reshape(-1, P)
    if flat.shape[0] > max_points:
        idx = np.random.default_rng(0).choice(flat.shape[0], max_points, False)
        flat = flat[idx]
    names = list(param_names) if param_names else [f"p{i}" for i in range(P)]

    fig, axes = plt.subplots(P, P, figsize=(2.2 * P, 2.2 * P))
    axes = np.atleast_2d(axes)
    for i in range(P):
        for j in range(P):
            ax = axes[i, j]
            if j > i:
                ax.axis("off")
                continue
            if i == j:
                ax.hist(flat[:, i], bins=40, color="#46628a")
                ax.set_yticks([])
            else:
                ax.plot(flat[:, j], flat[:, i], ",", color="#46628a", alpha=0.4)
            if i == P - 1:
                ax.set_xlabel(names[j])
            if j == 0 and i > 0:
                ax.set_ylabel(names[i])
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig


def univariate_envelope_plot(
    x,
    mean,
    std=None,
    lower=None,
    upper=None,
    ax=None,
    color="#46628a",
    label: Optional[str] = None,
    path: Optional[str] = None,
    num_std: float = 1.96,
):
    """Mean curve and a shaded envelope: ``[lower, upper]`` when both are
    given, else ``mean -+ num_std std``. Returns the axes; saves the figure
    to ``path`` if given."""
    plt = _plt()
    x = _host(x).reshape(-1)
    mean = _host(mean).reshape(-1)
    if ax is None:
        fig, ax = plt.subplots(figsize=(6, 4))
    else:
        fig = ax.figure
    if lower is None or upper is None:
        sd = _host(std).reshape(-1)
        lower = mean - num_std * sd
        upper = mean + num_std * sd
    else:
        lower, upper = _host(lower).reshape(-1), _host(upper).reshape(-1)
    ax.fill_between(x, lower, upper, alpha=0.25, color=color, linewidth=0)
    ax.plot(x, mean, color=color, label=label)
    if label:
        ax.legend()
    if path:
        fig.savefig(path, dpi=120)
    return ax
