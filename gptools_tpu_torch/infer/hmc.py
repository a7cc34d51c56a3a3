"""Vectorized HMC with Stan-style windowed warmup, pooled across chains.

Counterpart of `gptools_tpu.infer.hmc`: the sample container, pooled dual
averaging for the step size, pooled Welford moments for the diagonal mass,
the leapfrog step, the fixed-length HMC transition, the warmup window
schedule and the windowed driver `sample`, which also drives NUTS
(`infer.nuts`).

Every transition takes the batched density (C, P) -> (C,) and evaluates
all chains in one call per leapfrog, where the reference ``vmap``s a
per-chain transition over a scalar density. Randomness comes from the
caller's `torch.Generator`, drawn as (C, ...) tensors on the positions'
device. The reference's ``logp_params`` operand, ``transition_builder``,
the chunked window runner and the compiled-program caches
(``_window_program``, ``make_window_runner``) exist for XLA's
compilation and have no counterpart: PyTorch runs the windows eagerly,
and a transition is named by ``transition="hmc"`` or ``"nuts"``.
`run_window` is the reference's public single-window entry point.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from gptools_tpu_torch.utils import metrics as _metrics

__all__ = [
    "SampleResult",
    "DualAveragingState",
    "WelfordState",
    "da_init",
    "da_update",
    "welford_init",
    "welford_update_batch",
    "welford_variance",
    "leapfrog",
    "kinetic",
    "value_and_grad",
    "ValueWithGrad",
    "warmup_schedule",
    "run_window",
    "sample",
]


class SampleResult(NamedTuple):
    """Posterior sample container (all samplers return this)."""

    u: torch.Tensor                    # (chains, samples, P) unconstrained
    thetas: Optional[torch.Tensor]     # (chains, samples, P) constrained
    log_prob: torch.Tensor             # (chains, samples)
    diagnostics: dict                  # step size, divergences, accept, ...

    @property
    def num_chains(self):
        return self.u.shape[0]

    @property
    def num_samples(self):
        return self.u.shape[1]


class DualAveragingState(NamedTuple):
    """Nesterov dual averaging for log step size (Hoffman & Gelman 2014);
    every field a tensor of the shape of ``eps0`` (0-d, or one entry per
    rung in parallel tempering)."""

    log_eps: torch.Tensor
    log_eps_avg: torch.Tensor
    h_sum: torch.Tensor
    mu: torch.Tensor
    t: torch.Tensor


def da_init(eps0: torch.Tensor) -> DualAveragingState:
    log_eps = torch.log(eps0)
    return DualAveragingState(
        log_eps=log_eps,
        # seed the average at eps0 so a zero-warmup run samples at eps0
        log_eps_avg=log_eps,
        h_sum=torch.zeros_like(log_eps),
        mu=math.log(10.0) + log_eps,
        t=torch.zeros_like(log_eps),
    )


def da_update(
    state: DualAveragingState,
    accept_prob: torch.Tensor,
    target: float = 0.8,
    gamma: float = 0.05,
    t0: float = 10.0,
    kappa: float = 0.75,
) -> DualAveragingState:
    t = state.t + 1.0
    h_sum = state.h_sum + (target - accept_prob)
    log_eps = state.mu - torch.sqrt(t) / gamma * h_sum / (t + t0)
    w = t ** (-kappa)
    log_eps_avg = w * log_eps + (1.0 - w) * state.log_eps_avg
    return DualAveragingState(log_eps, log_eps_avg, h_sum, state.mu, t)


class WelfordState(NamedTuple):
    """Pooled running mean and variance for diagonal mass adaptation:
    count (...), mean and m2 (..., P); the leading axes (none, or the rungs
    of parallel tempering) are independent accumulators."""

    count: torch.Tensor
    mean: torch.Tensor
    m2: torch.Tensor


def welford_init(dim: int, dtype=torch.float32, device=None, lead: tuple = ()) -> WelfordState:
    return WelfordState(
        count=torch.zeros(lead, dtype=dtype, device=device),
        mean=torch.zeros(lead + (dim,), dtype=dtype, device=device),
        m2=torch.zeros(lead + (dim,), dtype=dtype, device=device),
    )


def welford_update_batch(state: WelfordState, xs: torch.Tensor) -> WelfordState:
    """Fold a (..., batch, dim) stack of draws into the pooled moments
    (chunk-parallel Welford / Chan et al. update)."""
    nb = float(xs.shape[-2])
    mb = xs.mean(-2)
    m2b = ((xs - mb.unsqueeze(-2)) ** 2).sum(-2)
    delta = mb - state.mean
    tot = state.count + nb
    mean = state.mean + delta * nb / tot.unsqueeze(-1)
    m2 = state.m2 + m2b + delta**2 * (state.count * nb / tot).unsqueeze(-1)
    return WelfordState(tot, mean, m2)


def welford_variance(state: WelfordState, regularize: bool = True) -> torch.Tensor:
    n = state.count.unsqueeze(-1)
    var = state.m2 / torch.clamp(n - 1.0, min=1.0)
    if regularize:
        # Stan's shrinkage toward unit scale for small counts
        var = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
    return var


def leapfrog(value_and_grad_fn: Callable, q, p, eps, inv_mass, grad=None):
    """One leapfrog step of H = -logp(q) + 1/2 p^T M^-1 p. Returns
    (q', p', logp', grad'). Pass the cached ``grad`` at ``q`` to spend
    exactly one gradient evaluation per step."""
    if grad is None:
        _, grad = value_and_grad_fn(q)
    p_half = p + 0.5 * eps * grad
    q_new = q + eps * inv_mass * p_half
    v_new, g_new = value_and_grad_fn(q_new)
    p_new = p_half + 0.5 * eps * g_new
    return q_new, p_new, v_new, g_new


def kinetic(p, inv_mass):
    """1/2 p^T M^-1 p over the last axis."""
    return 0.5 * (p * p * inv_mass).sum(-1)


class ValueWithGrad(torch.autograd.Function):
    """``vag(thetas) -> (values, gradients)`` as a function of thetas: the
    forward keeps the gradient, the backward returns ``g * grad`` (first
    order only, as the evidence kernel). The batch densities whose
    gradient is computed apart from autograd (the route's CUDA graph, a
    `parallel.mesh.ShardedDensity`) return their values through it."""

    @staticmethod
    def forward(ctx, vag, thetas):
        ll, grad = vag(thetas)
        ctx.save_for_backward(grad)
        return ll

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return None, g[:, None] * grad


def value_and_grad(logp: Callable) -> Callable:
    """Batched value and gradient of ``logp`` (C, P) -> (C,): one backward
    of the summed densities (each row's gradient is its own, since the
    density is rowwise); no graph outlives the call. A density sharded over
    a mesh (`parallel.mesh.ShardedDensity`) brings its own: each rank's
    block differentiated there and the blocks gathered, so nothing is
    differentiated through a collective."""
    from gptools_tpu_torch.parallel.mesh import ShardedDensity

    if isinstance(logp, ShardedDensity):
        return logp.value_and_grad

    def logp_and_grad(qs):
        with torch.enable_grad():
            q = qs.detach().requires_grad_(True)
            lls = logp(q)
            with _metrics.span("density.backward"):
                (g,) = torch.autograd.grad(lls.sum(), q)
        return lls.detach(), g

    return logp_and_grad


def _hmc_proposal(logp_and_grad: Callable, q, logp0, g0, p0, eps_c, inv_mass,
                  num_steps: int, log_unif):
    """The fixed-length HMC proposal and Metropolis test of
    `_hmc_transition` with its randomness given: momentum ``p0`` (C, P),
    per-chain step ``eps_c`` (C, 1) and ``log_unif`` (C,), the log of the
    acceptance uniform. Returns (q, logp, grad, stats)."""
    h0 = -logp0 + kinetic(p0, inv_mass)
    qn, pn, logpn, gn = q, p0, logp0, g0
    for _ in range(num_steps):
        qn, pn, logpn, gn = leapfrog(logp_and_grad, qn, pn, eps_c, inv_mass, grad=gn)
    h1 = -logpn + kinetic(pn, inv_mass)
    log_accept = torch.clamp(h0 - h1, max=0.0)
    log_accept = torch.where(torch.isnan(log_accept), -math.inf, log_accept)
    accept = log_unif < log_accept
    stats = {
        "accept_prob": torch.exp(log_accept),
        "diverged": (h1 - h0) > 1000.0,
        "num_leapfrog": torch.full_like(logp0, num_steps, dtype=torch.int64),
    }
    return (
        torch.where(accept[:, None], qn, q),
        torch.where(accept, logpn, logp0),
        torch.where(accept[:, None], gn, g0),
        stats,
    )


def _hmc_transition(logp_and_grad: Callable, q, logp0, g0, generator, eps, inv_mass,
                    num_steps: int, jitter: float = 0.2):
    """One fixed-length HMC transition for all chains: per chain a
    momentum, a jittered step ``eps (1 + jitter (2U - 1))`` and a
    Metropolis test (NaN -> reject); ``eps`` is 0-d or per chain (C,), and
    ``inv_mass`` (P,) or per chain (C, P). The chain's density and gradient
    at ``q`` are carried in (the reference evaluates them again), or are
    evaluated here when ``logp0`` is None."""
    if logp0 is None:
        logp0, g0 = logp_and_grad(q)
    C, P = q.shape
    dtype, dev = q.dtype, q.device
    p0 = torch.randn((C, P), generator=generator, dtype=dtype, device=dev) / torch.sqrt(inv_mass)
    u_acc = torch.rand((C,), generator=generator, dtype=dtype, device=dev)
    u_jit = torch.rand((C,), generator=generator, dtype=dtype, device=dev)
    eps_c = (eps * (1.0 + jitter * (2.0 * u_jit - 1.0)))[:, None]
    return _hmc_proposal(logp_and_grad, q, logp0, g0, p0, eps_c, inv_mass, num_steps,
                         torch.log(u_acc))


def warmup_schedule(num_warmup: int, init_buffer=75, term_buffer=50, base_window=25):
    """Stan's three-phase warmup: fast start (step size only), doubling slow
    windows (mass matrix), fast tail. Returns a list of (phase, length),
    phase in {'fast', 'slow'}."""
    if num_warmup <= 20:
        return [("fast", num_warmup)] if num_warmup else []
    if init_buffer + term_buffer + base_window > num_warmup:
        init_buffer = max(num_warmup // 4, 1)
        term_buffer = max(num_warmup // 10, 1)
        base_window = num_warmup - init_buffer - term_buffer
    out = [("fast", init_buffer)]
    remaining = num_warmup - init_buffer - term_buffer
    w = base_window
    while remaining > 0:
        if remaining < 2 * w or remaining - w < base_window:
            out.append(("slow", remaining))
            remaining = 0
        else:
            out.append(("slow", w))
            remaining -= w
            w *= 2
    out.append(("fast", term_buffer))
    return out


def _run_window(transition: Callable, state, generator, length: int, da, inv_mass,
                adapt_eps: bool, welford: Optional[WelfordState], target_accept: float,
                keep: bool):
    """``length`` transitions of all chains with pooled step-size adaptation
    (and, given ``welford``, pooled moments of the new positions).
    ``state`` is (q, logp, grad). Returns the new state, dual averaging,
    Welford state, the divergences (0-d), the transitions' host syncs and,
    with ``keep``, the per iteration outputs stacked on axis 1 (the step
    sizes, one per iteration, on axis 0)."""
    divergences = torch.zeros((), dtype=torch.int64, device=state[0].device)
    outs, syncs = {}, 0
    for _ in range(length):
        eps = torch.exp(da.log_eps if adapt_eps else da.log_eps_avg)
        q, logp, g, stats = transition(*state, generator, eps, inv_mass)
        state = (q, logp, g)
        if adapt_eps:
            da = da_update(da, stats["accept_prob"].mean(), target=target_accept)
        if welford is not None:
            welford = welford_update_batch(welford, q)
        divergences = divergences + stats["diverged"].sum()
        syncs += stats.get("host_syncs", 0)
        if keep:
            for k, x in (("u", q), ("log_prob", logp), *stats.items()):
                if k != "host_syncs":
                    outs.setdefault(k, []).append(x)
            outs.setdefault("eps", []).append(eps)
    stacked = None
    if keep:
        stacked = {k: torch.stack(v, 0 if k == "eps" else 1) for k, v in outs.items()}
    return state, da, welford, divergences, syncs, stacked


def run_window(
    transition: Callable,
    qs: torch.Tensor,
    generator: torch.Generator,
    length: int,
    da: DualAveragingState,
    inv_mass: torch.Tensor,
    adapt_eps: bool = True,
    collect_welford: bool = False,
    welford: Optional[WelfordState] = None,
    target_accept: float = 0.8,
):
    """``length`` transitions of all chains from positions ``qs`` (C, P)
    with pooled step-size adaptation (``adapt_eps``) and, with
    ``collect_welford``, pooled Welford moments of the new positions
    (from ``welford``, else empty). ``transition(q, logp, grad, generator,
    eps, inv_mass) -> (q, logp, grad, stats)`` evaluates the density at
    ``q`` when ``logp`` is None (`nuts.nuts_transition_builder`, or
    `_hmc_transition` bound to a density). Returns (qs, da, welford, outs),
    ``outs`` the per-iteration ``u``, ``log_prob`` and transition stats
    stacked on axis 1 and the step sizes ``eps`` on axis 0."""
    if welford is None:
        welford = welford_init(qs.shape[1], qs.dtype, qs.device)
    state, da, moments, _, _, outs = _run_window(
        transition, (qs, None, None), generator, length, da, inv_mass, adapt_eps,
        welford if collect_welford else None, target_accept, keep=True)
    return state[0], da, moments if collect_welford else welford, outs


@_metrics.solve_entry
@torch.no_grad()
def sample(
    logp: Callable,
    u0: torch.Tensor,
    generator: torch.Generator,
    num_warmup: int = 500,
    num_samples: int = 1000,
    num_steps: int = 32,
    target_accept: float = 0.8,
    eps0: float = 0.1,
    adapt_mass: bool = True,
    inv_mass0=None,
    jitter: float = 0.2,
    transition: str = "hmc",
    max_depth: int = 10,
    divergence_threshold: float = 1000.0,
    metrics=None,
) -> SampleResult:
    """Warmup + sampling driver for fixed-length HMC (``transition="hmc"``:
    ``num_steps`` leapfrogs, step jittered by ``jitter``) and NUTS
    (``"nuts"``: ``max_depth`` doublings, divergence at an energy error
    above ``divergence_threshold``). ``logp`` is the batched density
    (C, P) -> (C,); ``u0`` the (C, P) initial positions.

    Warmup follows `warmup_schedule`: dual averaging of the step size on
    the chains' mean acceptance throughout; on each slow window the pooled
    Welford variance of the positions becomes the inverse mass (with
    ``adapt_mass``) and dual averaging restarts at the current average.
    Sampling runs at the averaged step size. ``metrics``: a
    `utils.metrics.MetricsLogger` that gets one record per window."""
    logp_and_grad = value_and_grad(logp)
    if transition == "hmc":
        def step(q, lp, g, gen, eps, inv_mass):
            return _hmc_transition(logp_and_grad, q, lp, g, gen, eps, inv_mass,
                                   int(num_steps), jitter)
    elif transition == "nuts":
        from gptools_tpu_torch.infer import nuts as _nuts

        def step(q, lp, g, gen, eps, inv_mass):
            return _nuts._nuts_transition(logp_and_grad, q, lp, g, gen, eps, inv_mass,
                                          int(max_depth), divergence_threshold)
    else:
        raise ValueError(f"unknown transition {transition!r}")

    u0 = torch.atleast_2d(u0)
    C, P = u0.shape
    dtype, dev = u0.dtype, u0.device
    inv_mass = (torch.ones(P, dtype=dtype, device=dev) if inv_mass0 is None
                else torch.as_tensor(inv_mass0, dtype=dtype, device=dev))
    da = da_init(torch.tensor(eps0, dtype=dtype, device=dev))

    with _metrics.span("solve.warmup"):
        state = (u0, *logp_and_grad(u0))
        div_warmup = torch.zeros((), dtype=torch.int64, device=dev)
        syncs = 0
        for phase, length in warmup_schedule(num_warmup):
            collect = phase == "slow" and adapt_mass
            welford = welford_init(P, dtype, dev) if collect else None
            state, da, welford, div, n_sync, outs = _run_window(
                step, state, generator, length, da, inv_mass, True, welford, target_accept,
                keep=metrics is not None)
            div_warmup = div_warmup + div
            syncs += n_sync
            if metrics is not None:
                metrics.log_window(phase, length, outs)
            if collect:
                inv_mass = welford_variance(welford)
                # restart dual averaging around the current step size (Stan)
                da = da_init(torch.exp(da.log_eps_avg))

    with _metrics.span("solve.sampling"):
        # frozen-adaptation sampling phase
        eps_final = torch.exp(da.log_eps_avg)
        da = da._replace(log_eps=torch.log(eps_final))
        _, _, _, divergences, n_sync, outs = _run_window(
            step, state, generator, num_samples, da, inv_mass, False, None, target_accept,
            keep=True)
    if metrics is not None:
        metrics.log_window("sampling", num_samples, outs)
    diagnostics = {
        "step_size": eps_final,
        "inv_mass": inv_mass,
        "accept_prob": outs["accept_prob"],
        "divergences": divergences,
        "divergences_warmup": div_warmup,
        "num_leapfrog_total": outs["num_leapfrog"].sum(),
        "mean_accept": outs["accept_prob"].mean(),
    }
    if transition == "nuts":
        diagnostics["mean_tree_depth"] = outs["tree_depth"].double().mean()
        diagnostics["host_syncs"] = syncs + n_sync
    return SampleResult(u=outs["u"], thetas=None, log_prob=outs["log_prob"],
                        diagnostics=diagnostics)
