"""ChEES-HMC: jittered fixed-length HMC with a cross-chain adaptive
trajectory length (Hoffman, Radul & Sountsov, AISTATS 2021).

Counterpart of `gptools_tpu.infer.chees`. Every chain runs the same number
of leapfrog steps per iteration, so one batched value-and-gradient serves
all chains; the trajectory time adapts by Adam on the pooled ChEES
criterion (optionally per leapfrog, ``cost_normalize``) and the step size by
pooled dual averaging. PyTorch runs eagerly: the reference's compiled-
program cache, warm-compile threads and chunked scans have no counterpart,
and the leapfrog loop is a Python loop over ``int(L)``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from gptools_tpu_torch.infer import hmc as _hmc
from gptools_tpu_torch.infer.hmc import SampleResult
from gptools_tpu_torch.utils import metrics

__all__ = ["sample", "chees_step", "CheesState"]


def _halton(i: int, base: int = 2) -> torch.Tensor:
    """Radical-inverse Halton element in (0, 1), in float32 as the
    reference evaluates it (16 digits)."""
    val = torch.zeros((), dtype=torch.float32)
    inv = torch.ones((), dtype=torch.float32)
    idx = i + 1
    for _ in range(16):
        inv = inv / base
        val = val + float(idx % base) * inv
        idx //= base
    return val


class CheesState(NamedTuple):
    qs: torch.Tensor       # (C, P) positions
    logps: torch.Tensor    # (C,)
    grads: torch.Tensor    # (C, P)
    da: _hmc.DualAveragingState
    log_tau: torch.Tensor  # 0-d log of the shared trajectory TIME
    adam_m: torch.Tensor
    adam_v: torch.Tensor
    iteration: int


def chees_step(
    logp_and_grad: Callable,
    state: CheesState,
    inv_mass: torch.Tensor,
    generator: torch.Generator,
    target_accept: float = 0.75,
    adapt: bool = True,
    adam_lr: float = 0.025,
    max_steps: int = 1024,
    cost_normalize: bool = False,
    cost_elasticity: float = 1.0,
):
    """One ChEES-HMC iteration over all chains (a ``chees.transition``
    span). ``logp_and_grad`` is batched: (C, P) -> ((C,), (C, P)). Returns
    (new state, stats)."""
    with metrics.span("chees.transition"):
        C, P = state.qs.shape
        dtype, dev = state.qs.dtype, state.qs.device

        eps = torch.exp(state.da.log_eps if adapt else state.da.log_eps_avg)
        tau = torch.exp(state.log_tau)
        with metrics.host_sync("chees.halton"):  # a copy to the card waits for its stream
            h = _halton(state.iteration).to(dtype=dtype, device=dev)
        with metrics.host_sync("chees.trajectory_length"):
            L = int(torch.clamp(torch.ceil(h * tau / eps), 1, max_steps))

        p0 = torch.randn((C, P), generator=generator, dtype=dtype, device=dev) / torch.sqrt(
            inv_mass
        )

        q, p, logp, g = state.qs, p0, state.logps, state.grads
        for _ in range(L):
            q, p, logp, g = _hmc.leapfrog(logp_and_grad, q, p, eps, inv_mass, grad=g)
        qn, pn, logpn, gn = q, p, logp, g

        def kin(p_):
            return 0.5 * (p_ * p_ * inv_mass).sum(-1)

        h0 = -state.logps + kin(p0)
        h1 = -logpn + kin(pn)
        log_accept = torch.clamp(h0 - h1, max=0.0)
        log_accept = torch.where(torch.isnan(log_accept), -math.inf, log_accept)
        accept_prob = torch.exp(log_accept)
        unif = torch.rand((C,), generator=generator, dtype=dtype, device=dev)
        accept = torch.log(unif) < log_accept

        q_out = torch.where(accept[:, None], qn, state.qs)
        logp_out = torch.where(accept, logpn, state.logps)
        g_out = torch.where(accept[:, None], gn, state.grads)

        stats = {
            "accept_prob": accept_prob,
            "diverged": (h1 - h0) > 1000.0,
            "num_leapfrog": L,
            "eps": eps,
            "tau": tau,
        }
        if not adapt:
            return state._replace(
                qs=q_out, logps=logp_out, grads=g_out, iteration=state.iteration + 1
            ), stats

        # --- ChEES trajectory-length adaptation (pooled across chains) ---
        # diverged chains give NaN endpoints; mask them out of every statistic
        finite = torch.isfinite(qn).all(1) & torch.isfinite(accept_prob)
        qn_safe = torch.where(finite[:, None], qn, 0.0)
        n_fin = torch.clamp(finite.to(dtype).sum(), min=1.0)
        mean_q = state.qs.mean(0)
        mean_qn = qn_safe.sum(0) / n_fin
        dq0 = state.qs - mean_q
        dq1 = qn_safe - mean_qn
        vel = torch.where(finite[:, None], pn * inv_mass, 0.0)
        dsq = (dq1 * dq1).sum(1) - (dq0 * dq0).sum(1)
        per_chain = dsq * (dq1 * vel).sum(1)
        w = torch.where(finite, accept_prob, 0.0)
        w_sum = torch.clamp(w.sum(), min=1e-6)
        grad_tau = (w * per_chain).sum() / w_sum
        grad_tau = torch.where(torch.isfinite(grad_tau), grad_tau, 0.0)

        if cost_normalize:
            # maximize the criterion PER UNIT INTEGRATION TIME: d log(C/t)/d log t
            # = elasticity - 1, with the equilibrium target `cost_elasticity`
            # (see the reference's chees_step for the derivation)
            crit = (w * dsq * dsq).sum() / w_sum
            t_real = L * eps
            elasticity = t_real * 4.0 * grad_tau / torch.clamp(crit, min=1e-12)
            grad_tau = torch.clamp(elasticity - cost_elasticity, -10.0, 10.0)
            grad_tau = torch.where(torch.isfinite(grad_tau), grad_tau, 0.0)

        t_f = float(state.iteration)
        norm_g = grad_tau / (torch.abs(grad_tau) + 1e-12) * torch.clamp(
            torch.abs(grad_tau), max=1e3
        )
        b1, b2 = 0.9, 0.999
        m = b1 * state.adam_m + (1 - b1) * norm_g
        v = b2 * state.adam_v + (1 - b2) * norm_g * norm_g
        mh = m / (1 - b1 ** (t_f + 1))
        vh = v / (1 - b2 ** (t_f + 1))
        log_tau = state.log_tau + adam_lr * mh / (torch.sqrt(vh) + 1e-8)
        # static bounds (the reference explains why not eps-relative ones)
        log_tau = torch.clamp(log_tau, math.log(1e-3), math.log(1e4))
        da = _hmc.da_update(state.da, accept_prob.mean(), target=target_accept)
        return CheesState(
            qs=q_out, logps=logp_out, grads=g_out, da=da, log_tau=log_tau,
            adam_m=m, adam_v=v, iteration=state.iteration + 1,
        ), stats


# the batched value and gradient every sampler uses (`hmc.value_and_grad`)
_value_and_grad = _hmc.value_and_grad


@metrics.solve_entry
@torch.no_grad()
def sample(
    logp: Callable,
    u0: torch.Tensor,
    generator: torch.Generator,
    num_warmup: int = 300,
    num_samples: int = 500,
    target_accept: float = 0.75,
    eps0: float = 0.1,
    tau0: Optional[float] = None,
    inv_mass0=None,
    max_steps: int = 1024,
    adam_lr: float = 0.025,
    cost_normalize: bool = False,
    cost_elasticity: float = 1.0,
) -> SampleResult:
    """Vectorized ChEES-HMC: ``num_warmup`` adapting iterations, then
    ``num_samples`` at the averaged step size. ``logp`` is the batched
    density (C, P) -> (C,); ``u0`` the (C, P) initial positions."""
    C, P = u0.shape
    dtype, dev = u0.dtype, u0.device
    inv_mass = (
        torch.ones(P, dtype=dtype, device=dev)
        if inv_mass0 is None
        else torch.as_tensor(inv_mass0, dtype=dtype, device=dev)
    )
    tau_init = float(tau0) if tau0 is not None else eps0 * 8.0
    logp_and_grad = _value_and_grad(logp)
    kw = dict(
        target_accept=target_accept, adam_lr=adam_lr, max_steps=max_steps,
        cost_normalize=cost_normalize, cost_elasticity=cost_elasticity,
    )

    with metrics.span("solve.warmup"):
        logps, grads = logp_and_grad(u0)
        zero = torch.zeros((), dtype=dtype, device=dev)
        state = CheesState(
            qs=u0, logps=logps, grads=grads,
            da=_hmc.da_init(torch.tensor(eps0, dtype=dtype, device=dev)),
            log_tau=torch.log(torch.tensor(tau_init, dtype=dtype, device=dev)),
            adam_m=zero, adam_v=zero, iteration=0,
        )
        div_w = torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(num_warmup):
            state, st = chees_step(logp_and_grad, state, inv_mass, generator, adapt=True, **kw)
            div_w += st["diverged"].sum()

    with metrics.span("solve.sampling"):
        # freeze: sample at the averaged step size
        eps_final = torch.exp(state.da.log_eps_avg)
        state = state._replace(da=state.da._replace(log_eps=torch.log(eps_final)))

        us, lps, accs = [], [], []
        divergences = torch.zeros((), dtype=torch.int64, device=dev)
        n_leap = 0
        for _ in range(num_samples):
            state, st = chees_step(logp_and_grad, state, inv_mass, generator, adapt=False,
                                   **kw)
            us.append(state.qs)
            lps.append(state.logps)
            accs.append(st["accept_prob"])
            divergences += st["diverged"].sum()
            n_leap += st["num_leapfrog"] * C

    acc = torch.stack(accs, 1)
    diagnostics = {
        "step_size": eps_final,
        "trajectory_time": torch.exp(state.log_tau),
        "inv_mass": inv_mass,
        "accept_prob": acc,
        "divergences": divergences,
        "divergences_warmup": div_w,
        "num_leapfrog_total": n_leap,
        "mean_accept": acc.mean(),
    }
    return SampleResult(
        u=torch.stack(us, 1), thetas=None, log_prob=torch.stack(lps, 1),
        diagnostics=diagnostics,
    )
