"""Iterative multinomial NUTS over all chains in masked lockstep.

Counterpart of `gptools_tpu.infer.nuts`. Tree building is iterative, as in
the reference:

- the trajectory doubles up to ``max_depth`` times, each doubling built
  leaf by leaf with one leapfrog per leaf;
- the generalized U-turn checks of every balanced sub-block of a subtree
  are made incrementally from O(max_depth) checkpointed states: leaf ``a``
  (``a`` even) is stored in slot ``popcount(a)``, and after leaf ``i`` the
  blocks ending at ``i`` are the slots ``popcount(i+1)-1 ..
  popcount(i+1)-2+trailing_zeros(i+1)``;
- proposals are progressive-multinomial within a subtree and biased
  progressive across doublings (Betancourt 2017);
- a divergence (a NaN or an energy error above the threshold) ends the
  doubling and the chain keeps its state (reject, don't crash).

The reference runs this per chain under ``vmap``, where its while loops
become masked loops over the chains; here the chains run the same way.
Every chain sits at the same doubling and leaf, each leaf is one batched
density call over all chains, and a chain that has finished (turned,
diverged, or reached the depth) is frozen: its step is zero, so its row
is evaluated at its own edge, and every carry takes its old value through
`torch.where`. Deciding whether any chain is still active is a host sync:
one per leaf and one per doubling, counted in ``stats["host_syncs"]``.
The reference's ``nuts_transition_builder`` and hashable transition spec
serve XLA's compiled-program cache and have no counterpart.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from gptools_tpu_torch.infer import hmc as _hmc

__all__ = ["sample"]


def _uturn(dz, p_a, p_b, inv_mass):
    """Generalized U-turn, rowwise: the span dz projects negatively on the
    velocity at either end."""
    return ((dz * (inv_mass * p_a)).sum(-1) < 0.0) | ((dz * (inv_mass * p_b)).sum(-1) < 0.0)


def _uturn_slots(i: int):
    """Checkpoint slots whose blocks end at leaf ``i``: the range
    popcount(i+1)-1 .. popcount(i+1)-2+trailing_zeros(i+1) (empty for an
    even ``i``)."""
    m = i + 1
    pc = bin(m).count("1")
    tz = ((m & -m) - 1).bit_length()
    return range(pc - 1, pc - 1 + tz)


def _pick(mask, new, old):
    """Rowwise select: ``new`` where ``mask`` (C,), else ``old``."""
    if new.dim() > 1:
        mask = mask[:, None]
    return torch.where(mask, new, old)


def _build_subtree(logp_and_grad: Callable, edge, v, n_leaf: int, h0, eps, inv_mass,
                   active, generator, max_depth: int, divergence_threshold: float):
    """Build, for the ``active`` chains, a subtree of ``n_leaf`` leaves in
    direction ``v`` (C,) from ``edge`` = (z, p, g). Returns a dict of the
    last leaf (z, p, g), the subtree's proposal (prop_z, prop_logp,
    prop_g), its log weight, the turning and diverged flags, the summed
    acceptance statistic, the leapfrogs and the host syncs."""
    z, p, g = edge
    C, P = z.shape
    dtype, dev = z.dtype, z.device
    neg_inf = torch.full((C,), -math.inf, dtype=dtype, device=dev)
    ckpt_z = torch.zeros((max_depth + 1, C, P), dtype=dtype, device=dev)
    ckpt_p = torch.zeros_like(ckpt_z)
    st = {
        "z": z, "p": p, "g": g, "prop_z": z, "prop_g": g,
        "prop_logp": torch.zeros((C,), dtype=dtype, device=dev),
        "logw": neg_inf,
        "turning": torch.zeros((C,), dtype=torch.bool, device=dev),
        "diverged": torch.zeros((C,), dtype=torch.bool, device=dev),
        "sum_acc": torch.zeros((C,), dtype=dtype, device=dev),
        "n_leap": torch.zeros((C,), dtype=torch.int64, device=dev),
    }
    syncs = 0
    for i in range(n_leaf):
        live = active & ~st["turning"] & ~st["diverged"]
        syncs += 1
        if not bool(live.any()):
            break
        # a frozen chain steps by zero: its row is evaluated at its own edge
        step = torch.where(live, v * eps, 0.0)[:, None]
        zn, pn, logp, gn = _hmc.leapfrog(logp_and_grad, st["z"], st["p"], step, inv_mass,
                                         grad=st["g"])
        delta = -logp + _hmc.kinetic(pn, inv_mass) - h0
        bad = torch.isnan(delta)
        diverged = bad | (delta > divergence_threshold)
        logw_leaf = torch.where(bad, -math.inf, -delta)

        # progressive multinomial proposal within the subtree
        logw = torch.logaddexp(st["logw"], logw_leaf)
        pr_take = torch.exp(logw_leaf - torch.where(torch.isfinite(logw), logw, 0.0))
        unif = torch.rand((C,), generator=generator, dtype=dtype, device=dev)
        take = live & (unif < pr_take) & ~diverged

        # acceptance statistic (Stan's average Metropolis probability)
        acc = torch.where(bad, 0.0, torch.clamp(torch.exp(-delta), max=1.0))

        # checkpoint even leaves at slot popcount(i)
        if i % 2 == 0:
            s = bin(i).count("1")
            ckpt_z[s] = _pick(live, zn, ckpt_z[s])
            ckpt_p[s] = _pick(live, pn, ckpt_p[s])

        # incremental generalized U-turn checks for the blocks ending at leaf i
        turning = torch.zeros_like(diverged)
        for s in _uturn_slots(i):
            turning = turning | _uturn(v[:, None] * (zn - ckpt_z[s]), ckpt_p[s], pn, inv_mass)
        turning = turning & ~diverged

        st = {
            "z": _pick(live, zn, st["z"]),
            "p": _pick(live, pn, st["p"]),
            "g": _pick(live, gn, st["g"]),
            "prop_z": _pick(take, zn, st["prop_z"]),
            "prop_logp": _pick(take, logp, st["prop_logp"]),
            "prop_g": _pick(take, gn, st["prop_g"]),
            "logw": _pick(live, logw, st["logw"]),
            "turning": _pick(live, turning, st["turning"]),
            "diverged": _pick(live, diverged, st["diverged"]),
            "sum_acc": st["sum_acc"] + torch.where(live, acc, 0.0),
            "n_leap": st["n_leap"] + live.to(torch.int64),
        }
    st["host_syncs"] = syncs
    return st


def _nuts_transition(logp_and_grad: Callable, q, logp0, g0, generator, eps, inv_mass,
                     max_depth: int = 10, divergence_threshold: float = 1000.0):
    """One NUTS update of all chains (C, P), their density and gradient at
    ``q`` carried in (the reference evaluates them again). Returns (q,
    logp, grad, stats)."""
    C, P = q.shape
    dtype, dev = q.dtype, q.device
    p0 = torch.randn((C, P), generator=generator, dtype=dtype, device=dev) / torch.sqrt(inv_mass)
    h0 = -logp0 + _hmc.kinetic(p0, inv_mass)
    false = torch.zeros((C,), dtype=torch.bool, device=dev)
    tr = {
        "zl": q, "pl": p0, "gl": g0, "zr": q, "pr": p0, "gr": g0,
        "prop_z": q, "prop_logp": logp0, "prop_g": g0,
        "logw": torch.zeros((C,), dtype=dtype, device=dev),  # the root leaf: -(h0 - h0)
        "done": false, "diverged": false,
        "sum_acc": torch.zeros((C,), dtype=dtype, device=dev),
        "n_leap": torch.zeros((C,), dtype=torch.int64, device=dev),
        "depth": torch.zeros((C,), dtype=torch.int64, device=dev),
    }
    syncs = 0
    for depth in range(max_depth):
        active = ~tr["done"]
        syncs += 1
        if not bool(active.any()):
            break
        right = torch.rand((C,), generator=generator, device=dev) < 0.5
        v = torch.where(right, 1.0, -1.0).to(dtype)
        edge = tuple(_pick(right, tr[a + "r"], tr[a + "l"]) for a in "zpg")
        sub = _build_subtree(logp_and_grad, edge, v, 1 << depth, h0, eps, inv_mass, active,
                             generator, max_depth, divergence_threshold)
        syncs += sub["host_syncs"]

        ok = active & ~sub["turning"] & ~sub["diverged"]
        # biased progressive sampling across doublings
        pr = torch.clamp(torch.exp(sub["logw"] - tr["logw"]), max=1.0)
        unif = torch.rand((C,), generator=generator, dtype=dtype, device=dev)
        take = ok & (unif < pr)
        new = {
            "prop_z": _pick(take, sub["prop_z"], tr["prop_z"]),
            "prop_logp": _pick(take, sub["prop_logp"], tr["prop_logp"]),
            "prop_g": _pick(take, sub["prop_g"], tr["prop_g"]),
            "logw": _pick(ok, torch.logaddexp(tr["logw"], sub["logw"]), tr["logw"]),
        }
        # merge endpoints only if the subtree is kept
        for side, upd in (("r", ok & right), ("l", ok & ~right)):
            for a, b in (("z", "z"), ("p", "p"), ("g", "g")):
                new[a + side] = _pick(upd, sub[b], tr[a + side])
        turn_full = _uturn(new["zr"] - new["zl"], new["pl"], new["pr"], inv_mass)
        new["done"] = tr["done"] | (active & (~ok | turn_full))
        new["diverged"] = tr["diverged"] | (active & sub["diverged"])
        new["sum_acc"] = tr["sum_acc"] + sub["sum_acc"]
        new["n_leap"] = tr["n_leap"] + sub["n_leap"]
        new["depth"] = tr["depth"] + active.to(torch.int64)
        tr = new

    n_leap = tr["n_leap"]
    stats = {
        "accept_prob": tr["sum_acc"] / torch.clamp(n_leap, min=1).to(dtype),
        "diverged": tr["diverged"],
        "num_leapfrog": n_leap,
        "tree_depth": tr["depth"],
        "host_syncs": syncs,
    }
    return tr["prop_z"], tr["prop_logp"], tr["prop_g"], stats


def sample(
    logp: Callable,
    u0: torch.Tensor,
    generator: torch.Generator,
    num_warmup: int = 500,
    num_samples: int = 1000,
    max_depth: int = 10,
    target_accept: float = 0.8,
    eps0: float = 0.1,
    adapt_mass: bool = True,
    inv_mass0=None,
    divergence_threshold: float = 1000.0,
) -> _hmc.SampleResult:
    """Multi-chain NUTS with pooled warmup adaptation: the driver of
    `infer.hmc.sample` with the NUTS transition. ``logp`` is the batched
    density (C, P) -> (C,). Besides the reference's diagnostics:
    ``mean_tree_depth`` (doublings per transition in sampling) and
    ``host_syncs`` (whole run)."""
    return _hmc.sample(
        logp, u0, generator, num_warmup=num_warmup, num_samples=num_samples,
        target_accept=target_accept, eps0=eps0, adapt_mass=adapt_mass,
        inv_mass0=inv_mass0, transition="nuts", max_depth=max_depth,
        divergence_threshold=divergence_threshold,
    )
