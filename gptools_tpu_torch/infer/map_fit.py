"""Multi-start MAP estimation with a batched L-BFGS.

Counterpart of `gptools_tpu.infer.map_fit`: starts drawn from the
hyperprior (half of them re-spread log-uniformly where a bound spans two
decades or more), optionally the model's current point, each optimized in
the unconstrained space on the log posterior; the best finite start wins.

The reference ``vmap``s ``optax.lbfgs()`` over the starts; here one L-BFGS
runs every start at once (`minimize`), with optax 0.2.6's algorithm per
row: memory 10, the identity scaled by s^T y / y^T y (the capped inverse
gradient norm at the first step), and the zoom line search for the strong
Wolfe conditions (c1 1e-4, c2 0.9, the approximate-decrease test at 1e-6,
at most 20 trials, first guess 1, interval threshold 1e-5). Each start
keeps its own history, step and line-search state; every line-search
trial is one batched density call over all starts, and a start whose
search has ended is frozen by `torch.where`. Deciding whether any search
is still open is a host sync per trial. A start whose density is -inf
(the evidence kernel's contract, with a zero gradient) takes step zero:
optax's search ends there after its 20 trials, this one at once; the
start reports unconverged, and no other row is touched. A trial step that
leaves the density's support reads as an infinite decrease error and the
search shrinks it. Method ``"adam"`` uses `torch.optim.Adam` with optax's defaults and
zeroes non-finite gradient entries, as the reference does. The
reference's compiled-program cache (``_optimizer_program``) serves XLA's
compilation and has no counterpart.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from gptools_tpu_torch.infer import model_logp
from gptools_tpu_torch.infer.hmc import value_and_grad

__all__ = ["MAPResult", "minimize", "optimize"]

MEMORY = 10
C1, C2 = 1e-4, 0.9            # sufficient decrease, curvature
APPROX_DEC_RTOL = 1e-6
MAX_LINESEARCH_STEPS = 20
INCREASE_FACTOR = 2.0
INTERVAL_THRESHOLD = 1e-5


class MAPResult(NamedTuple):
    theta: torch.Tensor               # best constrained hyperparameters (P,)
    u: torch.Tensor                   # best unconstrained free vector
    log_posterior: torch.Tensor       # value at the optimum
    all_log_posteriors: torch.Tensor  # per-start final values
    all_thetas: torch.Tensor          # per-start final constrained params
    converged: torch.Tensor           # per-start finiteness flag


def _dot(a, b):
    return (a * b).sum(-1)


def _where(mask, new, old):
    """Rowwise select of (B,) or (B, P) tensors by a (B,) mask."""
    return torch.where(mask[:, None] if new.dim() > 1 else mask, new, old)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (NaN where there is none), rowwise."""
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    r1, r2 = fb - fa - C * db, fc - fa - C * dc
    A = (dc**2 * r1 - db**2 * r2) / denom
    B = (-(dc**3) * r1 + db**3 * r2) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a, rowwise."""
    db = b - a
    B = (fb - fa - fpa * db) / (db**2)
    return a - fpa / (2.0 * B)


def _errors(step, value, slope, value_init, slope_init):
    """(decrease error, curvature error) of a trial, optax's definitions:
    each >= 0, NaN read as inf."""
    dec = value - value_init - C1 * step * slope_init
    approx = torch.maximum(slope - (2 * C1 - 1.0) * slope_init,
                           value - value_init - APPROX_DEC_RTOL * value_init.abs())
    dec = torch.clamp(torch.minimum(approx, dec), min=0.0)
    dec = torch.where(torch.isnan(dec), math.inf, dec)
    curv = torch.clamp(slope.abs() - C2 * slope_init.abs(), min=0.0)
    curv = torch.where(torch.isnan(curv), math.inf, curv)
    return dec, curv


def _linesearch(f_and_g: Callable, x, d, value, grad):
    """optax's zoom line search along ``d`` from ``x`` (B, P) with the
    objective's ``value`` (B,) and ``grad`` there, every row at once.
    Returns (stepsize, value, grad) at the accepted step, and the number
    of batched calls and host syncs."""
    B = x.shape[0]
    dtype, dev = x.dtype, x.device
    zero = torch.zeros((B,), dtype=dtype, device=dev)
    false = torch.zeros((B,), dtype=torch.bool, device=dev)
    slope0 = _dot(d, grad)
    s = dict(
        count=torch.zeros((B,), dtype=torch.int64, device=dev),
        stepsize=zero, value=value, grad=grad, slope=slope0,
        # a start whose objective is not finite ends at once on step zero,
        # where optax's search ends after its 20 trials
        dec=torch.full_like(zero, math.inf), found=false, done=false,
        failed=~torch.isfinite(value),
        low=zero, value_low=value, slope_low=slope0,
        high=zero, value_high=value, slope_high=slope0,
        cubic_ref=zero, value_cubic_ref=value,
        safe=zero, safe_value=value, safe_grad=grad,
    )
    calls = syncs = 0
    for _ in range(MAX_LINESEARCH_STEPS):
        live = ~(s["done"] | s["failed"])
        syncs += 1
        if not bool(live.any()):
            break
        first = s["count"] == 0
        # the interval search's next trial
        new_step = torch.where(first, 1.0, INCREASE_FACTOR * s["stepsize"])
        # the zoom's next trial: cubic, else quadratic, else bisection
        low, high = s["low"], s["high"]
        delta = (high - low).abs()
        left, right = torch.minimum(high, low), torch.maximum(high, low)
        mid_c = _cubicmin(low, s["value_low"], s["slope_low"], high, s["value_high"],
                          s["cubic_ref"], s["value_cubic_ref"])
        use_c = (mid_c > left + 0.2 * delta) & (mid_c < right - 0.2 * delta)
        mid_q = _quadmin(low, s["value_low"], s["slope_low"], high, s["value_high"])
        use_q = ~use_c & (mid_q > left + 0.1 * delta) & (mid_q < right - 0.1 * delta)
        middle = torch.where(use_c, mid_c, s["cubic_ref"])
        middle = torch.where(use_q, mid_q, middle)
        middle = torch.where(~use_c & ~use_q, 0.5 * (low + high), middle)
        trial = torch.where(s["found"], middle, new_step)
        # a row whose search has ended is evaluated at its own point, unused
        v_t, g_t = f_and_g(x + torch.where(live, trial, 0.0)[:, None] * d)
        calls += 1
        slope_t = _dot(g_t, d)
        dec, curv = _errors(trial, v_t, slope_t, value, slope0)
        err = torch.maximum(dec, curv)
        count = s["count"] + 1

        # -- interval search (Nocedal and Wright, Algorithm 3.5) --
        safe_dec = dec <= 0.0
        srch_safe = _where(safe_dec, trial, s["safe"])
        srch_safe_v = _where(safe_dec, v_t, s["safe_value"])
        srch_safe_g = _where(safe_dec, g_t, s["safe_grad"])
        hi_new = (dec > 0.0) | ((v_t >= s["value"]) & ~first)
        lo_new = (slope_t >= 0.0) & ~hi_new
        srch = {
            "low": torch.where(lo_new, trial, s["stepsize"]),
            "value_low": torch.where(lo_new, v_t, s["value"]),
            "slope_low": torch.where(lo_new, slope_t, s["slope"]),
            "high": torch.where(lo_new, s["stepsize"], trial),
            "value_high": torch.where(lo_new, s["value"], v_t),
            "slope_high": torch.where(lo_new, s["slope"], slope_t),
        }
        srch["cubic_ref"], srch["value_cubic_ref"] = srch["low"], srch["value_low"]
        srch_found = hi_new | lo_new | (err <= 0.0)
        srch_done = err <= 0.0

        # -- zoom (Algorithm 3.6) --
        upd_safe = safe_dec & (v_t < s["safe_value"])
        zm_safe = _where(upd_safe, trial, s["safe"])
        zm_safe_v = _where(upd_safe, v_t, s["safe_value"])
        zm_safe_g = _where(upd_safe, g_t, s["safe_grad"])
        hi_mid = (dec > 0.0) | (v_t >= s["value_low"])
        hi_low = (slope_t * (high - low) >= 0.0) & ~hi_mid
        lo_mid = ~hi_mid
        nh = torch.where(hi_mid, trial, high)
        nvh = torch.where(hi_mid, v_t, s["value_high"])
        nsh = torch.where(hi_mid, slope_t, s["slope_high"])
        zoom = {
            "high": torch.where(hi_low, low, nh),
            "value_high": torch.where(hi_low, s["value_low"], nvh),
            "slope_high": torch.where(hi_low, s["slope_low"], nsh),
            "low": torch.where(lo_mid, trial, low),
            "value_low": torch.where(lo_mid, v_t, s["value_low"]),
            "slope_low": torch.where(lo_mid, slope_t, s["slope_low"]),
            "cubic_ref": torch.where(hi_mid | hi_low, high, low),
            "value_cubic_ref": torch.where(hi_mid | hi_low, s["value_high"], s["value_low"]),
        }
        zm_failed = (count >= MAX_LINESEARCH_STEPS) | ((delta <= INTERVAL_THRESHOLD) & (zm_safe > 0.0))

        f = s["found"]
        new = {k: torch.where(f, zoom[k], srch[k]) for k in zoom}
        new.update(
            count=count, stepsize=trial, value=v_t, grad=g_t, slope=slope_t, dec=dec,
            found=f | srch_found,
            done=torch.where(f, err <= 0.0, srch_done),
            safe=torch.where(f, zm_safe, srch_safe),
            safe_value=torch.where(f, zm_safe_v, srch_safe_v),
            safe_grad=_where(f, zm_safe_g, srch_safe_g),
        )
        new["failed"] = torch.where(f, zm_failed, count >= MAX_LINESEARCH_STEPS) & ~new["done"]
        # a failed search falls back on its safe step (sufficient decrease
        # only; zero when none was found or the trial left the domain)
        fall = new["failed"] & ((new["safe"] > 0.0) | torch.isinf(dec))
        new["stepsize"] = torch.where(fall, new["safe"], new["stepsize"])
        new["value"] = torch.where(fall, new["safe_value"], new["value"])
        new["grad"] = _where(fall, new["safe_grad"], new["grad"])
        s = {k: _where(live, new[k], s[k]) for k in s}
    return s["stepsize"], s["value"], s["grad"], calls, syncs


def _lbfgs(f_and_g: Callable, u0: torch.Tensor, num_steps: int):
    """``num_steps`` of optax 0.2.6's ``lbfgs()`` on every row of ``u0``
    (B, P), minimizing the batched objective. Returns (u, calls, syncs)."""
    B, P = u0.shape
    dtype, dev = u0.dtype, u0.device
    ds = torch.zeros((B, MEMORY, P), dtype=dtype, device=dev)   # parameter differences
    dg = torch.zeros_like(ds)                                   # gradient differences
    rho = torch.zeros((B, MEMORY), dtype=dtype, device=dev)
    x = u0
    value, grad = f_and_g(x)
    calls, syncs = 1, 0
    x_prev, g_prev = torch.zeros_like(x), torch.zeros_like(x)
    for k in range(num_steps):
        # value_and_grad_from_state: reuse the line search's value and
        # gradient, recomputing where the value is inf or NaN
        if k > 0:
            stale = ~torch.isfinite(value)
            syncs += 1
            if bool(stale.any()):
                v2, g2 = f_and_g(x)
                calls += 1
                value, grad = _where(stale, v2, value), _where(stale, g2, grad)
        idx, prev = k % MEMORY, (k - 1) % MEMORY
        if k > 0:
            s_k, y_k = x - x_prev, grad - g_prev
            sy = _dot(y_k, s_k)
            ds[:, prev], dg[:, prev] = s_k, y_k
            rho[:, prev] = torch.where(sy == 0.0, 0.0, 1.0 / sy)
            yy = _dot(y_k, y_k)
            gamma = torch.where(yy > 0.0, sy / yy, 1.0)
        else:
            gamma = torch.clamp(1.0 / grad.norm(dim=-1), max=1.0)
        # two-loop recursion, oldest slot last in the first loop
        order = [(idx + j) % MEMORY for j in range(MEMORY)]
        q = grad
        alphas = {}
        for j in reversed(order):
            alphas[j] = rho[:, j] * _dot(ds[:, j], q)
            q = q - alphas[j][:, None] * dg[:, j]
        r = gamma[:, None] * q
        for j in order:
            beta = rho[:, j] * _dot(dg[:, j], r)
            r = r + (alphas[j] - beta)[:, None] * ds[:, j]
        d = -r
        step, v_new, g_new, n_calls, n_syncs = _linesearch(f_and_g, x, d, value, grad)
        calls += n_calls
        syncs += n_syncs
        x_prev, g_prev = x, grad
        x = x + step[:, None] * d
        value, grad = v_new, g_new
    return x, calls, syncs


def _adam(f_and_g: Callable, u0: torch.Tensor, num_steps: int, learning_rate: float):
    """``num_steps`` of Adam (optax's defaults) on every row of ``u0``."""
    x = u0.detach().clone()
    opt = torch.optim.Adam([x], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(num_steps):
        _, g = f_and_g(x)
        x.grad = torch.where(torch.isfinite(g), g, 0.0)
        opt.step()
    return x.detach(), num_steps, 0


@torch.no_grad()
def minimize(logp_batched: Callable, u0s: torch.Tensor, num_steps: int = 200,
             method: str = "lbfgs", learning_rate: float = 0.05):
    """Maximize the batched density (B, P) -> (B,) from each row of ``u0s``
    at once. Returns (us (B, P), their log densities (B,), stats: the
    batched density calls and host syncs)."""
    vg = value_and_grad(logp_batched)

    def f_and_g(u):
        v, g = vg(u)
        return -v, -g

    if method == "lbfgs":
        us, calls, syncs = _lbfgs(f_and_g, u0s, int(num_steps))
    elif method == "adam":
        us, calls, syncs = _adam(f_and_g, u0s, int(num_steps), float(learning_rate))
    else:
        raise ValueError(f"unknown method {method!r}")
    return us, logp_batched(us), {"density_calls": calls + 1, "host_syncs": syncs}


def start_points(model, generator: torch.Generator, random_starts: int, dtype, device,
                 include_current: bool = True) -> torch.Tensor:
    """The reference's starts in u: prior draws, the first half of them
    re-spread log-uniformly over every free parameter whose bounds are
    positive, finite and two decades or more apart, and the current point
    first with ``include_current``."""
    thetas0 = model.hyperprior.sample(generator, (random_starts,), dtype).to(device)
    bounds = np.asarray([tuple(b) for b in model.param_bounds], dtype=np.float64)
    if random_starts >= 2:
        lo, hi = bounds[:, 0], bounds[:, 1]
        log_spread = (lo > 0.0) & np.isfinite(hi) & (hi / np.maximum(lo, 1e-300) >= 1e2)
        if log_spread.any():
            n_log = random_starts // 2
            draw = torch.rand((n_log, bounds.shape[0]), generator=generator, dtype=dtype,
                              device=generator.device).to(device)
            mask = torch.as_tensor(log_spread, device=device)
            log_lo = torch.log(torch.as_tensor(np.where(log_spread, lo, 1.0), dtype=dtype,
                                               device=device))
            log_hi = torch.log(torch.as_tensor(np.where(log_spread, hi, 1.0), dtype=dtype,
                                               device=device))
            log_draws = torch.exp(log_lo + draw * (log_hi - log_lo))
            thetas0 = thetas0.clone()
            thetas0[:n_log] = torch.where(mask, log_draws, thetas0[:n_log])
    u0s = model.u_of_theta(thetas0)
    if include_current:
        cur = torch.tensor(model.initial_params, dtype=dtype, device=device)
        u0s = torch.cat([model.u_of_theta(cur)[None], u0s], 0)
    return u0s


def optimize(model, data, generator: torch.Generator, random_starts: int = 8,
             num_steps: int = 200, method: str = "lbfgs", learning_rate: float = 0.05,
             include_current: bool = True) -> MAPResult:
    """Maximize ``model.log_posterior_u`` on ``data`` from `start_points`,
    all starts in one batched optimization (`minimize`). Returns the best
    finite start's parameters (the reference's semantics); the per-start
    values are kept, with ``converged`` their finiteness."""
    u0s = start_points(model, generator, random_starts, data.dtype, data.device,
                       include_current)
    us, lps, _ = minimize(model_logp(model, data), u0s, num_steps, method, learning_rate)
    finite = torch.isfinite(lps)
    masked = torch.where(finite, lps, -math.inf)
    best = torch.argmax(masked)
    all_thetas = model.theta_of_u(us)
    return MAPResult(theta=all_thetas[best], u=us[best], log_posterior=masked[best],
                     all_log_posteriors=lps, all_thetas=all_thetas, converged=finite)
