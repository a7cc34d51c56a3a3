"""Operations, bytes and the least time of one evidence-kernel launch.

A frozen copy of ``chip_smoke.py::bound`` and its constants
(``PEAK_FLOPS``, ``PEAK_BYTES``, ``PAIR_FLOPS``): exact loop counts of the
Cholesky factorization, the two triangular solves, L^-1 and K^-1 at the
pairs, two flops per multiply-add, plus the flops of one pair's covariance
and its hand-derived VJP (counted from ``csrc/pair_math.cuh``, a
transcendental as one); bytes are theta and the aux rows in, ll, the
gradient and the aux cotangents out, and the (N,) constants once.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: CUDA-core (non-tensor) FP32 and FP64, HBM3.
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
PEAK_BYTES = 3.35e12
PAIR_FLOPS = {"gibbs_tanh": 150, "se": 45, "matern52": 55}
ITEM = {"float32": 4, "float64": 8}


def flops_per_chain(kind: str, n: int) -> int:
    """Flops of one chain's value and gradient of the evidence at N = n."""
    chol = sum(j for i in range(n) for j in range(i + 1))
    solves = n * (n - 1)
    linv = sum(i - j - 1 for j in range(n) for i in range(j + 1, n))
    kinv = sum((n - i) * (i + 1) for i in range(n))
    pairs = n * (n + 1) // 2
    return 2 * (chol + solves + linv + kinv) + PAIR_FLOPS[kind] * pairs


def launch_bytes(n: int, chains: int, theta_rows: int, aux: int, dtype: str) -> int:
    """Bytes one launch must move at ``chains`` chains."""
    return chains * ITEM[dtype] * (2 * theta_rows + 1 + 2 * n * aux) + n * (3 * 8 + 4)


def launch_bound_s(ev: dict, chains: int, dtype: str) -> float:
    """Least seconds of one launch: the larger of its flops over the peak
    and its bytes over the bandwidth. ``ev``: the configuration's
    ``evidence`` entry (kind, n, theta_rows, aux)."""
    t_ops = chains * flops_per_chain(ev["kind"], ev["n"]) / PEAK_FLOPS[dtype]
    t_bytes = launch_bytes(ev["n"], chains, ev["theta_rows"], ev["aux"], dtype) / PEAK_BYTES
    return max(t_ops, t_bytes)
