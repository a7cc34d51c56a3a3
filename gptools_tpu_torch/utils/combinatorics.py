"""Combinatorial helpers of the reference's derivative machinery.

Counterpart of `gptools_tpu.utils.combinatorics` (the original
``gptools/utils.py :: incomplete_bell_poly, generate_set_partitions,
generate_set_partition_strings, fixed_poch``), kept as its own copy. The
covariance derivatives never call them: they come from autograd
(`ops.derivs`). They are host-side numpy utilities, for validating those
derivatives against the Faa di Bruno expansion and for code written
against the original API.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "incomplete_bell_poly",
    "generate_set_partition_strings",
    "generate_set_partitions",
    "fixed_poch",
]


def incomplete_bell_poly(p, q, x):
    """Incomplete exponential Bell polynomial ``B_{p,q}(x_1, ..., x_{p-q+1})``.

    ``x`` is indexed on axis 0 (``x[0] = x_1``; extra entries are unused)
    and any further axes broadcast, so the polynomial is evaluated
    elementwise over them. Recurrence: ``B_{0,0} = 1``, ``B_{p,0} = 0``
    (p >= 1), ``B_{0,q} = 0`` (q >= 1), ``B_{p,q} = sum_{k=1}^{p-q+1}
    C(p-1, k-1) x_k B_{p-k, q-1}``; with every ``x_k = 1`` it is the
    Stirling number of the second kind ``S(p, q)``. Returns a float, or an
    array of ``x``'s trailing shape.
    """
    p = int(p)
    q = int(q)
    if p < 0 or q < 0:
        raise ValueError("incomplete_bell_poly requires p >= 0 and q >= 0")
    x = np.asarray(x, dtype=float)
    if x.ndim == 0:
        x = x[None]
    tail = x.shape[1:]

    # B[j][m] over j in 0..p, m in 0..q, each an array of shape `tail`
    zero = np.zeros(tail)
    B = [[zero for _ in range(q + 1)] for _ in range(p + 1)]
    B[0][0] = np.ones(tail)
    for j in range(1, p + 1):
        # only the B[j][m] with m >= q - (p - j) feed B[p][q]; restricting to
        # them keeps every x index within x_1..x_{p-q+1}
        for m in range(max(1, q - (p - j)), min(j, q) + 1):
            acc = np.zeros(tail)
            for k in range(1, j - m + 2):
                if k - 1 >= x.shape[0]:
                    raise ValueError(
                        f"incomplete_bell_poly(p={p}, q={q}) needs x_1..x_"
                        f"{p - q + 1}; got only {x.shape[0]} entries"
                    )
                acc = acc + math.comb(j - 1, k - 1) * x[k - 1] * B[j - k][m - 1]
            B[j][m] = acc
    out = B[p][q]
    return out if tail else float(out)


def generate_set_partition_strings(n):
    """All restricted-growth strings of length ``n`` (one per set partition
    of ``{1..n}``, Bell(n) of them), as lists of ints in lexicographic
    order; ``[]`` for n = 0."""
    n = int(n)
    if n < 0:
        raise ValueError("n must be >= 0")
    if n == 0:
        return []
    out = []

    def rec(prefix, max_seen):
        if len(prefix) == n:
            out.append(list(prefix))
            return
        for v in range(max_seen + 2):
            prefix.append(v)
            rec(prefix, max(max_seen, v))
            prefix.pop()

    rec([0], 0)
    return out


def generate_set_partitions(items):
    """All set partitions of ``items`` as lists of lists, each listing its
    blocks in order of first appearance (Bell(n) of them)."""
    items = list(items)
    if not items:
        return [[]]
    parts = []
    for s in generate_set_partition_strings(len(items)):
        blocks = [[] for _ in range(max(s) + 1)]
        for item, b in zip(items, s):
            blocks[b].append(item)
        parts.append(blocks)
    return parts


def fixed_poch(a, n):
    """Pochhammer symbol ``(a)_n = Gamma(a+n)/Gamma(a)``, finite at the
    gamma poles (``a`` a non-positive integer): for integer ``n >= 0`` the
    rising factorial ``a (a+1) ... (a+n-1)`` as a direct product, else
    ``scipy.special.poch``. Vectorized over ``a``."""
    a = np.asarray(a, dtype=float)
    if float(n) == int(n) and int(n) >= 0:
        out = np.ones_like(a)
        for k in range(int(n)):
            out = out * (a + k)
        return out if out.ndim else float(out)
    from scipy.special import poch

    out = poch(a, n)
    return out if np.ndim(out) else float(out)
