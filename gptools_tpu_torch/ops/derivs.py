"""Mixed partial derivatives of scalar kernel and mean functions.

Counterpart of `gptools_tpu.ops.derivs`: a covariance between an
observation of derivative multi-index ``a`` at ``x1`` and one of ``b`` at
``x2`` is ``d^a/dx1^a d^b/dx2^b k(x1, x2)``, taken exactly by a tower of
forward-mode directional derivatives (`torch.func.jvp` with one-hot
tangents).

The functions here are elementwise over broadcast batches: ``x1 (..., D)``
and ``x2 (..., D)`` broadcast against each other and against the
hyperparameters, and each output entry depends on its own rows only. A
tangent that is one in dimension ``dim`` of every row then gives, in one
jvp, the partial derivative of every entry at once; this takes the place
of the reference's ``vmap`` over points. Only the argument being
differentiated carries a tangent (the others are closed over), so the
subexpressions of the hyperparameters alone cost no tangent work. Where a
covariance needs first derivatives along one dimension only,
`first_order_blocks` takes the value, both first partials and the mixed
one from a single nested tower. `normalize_multi_index` lives in
`gptools_tpu_torch.models.dataset`.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence, Tuple

import torch

from gptools_tpu_torch.models.dataset import MultiIndex, normalize_multi_index

__all__ = [
    "MultiIndex",
    "normalize_multi_index",
    "directional_derivative",
    "mixed_partial",
    "kernel_block_fn",
    "mean_block_fn",
    "first_order_blocks",
]


def directional_derivative(fn: Callable, argnum: int, dim: int) -> Callable:
    """d fn / d args[argnum][..., dim], as a new function with the same
    signature (a jvp with a one-hot tangent; repeated application builds a
    forward-mode tower)."""

    def dfn(*args):
        x = args[argnum]

        def along(a):
            return fn(*args[:argnum], a, *args[argnum + 1:])

        return torch.func.jvp(along, (x,), (_one_hot(x, dim),))[1]

    return dfn


def _one_hot(x: torch.Tensor, dim: int) -> torch.Tensor:
    t = torch.zeros_like(x)
    t[..., dim] = 1.0
    return t


def first_order_blocks(scalar_fn: Callable, dim: int) -> Callable:
    """``(x1, x2, theta) -> (k, d_x1 k, d_x2 k, d_x1 d_x2 k)``, the
    derivatives along dimension ``dim``, from one jvp over x2 of a jvp over
    x1: the four covariance blocks of observations of orders 0 and e_dim,
    sharing every intermediate (separate towers would evaluate the kernel
    four times and its first derivatives three)."""

    def blocks(x1, x2, theta):
        def inner(b):
            return torch.func.jvp(lambda a: scalar_fn(a, b, theta), (x1,), (_one_hot(x1, dim),))

        (k, d1), (d2, d12) = torch.func.jvp(inner, (x2,), (_one_hot(x2, dim),))
        return k, d1, d2, d12

    return blocks


def mixed_partial(fn: Callable, orders: Sequence[MultiIndex]) -> Callable:
    """Apply multi-index partial derivatives to several arguments:
    ``orders[i]`` is the multi-index taken with respect to positional
    argument ``i`` (later arguments, the hyperparameters, get none)."""
    out = fn
    for argnum, mi in enumerate(orders):
        for dim, order in enumerate(mi):
            for _ in range(order):
                out = directional_derivative(out, argnum, dim)
    return out


@functools.lru_cache(maxsize=None)
def _block_cached(scalar_fn, orders: Tuple[MultiIndex, ...]):
    return mixed_partial(scalar_fn, orders)


def _block(scalar_fn: Callable, orders: Tuple[MultiIndex, ...]) -> Callable:
    try:
        return _block_cached(scalar_fn, orders)
    except TypeError:  # unhashable function object: skip the cache
        return mixed_partial(scalar_fn, orders)


def kernel_block_fn(scalar_fn: Callable, a: MultiIndex, b: MultiIndex) -> Callable:
    """``(x1, x2, theta) -> d^a_x1 d^b_x2 k(x1, x2, theta)``."""
    return _block(scalar_fn, (tuple(a), tuple(b)))


def mean_block_fn(scalar_fn: Callable, a: MultiIndex) -> Callable:
    """``(x, theta) -> d^a_x m(x, theta)``."""
    return _block(scalar_fn, (tuple(a),))
