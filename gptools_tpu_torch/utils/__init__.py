"""Bijectors, priors, bounds, chain diagnostics, the native diagnostics
binding, checkpoints, plotting, combinatorics and the library's errors.

Counterpart of `gptools_tpu.utils`, with its exports.
"""

import numpy as np

from .bounds import CombinedBounds, MaskedBounds  # noqa: F401
from .combinatorics import (  # noqa: F401
    fixed_poch,
    generate_set_partition_strings,
    generate_set_partitions,
    incomplete_bell_poly,
)


def unique_rows(arr):
    """Unique rows of a 2-D array in order of first occurrence
    (``gptools/utils.py :: unique_rows``); host-side numpy."""
    a = np.asarray(arr)
    if a.ndim != 2:
        raise ValueError("unique_rows expects a 2-D array")
    _, idx = np.unique(a, axis=0, return_index=True)
    return a[np.sort(idx)]
