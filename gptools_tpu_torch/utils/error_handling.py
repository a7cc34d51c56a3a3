"""Library-specific exceptions and the reject-don't-crash contract.

Counterpart of `gptools_tpu.utils.error_handling`: ``GPArgumentError`` for
bad user input, and ``GPImpossibleParamsError`` for hyperparameters outside
the feasible region. The densities never raise it: a covariance that does
not factor gives a ``-inf`` log likelihood (`ops.evidence`), so a sampler
rejects the point. It serves eager validation before a run.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["GPArgumentError", "GPImpossibleParamsError", "check_finite_params"]


class GPArgumentError(ValueError):
    """Invalid argument to a GP API (reference ``GPArgumentError``)."""


class GPImpossibleParamsError(ValueError):
    """Hyperparameters outside the feasible region (non-PSD covariance,
    bound violation)."""


def check_finite_params(theta, bounds=None) -> None:
    """Raise `GPImpossibleParamsError` for non-finite hyperparameters or
    one outside its ``(lo, hi)`` bounds; ``theta`` a tensor (read to the
    host) or an array."""
    t = theta.detach().cpu().numpy() if torch.is_tensor(theta) else np.asarray(theta)
    if not np.all(np.isfinite(t)):
        raise GPImpossibleParamsError(f"non-finite hyperparameters: {t}")
    if bounds is not None:
        for i, (lo, hi) in enumerate(bounds):
            if not (lo <= t[i] <= hi):
                raise GPImpossibleParamsError(
                    f"param {i} = {t[i]} outside bounds ({lo}, {hi})"
                )
