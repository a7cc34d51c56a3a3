"""Observation container with derivative orders.

Counterpart of `gptools_tpu.models.dataset`. The builder stays numpy right up
to ``build(dtype, device)``, which places the finished `Dataset` on an
explicit device. Transformed (line-integral) observations, the ``T`` matrix
of the reference, are ROADMAP Queue 1 item 10: ``add(..., T=...)`` raises.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["Dataset", "DatasetBuilder"]

MultiIndex = Tuple[int, ...]


def normalize_multi_index(n, num_dim: int) -> MultiIndex:
    """Canonical multi-index tuple for a derivative order (as
    `gptools_tpu.ops.derivs.normalize_multi_index`)."""
    if isinstance(n, int):
        if n < 0:
            raise ValueError("derivative order must be >= 0")
        if num_dim == 1:
            return (int(n),)
        if n == 0:
            return (0,) * num_dim
        raise ValueError(
            "scalar derivative order > 0 is ambiguous for num_dim > 1; "
            "pass a per-dimension multi-index"
        )
    t = tuple(int(v) for v in n)
    if len(t) != num_dim:
        raise ValueError(f"multi-index length {len(t)} != num_dim {num_dim}")
    if any(v < 0 for v in t):
        raise ValueError("derivative orders must be >= 0")
    return t


class Dataset:
    """Frozen observation set on one device.

    Attributes:
      Xf: (Q, D) evaluation points.
      nid: (Q,) int32 ids into ``multi_indices``.
      y: (Q,) observed values.
      err_y: (Q,) observation noise standard deviations.
      multi_indices: tuple of derivative multi-index tuples.
    """

    def __init__(self, Xf, nid, y, err_y, multi_indices):
        self.Xf = Xf
        self.nid = nid
        self.y = y
        self.err_y = err_y
        self.multi_indices = tuple(tuple(m) for m in multi_indices)

    @property
    def num_obs(self) -> int:
        return self.y.shape[0]

    @property
    def num_dim(self) -> int:
        return self.Xf.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.y.dtype

    @property
    def device(self) -> torch.device:
        return self.y.device

    def __repr__(self):
        return (
            f"Dataset(M={self.num_obs}, D={self.num_dim}, "
            f"orders={self.multi_indices}, device={self.device})"
        )


class DatasetBuilder:
    """Accumulate observations host-side, then `build` a `Dataset`
    (reference ``GaussianProcess.add_data`` call pattern)."""

    def __init__(self, num_dim: int = 1):
        self.num_dim = int(num_dim)
        self._X: list = []
        self._mi: list = []
        self._y: list = []
        self._err: list = []

    def _norm_X(self, X) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        if X.ndim == 0:
            X = X.reshape(1, 1)
        elif X.ndim == 1:
            X = X.reshape(-1, 1) if self.num_dim == 1 else X.reshape(1, -1)
        if X.shape[1] != self.num_dim:
            raise ValueError(f"X has {X.shape[1]} dims, expected {self.num_dim}")
        return X

    def _norm_n(self, n, count: int) -> list:
        if n is None:
            n = 0
        arr = np.asarray(n)
        if arr.ndim == 0:
            return [normalize_multi_index(int(arr), self.num_dim)] * count
        if arr.ndim == 1:
            if self.num_dim == 1:
                if len(arr) != count:
                    raise ValueError("per-point n has wrong length")
                return [normalize_multi_index(int(v), 1) for v in arr]
            if len(arr) == self.num_dim:
                mi = normalize_multi_index([int(v) for v in arr], self.num_dim)
                return [mi] * count
            raise ValueError("ambiguous n for multi-dimensional input")
        if arr.ndim == 2:
            if arr.shape != (count, self.num_dim):
                raise ValueError("per-point multi-index n has wrong shape")
            return [
                normalize_multi_index([int(v) for v in row], self.num_dim)
                for row in arr
            ]
        raise ValueError("n must be scalar, 1-D, or 2-D")

    def add(self, X, y, err_y=0.0, n=0, T=None):
        """Append a batch: ``y[i]`` observes ``d^{n[i]} f(X[i])`` with noise
        standard deviation ``err_y[i]``."""
        if T is not None:
            raise NotImplementedError(
                "transformed observations (T) are ROADMAP Queue 1 item 10"
            )
        X = self._norm_X(X)
        q = X.shape[0]
        y = np.broadcast_to(np.asarray(y, dtype=np.float64), (q,)).copy()
        err = np.broadcast_to(np.asarray(err_y, dtype=np.float64), (q,)).copy()
        if np.any(err < 0):
            raise ValueError("err_y must be >= 0")
        self._X.append(X)
        self._mi.extend(self._norm_n(n, q))
        self._y.append(y)
        self._err.append(err)
        return self

    add_data = add

    @property
    def num_obs(self):
        return int(sum(len(y) for y in self._y))

    def build(self, dtype: torch.dtype, device) -> Dataset:
        if not self._X:
            raise ValueError("no observations added")
        multi_indices = tuple(sorted(set(self._mi)))
        mi_to_id = {m: i for i, m in enumerate(multi_indices)}
        nid = np.asarray([mi_to_id[m] for m in self._mi], dtype=np.int32)

        def t(a):
            return torch.as_tensor(a, dtype=dtype, device=device)

        return Dataset(
            t(np.concatenate(self._X, axis=0)),
            torch.as_tensor(nid, device=device),
            t(np.concatenate(self._y, axis=0)),
            t(np.concatenate(self._err, axis=0)),
            multi_indices,
        )
