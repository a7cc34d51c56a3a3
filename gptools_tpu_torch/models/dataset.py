"""Observation container with derivative orders.

Counterpart of `gptools_tpu.models.dataset`. The builder stays numpy right up
to ``build(dtype, device)``, which places the finished `Dataset` on an
explicit device. Every observation is a linear functional of latent values
``f_q = d^{n_q} f(X_q)``: ``y = T f``, with ``T`` None when every
observation is direct (then M == Q) and otherwise the (M, Q) block-diagonal
matrix of the reference (identity blocks for batches added without ``T``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["Dataset", "DatasetBuilder", "resolve_device"]

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


def resolve_device(device) -> torch.device:
    """The device to build on; the card must be there when it is asked for
    (the configs and the wrapper build on the card by default)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: data are built on the card by default; pass "
            "device='cpu' for the CPU"
        )
    return dev


class Dataset:
    """Frozen observation set on one device.

    Attributes:
      Xf: (Q, D) latent evaluation points.
      nid: (Q,) int32 ids into ``multi_indices``.
      y: (M,) observed values.
      err_y: (M,) observation noise standard deviations.
      multi_indices: tuple of derivative multi-index tuples.
      T: (M, Q) observation matrix, or None (identity; then M == Q).
    """

    def __init__(self, Xf, nid, y, err_y, multi_indices, T=None):
        self.Xf = Xf
        self.nid = nid
        self.y = y
        self.err_y = err_y
        self.multi_indices = tuple(tuple(m) for m in multi_indices)
        self.T = T

    @property
    def num_obs(self) -> int:
        return self.y.shape[0]

    @property
    def num_latent(self) -> int:
        return self.Xf.shape[0]

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
            f"Dataset(M={self.num_obs}, Q={self.num_latent}, D={self.num_dim}, "
            f"orders={self.multi_indices}, transformed={self.T is not None}, "
            f"device={self.device})"
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
        self._T: list = []  # per batch: (Mb, Qb) or None

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
        standard deviation ``err_y[i]``. With ``T`` (M, Q), ``X`` holds the Q
        quadrature points and the batch observes ``y = T f(X)`` (M values),
        e.g. line integrals."""
        X = self._norm_X(X)
        q = X.shape[0]
        m = q
        if T is not None:
            T = np.asarray(T, dtype=np.float64)
            if T.ndim == 1:
                T = T.reshape(1, -1)
            if T.shape[1] != q:
                raise ValueError(f"T has {T.shape[1]} cols, X has {q} rows")
            m = T.shape[0]
        y = np.broadcast_to(np.asarray(y, dtype=np.float64), (m,)).copy()
        err = np.broadcast_to(np.asarray(err_y, dtype=np.float64), (m,)).copy()
        if np.any(err < 0):
            raise ValueError("err_y must be >= 0")
        mi = self._norm_n(n, q)
        self._X.append(X)
        self._mi.extend(mi)
        self._y.append(y)
        self._err.append(err)
        self._T.append(T)
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

        T = None
        if any(b is not None for b in self._T):
            sizes = [(x.shape[0] if b is None else b.shape[0], x.shape[0])
                     for x, b in zip(self._X, self._T)]
            T = np.zeros(tuple(map(sum, zip(*sizes))))
            row = col = 0
            for (mb, qb), b in zip(sizes, self._T):
                T[row : row + mb, col : col + qb] = np.eye(qb) if b is None else b
                row += mb
                col += qb
            T = t(T)
        return Dataset(
            t(np.concatenate(self._X, axis=0)),
            torch.as_tensor(nid, device=device),
            t(np.concatenate(self._y, axis=0)),
            t(np.concatenate(self._err, axis=0)),
            multi_indices,
            T=T,
        )
