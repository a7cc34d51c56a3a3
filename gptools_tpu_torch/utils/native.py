"""ctypes binding of the repo's native host diagnostics (``native/diagnostics.cpp``).

The port's own counterpart of `gptools_tpu.utils.native`: the same C
source, built at the first call with the host ``c++`` and the flags of
``native/Makefile`` into ``gptools_tpu_torch/_build/``, by a hash of the
source and the flags, and loaded with ctypes. Entry points:
``gpt_ess_batch``, ``gpt_split_rhat_batch`` and ``gpt_abi_version`` (2).
A failed build or a wrong ABI raises; nothing falls back here (the torch
path of `utils.diagnostics` is reached only by asking for it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["load", "build", "available", "ess_batch", "split_rhat_batch"]

_PKG = Path(__file__).resolve().parents[1]
_SOURCE = _PKG.parent / "native" / "diagnostics.cpp"
_BUILD_DIR = _PKG / "_build"
_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread", "-shared")
_ABI = 2
_LIB = None


def build() -> Path:
    """Compile the library if this source and flag hash has not been built;
    return its path. A failed build raises with the compiler's output."""
    h = hashlib.sha256(_SOURCE.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    so = _BUILD_DIR / f"libgt_native_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["c++", *_FLAGS, "-o", str(tmp), str(_SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"c++ failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def load() -> ctypes.CDLL:
    """The library, built and loaded at the first call, its entry points
    typed; a failed build raises."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        i64, dptr = ctypes.c_int64, ctypes.POINTER(ctypes.c_double)
        lib.gpt_ess_batch.argtypes = [dptr, i64, i64, i64, i64, dptr]
        lib.gpt_ess_batch.restype = None
        lib.gpt_split_rhat_batch.argtypes = [dptr, i64, i64, i64, dptr]
        lib.gpt_split_rhat_batch.restype = None
        lib.gpt_abi_version.restype = ctypes.c_int
        if lib.gpt_abi_version() != _ABI:
            raise RuntimeError(f"native diagnostics ABI {lib.gpt_abi_version()}, expected {_ABI}")
        _LIB = lib
    return _LIB


def available() -> bool:
    """True when the library builds (or is built) and loads."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def _chains(chains) -> np.ndarray:
    c = np.ascontiguousarray(np.asarray(chains, dtype=np.float64))
    if c.ndim == 2:
        c = c[None]
    if c.ndim != 3:
        raise ValueError("chains must be (num_chains, num_samples, dim)")
    return c


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def ess_batch(chains, max_pairs: int = 64) -> np.ndarray:
    """Per-parameter ESS of (C, S, D) chains. The library's Geyer scan runs
    lag by lag with a budget of ``max_pairs`` pairs; a parameter whose
    autocorrelation stays positive past it is recomputed by the FFT
    estimator (`diagnostics.ess`, float64 on the CPU), as the reference
    does, so the result is the same either way."""
    c = _chains(chains)
    m, n, d = c.shape
    out = np.empty((d,), np.float64)
    load().gpt_ess_batch(_ptr(c), m, n, d, max_pairs, _ptr(out))
    bad = ~np.isfinite(out)
    if bad.any():
        import torch

        from gptools_tpu_torch.utils.diagnostics import ess

        t = torch.from_numpy(c)
        out[bad] = [float(ess(t[:, :, k])) for k in np.flatnonzero(bad)]
    return out


def split_rhat_batch(chains) -> np.ndarray:
    """Per-parameter split-R-hat of (C, S, D) chains."""
    c = _chains(chains)
    m, n, d = c.shape
    out = np.empty((d,), np.float64)
    load().gpt_split_rhat_batch(_ptr(c), m, n, d, _ptr(out))
    return out
