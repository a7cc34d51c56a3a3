"""Live list views over component parameter metadata.

Counterpart of `gptools_tpu.utils.bounds` (the reference's
``CombinedBounds`` and ``MaskedBounds``): reading walks the underlying
component lists, and writing mutates them in place, so
``gp.free_param_bounds[3] = (0, 1)`` updates the owning kernel. The
densities never read these views: bounds become bijectors and hyperpriors
when the model is built, and those keep what they saw then.
"""

from __future__ import annotations

from typing import Sequence

__all__ = ["CombinedBounds", "MaskedBounds"]


class CombinedBounds:
    """Read/write view of the concatenation of several mutable sequences.

    ``CombinedBounds(a, b)[len(a)] is b[0]``, and assigning through the view
    assigns into the underlying sequence that owns the slot.
    """

    def __init__(self, *sequences: Sequence):
        self.sequences = list(sequences)

    def _locate(self, idx: int):
        n = len(self)
        if idx < 0:
            idx += n
        if not 0 <= idx < n:
            raise IndexError(f"index {idx} out of range for length {n}")
        for seq in self.sequences:
            if idx < len(seq):
                return seq, idx
            idx -= len(seq)
        raise AssertionError("unreachable")

    def __len__(self):
        return sum(len(s) for s in self.sequences)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return [self[i] for i in range(*idx.indices(len(self)))]
        seq, j = self._locate(idx)
        return seq[j]

    def __setitem__(self, idx, value):
        if isinstance(idx, slice):
            idxs = range(*idx.indices(len(self)))
            values = list(value)
            if len(idxs) != len(values):
                raise ValueError("slice assignment length mismatch")
            for i, v in zip(idxs, values):
                self[i] = v
            return
        seq, j = self._locate(idx)
        seq[j] = value

    def __iter__(self):
        for seq in self.sequences:
            yield from seq

    def __eq__(self, other):
        try:
            return list(self) == list(other)
        except TypeError:
            return NotImplemented

    def __repr__(self):
        return f"CombinedBounds({list(self)!r})"


class MaskedBounds:
    """Read/write view of a sequence at a fixed index subset (the reference
    used this to present only the *free* parameters' bounds/values/names out
    of the full per-component lists)."""

    def __init__(self, base: Sequence, indices: Sequence[int]):
        self.base = base
        self.indices = list(int(i) for i in indices)

    def _slot(self, idx: int) -> int:
        n = len(self.indices)
        if idx < 0:
            idx += n
        if not 0 <= idx < n:
            raise IndexError(f"index {idx} out of range for length {n}")
        return self.indices[idx]

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return [self[i] for i in range(*idx.indices(len(self)))]
        return self.base[self._slot(idx)]

    def __setitem__(self, idx, value):
        if isinstance(idx, slice):
            idxs = range(*idx.indices(len(self)))
            values = list(value)
            if len(idxs) != len(values):
                raise ValueError("slice assignment length mismatch")
            for i, v in zip(idxs, values):
                self[i] = v
            return
        self.base[self._slot(idx)] = value

    def __iter__(self):
        for i in self.indices:
            yield self.base[i]

    def __eq__(self, other):
        try:
            return list(self) == list(other)
        except TypeError:
            return NotImplemented

    def __repr__(self):
        return f"MaskedBounds({list(self)!r})"
