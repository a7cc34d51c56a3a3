"""Seeds of a run's streams, drawn from its ``--seed``."""

import numpy as np


def stream_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for the stream ``keys`` of run ``seed``."""
    ss = np.random.SeedSequence([abs(int(seed)), *[int(k) for k in keys]])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))
