"""Seeds of the run's streams, derived from the run's own seed."""

from __future__ import annotations

import numpy as np


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one stream of the run, from the run's seed and a
    path of stream indices (any whole seed, large or negative)."""
    ss = np.random.SeedSequence([abs(int(seed)), int(seed < 0), *path])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))
