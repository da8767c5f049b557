"""Common result record returned by the solver (counterpart of
dpsvm_tpu/solver/result.py)."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SolveResult:
    alpha: np.ndarray  # (n,) final dual variables
    b: float  # intercept = (b_lo + b_hi) / 2
    b_hi: float
    b_lo: float
    iterations: int  # pair updates executed
    converged: bool
    train_seconds: float = 0.0
    stats: dict = dataclasses.field(default_factory=dict)
    # Host reads of the fleet's stop test (solver/fleet.py), shared by
    # every member of one fleet; 0 where the solver does not count them.
    dispatches: int = 0

    @property
    def n_sv(self) -> int:
        return int(np.count_nonzero(np.asarray(self.alpha) > 0))
