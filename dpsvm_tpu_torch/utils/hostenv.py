"""The environment of a child Python process that runs the port
(counterpart of dpsvm_tpu/utils/hostenv.py, which makes a child come up
as a virtual multi-device JAX CPU platform).

The port's children need two things from their environment: the repo
root first on ``PYTHONPATH`` (so ``-m dpsvm_tpu_torch...`` imports this
checkout, whatever is installed), and one pinned torch / OpenMP thread
count: two processes that must compute the same bits on the CPU (the
multi-process job's bitwise twins) must reduce in the same grouping,
which torch's intra-op thread count decides. Shared here so the rule
lives in one place (parallel/multihost_check.py, chip_smoke.py
[multiproc], tests/test_torch_multiproc.py)."""

from __future__ import annotations

import os
from typing import Optional


def child_env(root: str, threads: Optional[int] = 1,
              base: Optional[dict] = None) -> dict:
    """A copy of `base` (default os.environ) with `root` first on
    PYTHONPATH and, unless `threads` is None, OMP_NUM_THREADS (which
    torch reads for its intra-op thread count at start) set to
    `threads`."""
    env = dict(os.environ if base is None else base)
    rest = [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
            if p and os.path.abspath(p) != os.path.abspath(root)]
    env["PYTHONPATH"] = os.pathsep.join([root] + rest)
    if threads is not None:
        if int(threads) < 1:
            raise ValueError(f"threads must be >= 1, got {threads}")
        env["OMP_NUM_THREADS"] = str(int(threads))
    return env
