"""Cascade warm-start training: block solves -> SV merge -> seeded global
solve (counterpart of dpsvm_tpu/solver/cascade.py).

The continuous-learning increment is "previous generation's support
vectors + fresh rows". The cascade (Graf et al.) partitions it into
blocks, solves each block warm-started from the seed rows that landed in
it, keeps the survivors (alpha > 0) and runs the final global solve
seeded from the merged survivors, so the expensive pass sees few non-SV
rows. The partition is a deterministic stride (``idx[i::k]``): seed rows
and both classes spread evenly, block sizes differ by at most one, no
RNG. Each block solve satisfies its own equality constraint, so the
merged seed does up to float64 round-off, which solver/warmstart.py
repair_seed absorbs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from dpsvm_tpu_torch.solver.warmstart import WarmStart

__all__ = ["cascade_partition", "cascade_solve"]


def cascade_partition(n: int, block_rows: int) -> list:
    """Deterministic strided partition of range(n) into
    ceil(n / block_rows) blocks whose sizes differ by at most one."""
    n = int(n)
    block_rows = int(block_rows)
    if n <= 0:
        raise ValueError("n must be positive")
    if block_rows <= 0:
        raise ValueError("block_rows must be positive")
    k = max(1, -(-n // block_rows))
    idx = np.arange(n)
    return [idx[i::k] for i in range(k)]


def cascade_solve(x, y, config, seed: Optional[WarmStart] = None,
                  block_rows: int = 4096, device=None, callback=None):
    """Two-level cascade solve of (x, y) on one device (`device`, None:
    the CUDA card): warm block solves, SV merge, warm-started final
    global solve. `seed` is a WarmStart over the FULL row set (e.g.
    seed_from_model of the previous generation at the head of x); each
    block gets the slice of it that its rows carry. n <= block_rows is
    one warm-started global solve.

    Returns (SolveResult over the full (x, y), stats): stats has
    ``blocks`` (rows / seed_nnz / iterations / sv each), ``merged_sv``,
    ``final_iterations``, ``total_iterations`` (blocks + final, the
    figure a cold solve's iterations compare with) and ``seed_rows``;
    the result's stats["cascade"] is the same dict."""
    from dpsvm_tpu_torch.solver.solve import solve

    x = np.asarray(x, np.float32)
    y = np.asarray(y)
    n = int(x.shape[0])
    if y.shape[0] != n:
        raise ValueError(f"y has {y.shape[0]} rows, x has {n}")
    seed_dense = seed.dense(n) if seed is not None else None
    stats = {"blocks": [], "seed_rows": 0 if seed_dense is None
             else int(np.count_nonzero(seed_dense))}

    if n <= int(block_rows):
        res = solve(x, y, config, device=device, callback=callback,
                    warm_start=seed)
        stats["merged_sv"] = int(np.count_nonzero(np.asarray(res.alpha)))
        stats["final_iterations"] = int(res.iterations)
        stats["total_iterations"] = int(res.iterations)
        res.stats["cascade"] = stats
        return res, stats

    merged = np.zeros(n, np.float64)
    total = 0
    for bidx in cascade_partition(n, block_rows):
        seed_b = None
        if seed_dense is not None and np.any(seed_dense[bidx] > 0):
            seed_b = WarmStart(alpha=seed_dense[bidx])
        res_b = solve(x[bidx], y[bidx], config, device=device,
                      warm_start=seed_b)
        a_b = np.asarray(res_b.alpha, np.float64)
        merged[bidx] = a_b
        total += int(res_b.iterations)
        stats["blocks"].append({
            "rows": int(bidx.size),
            "seed_nnz": 0 if seed_dense is None
            else int(np.count_nonzero(seed_dense[bidx])),
            "iterations": int(res_b.iterations),
            "sv": int(np.count_nonzero(a_b)),
        })
    stats["merged_sv"] = int(np.count_nonzero(merged))
    final_seed = WarmStart(alpha=merged) if stats["merged_sv"] else None
    res = solve(x, y, config, device=device, callback=callback,
                warm_start=final_seed)
    stats["final_iterations"] = int(res.iterations)
    stats["total_iterations"] = total + int(res.iterations)
    res.stats["cascade"] = stats
    return res, stats
