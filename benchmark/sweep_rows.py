"""How many rows mnist8m.block keeps: one job's time at several sizes.

    python3 benchmark/sweep_rows.py [--rows 1440000,1920000,2400000,2880000] \
        [--jobs 4]

On the CUDA card, for each row count: the cell's set-up at that count
(its pool of data sets and one warm-up), then --jobs jobs of train() in
turn over the pool, as the train-jobs mix runs them; and the
reference's gradient of the last job, timed. One JSON line a size, then
the card's name and power limit. The configuration keeps the largest
multiple of 60000 rows at which a job takes at most run_seconds / 8, so
a window holds eight whole jobs.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import run as bench_run  # noqa: E402
from benchmark.lib import cells  # noqa: E402
from benchmark.reference import svm as ref  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", default="1440000,1920000,2400000,2880000")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--seed", type=int, default=20261018)
    args = ap.parse_args()
    bench_run.cache_env(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("sweep_rows: no CUDA card", file=sys.stderr)
        return 3
    from dpsvm_tpu_torch.train import train

    base = cells.find_cell(ROOT, "mnist8m.block")
    for n in (int(v) for v in args.rows.split(",")):
        cell = copy.copy(base)
        cell.config = copy.deepcopy(base.config)
        cell.config["data"]["rows"] = n
        t0 = time.perf_counter()
        state = cell.driver.setup(cell, args.seed, "cuda")
        setup_s = time.perf_counter() - t0
        jobs = []
        for i in range(args.jobs):
            x, y = state["pool"][i % len(state["pool"])]
            t_a = time.perf_counter()
            model, res = train(x, y, state["cfg"])
            jobs.append({"wall_s": time.perf_counter() - t_a,
                         "train_s": res.train_seconds,
                         "pairs": res.iterations,
                         "rounds": res.stats["outer_rounds"],
                         "converged": res.converged, "n_sv": model.n_sv,
                         "gap": res.b_lo - res.b_hi})
        peak = torch.cuda.max_memory_allocated()
        t_r = time.perf_counter()
        f_ref, scale = ref.gradient(x, y, res.alpha, state["cfg"].gamma,
                                    torch.device("cuda"))
        ref_s = time.perf_counter() - t_r
        print(json.dumps({
            "rows": n, "setup_s": setup_s, "jobs": jobs, "peak_bytes": peak,
            "reference_s": ref_s,
            "kkt_gap_ref": ref.kkt_gap(f_ref, res.alpha, y,
                                       state["cfg"].c)}), flush=True)
        del state, x, y, model, res, f_ref, scale
        torch.cuda.empty_cache()
    print(bench_run.card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
