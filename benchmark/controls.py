"""The readings the output checks' limits are set from: the program's
over many seeds, and the control's.

    python3 benchmark/controls.py --workload <name> --seeds 1,2,3 \
        --mode program|control [--seconds 2]

For each seed, in one process on the CUDA card: the cell's set-up and a
short window at the cell's own sizes and load, then the cell's checks;
one JSON line a seed with every number compared, and a last line with
the largest reading of each over the seeds. --mode control puts the
nearest lower precision in the program's place: TF32 products for a
configuration that states float32 with TF32 off, through the program's
own TF32 path (SVMConfig matmul_precision "high"). The benchmark's runs
never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import run as bench_run  # noqa: E402
from benchmark.lib import cells  # noqa: E402

TF32 = {"matmul_precision": "high"}


def readings(cell, seed: int, seconds: float, mode: str, device) -> dict:
    """One seed's checks as {name: value}."""
    import torch

    drv = cell.driver
    state = drv.setup(cell, seed, device,
                      TF32 if mode == "control" else None)
    run = drv.window(state, seconds, False)
    drv.close(state)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    checks = drv.check(state, run)
    state.clear()
    out = {nm: v for nm, v, _ in checks}
    out["failed"] = bench_run.run_failed(run)
    out["attempted"] = bench_run.run_attempted(run)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", choices=("program", "control"),
                    default="program")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()
    bench_run.cache_env(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("controls: no CUDA card", file=sys.stderr)
        return 3
    cell = cells.find_cell(ROOT, args.workload)
    worst = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = readings(cell, seed, args.seconds, args.mode, "cuda")
        print(json.dumps({"seed": seed, "mode": args.mode, **r,
                          "wall_s": time.perf_counter() - t0}), flush=True)
        for k, v in r.items():
            worst[k] = max(worst.get(k, v), v)
    print(json.dumps({"workload": args.workload, "mode": args.mode,
                      "max": worst, "card": bench_run.card()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
