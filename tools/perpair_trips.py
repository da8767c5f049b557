#!/usr/bin/env python3
"""How many trips the per-pair runners should queue between host reads.

    python3 tools/perpair_trips.py [--trips 1,8,32,256] [--passes 2]

Needs a CUDA card and nvcc. The per-pair loop (dpsvm_tpu_torch/solver/
smo.py queue_trips) queues smo.TRIPS trips, then reads the pair count and
the stop flag once. A trip queued after the stop is masked and changes
nothing, but the host still enqueues it; a read waits for the device.
This tool solves, for each value of smo.TRIPS in --trips, the per-pair
solves of chip_smoke.py with the same data and configurations:

  headline xla / pallas  60000 x 784 (make_mnist_like, seed 7), c 10,
                         gamma 0.125, eps 0.01, bfloat16 X ([perpair]);
  reconstruct xla        the covtype stress configuration's per-pair leg
                         on 1000 rows ([reconstruct]);
  ovr / ovo twins        the sequential engine="xla" twins of the
                         10-class fleets on rows 0-49999 ([multiclass]).

The headline and reconstruct solves run --passes times, the values of
--trips in turns (forward, then backward, ...); the twins once (they take
most of the time). Each solve prints one JSON line: its train_seconds
(for the twins their sum, and the wall), pairs, trips queued, the
runners' host reads and masked trips (trips queued less the pairs).
Every solve with one configuration must give the same pairs and b at
every TRIPS (a masked trip changes nothing); the tool fails otherwise.
Then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (HEADLINE, MC_RUN, MC_TRAIN,  # noqa: E402
                        RECON_LEGS, RECON_RUN)


def _record(label: str, trips: int, results, wall: float,
            tally: dict) -> dict:
    """One solve's (or one set of twins') line; `tally` the trips queued
    and the runners' reads (each a pair a trip, so the masked trips are
    the trips less the pairs)."""
    pairs = sum(r.iterations for r in results)
    return {"solve": label, "trips": trips,
            "train_seconds": round(sum(r.train_seconds for r in results), 4),
            "wall_seconds": round(wall, 4), "solves": len(results),
            "pairs": pairs, "trips_queued": tally["trips"],
            "masked_trips": tally["trips"] - pairs,
            "batch_reads": tally["reads"], "b": [r.b for r in results][:3]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("perpair_trips: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--trips", default="1,8,32,256")
    ap.add_argument("--passes", type=int, default=2)
    args = ap.parse_args()
    values = [int(v) for v in args.trips.split(",")]

    os.environ["DPSVM_AUTOTUNE_PROFILE"] = "off"
    from dpsvm_tpu_torch import SVMConfig, solve, train
    from dpsvm_tpu_torch.data.synth import (make_covtype_like,
                                            make_mnist_like,
                                            make_mnist_multiclass)
    from dpsvm_tpu_torch.models.multiclass import train_multiclass
    from dpsvm_tpu_torch.solver import smo

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    x, y = make_mnist_like(n=60_000, d=784, seed=7, noise=0.1)
    head = SVMConfig(**HEADLINE)
    (_, recon_rows, recon_kw), = [leg for leg in RECON_LEGS
                                  if leg[0] == "xla"]
    xr, yr = make_covtype_like(recon_rows, seed=0)
    recon = SVMConfig(**RECON_RUN, **recon_kw)
    for eng in ("xla", "pallas"):  # warm-up: builds, CUDA set-up
        train(x[:16384], y[:16384], head.replace(engine=eng, max_iter=300))

    solves = {
        "headline xla": lambda: [solve(x, y, head.replace(engine="xla"))],
        "headline pallas": lambda: [solve(x, y,
                                          head.replace(engine="pallas"))],
        "reconstruct xla": lambda: [solve(xr, yr, recon)],
    }
    seen = {}
    # The runners' trips and reads, every leg and submodel included.
    totals = {}
    queue = smo.queue_trips

    def counted(*args, tally=None, **kwargs):
        mine = {}
        out = queue(*args, tally=mine, **kwargs)
        for k, v in mine.items():
            for into in (tally, totals):
                if into is not None:
                    into[k] = into.get(k, 0) + v
        return out

    def run(label, fn, trips):
        smo.TRIPS = trips
        totals.clear()
        totals.update(trips=0, reads=0)
        t0 = time.perf_counter()
        results = fn()
        wall = time.perf_counter() - t0
        rec = _record(label, trips, results, wall, totals)
        print(json.dumps(rec), flush=True)
        key = (label, rec["pairs"], tuple(r.b for r in results))
        if seen.setdefault(label, key) != key:
            raise AssertionError(f"{label}: TRIPS {trips} moved the result")

    keep = smo.TRIPS
    smo.queue_trips = counted
    try:
        for p in range(args.passes):
            for trips in (values if p % 2 == 0 else values[::-1]):
                for label, fn in solves.items():
                    run(label, fn, trips)
        xm, ym = make_mnist_multiclass(n=60_000, d=784, seed=7, noise=0.1)
        xm, ym = xm[:MC_TRAIN], ym[:MC_TRAIN]
        mc = SVMConfig(**MC_RUN, fleet_size=16)
        for strategy in ("ovr", "ovo"):
            for trips in values:
                run(f"{strategy} twins", lambda: train_multiclass(
                    xm, ym, mc, strategy=strategy, use_fleet=False)[1],
                    trips)
    finally:
        smo.TRIPS, smo.queue_trips = keep, queue
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
