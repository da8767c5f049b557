#!/usr/bin/env python3
"""Where a round's time goes on the card, read from the run's own trace.

    python3 tools/obs_idle_share.py [--rows 60000] [--perpair]

Trains the headline configuration (c=10, gamma=0.125, eps=0.01, q=256,
bfloat16 X, block engine) of chip_smoke.py on the 60000 x 784
MNIST-shaped data three ways, each with obs on and a trace directory
(dpsvm_tpu_torch/obs: a torch.profiler trace with CUDA activity, the
solver's spans as annotations): the in-core plain engine, the
out-of-core stream on one device and on Mesh([cuda:0] * 4) (8192-row
tiles). From each exported Chrome trace it takes the window the
solver's spans cover (solver/chunk, solver/ooc_round) and the device's
activity inside it (kernels, copies, memsets, their intervals merged),
and prints the device's busy and idle share of the window, the busy
time by kind and the five longest kernels by total time. One JSON line
a run, then the card's name and power limit. Needs a CUDA card.

--perpair runs the per-pair engines instead: engine="xla" (on the
resident Gram) and "pallas" on the same data and hyper-parameters, one
chunk of PAIR_DEPTH pairs each (a depth cut: the trace holds every
trip's ~100 launches), the window the solver/chunk span. Each line also
gives the trips queued and host reads, and the device's busy and the
window's us a trip. The trace slows the host, so the window's share is
the traced run's; the busy us a trip is the device's own.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

HEADLINE = dict(c=10.0, gamma=0.125, epsilon=0.01, max_iter=150_000,
                engine="block", working_set_size=256, dtype="bfloat16")
# --perpair: the pairs of the one traced chunk.
PAIR_DEPTH = 1024
DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "copy",
               "gpu_memset": "memset"}


def _merge(intervals):
    """The union of [start, end) intervals as a sorted disjoint list."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(a, b) -> float:
    """Total length of the intersection of two disjoint sorted lists."""
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if e > s:
            tot += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def analyze(trace_path: str, span: str) -> dict:
    """Busy and idle share of the device inside the windows of `span`
    (the host-side annotations of that name), from a Chrome trace."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    window = _merge((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("ph") == "X" and e.get("name") == span
                    and e.get("cat") == "user_annotation")
    if not window:
        raise RuntimeError(f"no {span} annotation in {trace_path}")
    wlen = sum(e - s for s, e in window)
    dev = [e for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if not dev:
        raise RuntimeError(f"no device activity in {trace_path}")
    busy = _overlap(_merge((e["ts"], e["ts"] + e["dur"]) for e in dev),
                    window)
    by_kind = defaultdict(float)
    by_kernel = defaultdict(float)
    for e in dev:
        if _overlap([[e["ts"], e["ts"] + e["dur"]]], window) > 0:
            by_kind[DEVICE_CATS[e["cat"]]] += e["dur"]
            if e["cat"] == "kernel":
                by_kernel[e["name"][:60]] += e["dur"]
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]
    return {"window_ms": round(wlen / 1e3, 4),
            "busy_ms": round(busy / 1e3, 4),
            "busy_share": round(busy / wlen, 4),
            "idle_share": round(1.0 - busy / wlen, 4),
            "by_kind_ms": {k: round(v / 1e3, 4) for k, v in by_kind.items()},
            "top_kernels_ms": {k: round(v / 1e3, 4) for k, v in top}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("obs_idle_share: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=60_000)
    ap.add_argument("--perpair", action="store_true")
    args = ap.parse_args()

    # The runs are the plain engine and the full stream: no device
    # profile resolves a None knob (a profile could turn on fused_round
    # or the shrunken stream).
    os.environ["DPSVM_AUTOTUNE_PROFILE"] = "off"
    from dpsvm_tpu_torch import Mesh, SVMConfig, train
    from dpsvm_tpu_torch.config import ObsConfig
    from dpsvm_tpu_torch.data.synth import make_mnist_like
    from dpsvm_tpu_torch.obs.runlog import read_runlog

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    x, y = make_mnist_like(n=args.rows, d=784, seed=7, noise=0.1)
    cfg = SVMConfig(**HEADLINE)
    work = tempfile.mkdtemp(prefix="obs_idle_")
    if args.perpair:
        pair = dict(max_iter=PAIR_DEPTH, chunk_iters=PAIR_DEPTH)
        runs = tuple((f"per-pair {eng}", dict(pair, engine=eng), {},
                      "solver/chunk") for eng in ("xla", "pallas"))
    else:
        ooc = dict(ooc=True, ooc_tile_rows=8192)
        runs = (("in-core plain", {}, {}, "solver/chunk"),
                ("ooc one device", ooc, {}, "solver/ooc_round"),
                ("ooc mesh 4 logical shards", ooc,
                 {"backend": "mesh",
                  "mesh": Mesh([torch.device("cuda:0")] * 4)},
                 "solver/ooc_round"))
    for kw in ([r[1] for r in runs] if args.perpair else [{}]):  # warm-up
        train(x[:16384], y[:16384], cfg.replace(**{**kw, "max_iter": 2048}))
    for label, kw, where, span in runs:
        obs = ObsConfig(enabled=True, runlog_dir=os.path.join(work, "runs"),
                        trace_dir=os.path.join(work, "trace"))
        t0 = time.perf_counter()
        _, res = train(x, y, cfg.replace(obs=obs, **kw), **where)
        wall = time.perf_counter() - t0
        final = read_runlog(res.stats["obs_runlog"])[-1]
        rec = {"run": label, "pairs": res.iterations,
               "train_seconds": round(res.train_seconds, 4),
               "wall_seconds": round(wall, 4),
               **analyze(final["trace_path"], span)}
        if args.perpair:
            trips = res.stats["trips_queued"]
            rec.update(trips_queued=trips,
                       host_reads=res.stats["host_reads"],
                       busy_us_a_trip=round(1e3 * rec["busy_ms"] / trips, 2),
                       window_us_a_trip=round(
                           1e3 * rec["window_ms"] / trips, 2))
        else:
            rec["rounds"] = res.stats["outer_rounds"]
        print(json.dumps(rec), flush=True)
        os.remove(final["trace_path"])
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
