#!/usr/bin/env python3
"""The per-pair mesh engine of one checkout of the port, timed.

    python3 tools/perpair_mesh_turns.py PACKAGE_DIR

Needs a CUDA card. PACKAGE_DIR holds a dpsvm_tpu_torch package (this
checkout: ".", or an earlier commit unpacked with git archive), which
this process imports. On Mesh([cuda:0] * 4), four logical shards of the
card, it solves the first 16384 rows of the headline's data
(make_mnist_like(60000, 784, seed 7, noise 0.1)) with c 10, gamma 0.125,
bfloat16 X and engine="xla", exactly 1024 pairs (budget_mode): (g)
without the row cache and (h) with 512 lines, each after a 64-pair
warm-up. It prints one line, COMPARE PACKAGE_DIR {...}: per run the
pairs, train_seconds, cache hits and host reads (null where the package
does not report them). Run it in turns (parent, change, change, parent)
in one call to compare two commits on one card.
"""

import json
import os
import sys

pkg = sys.argv[1]
sys.path.insert(0, os.path.abspath(pkg))
import torch  # noqa: E402

import dpsvm_tpu_torch as dt  # noqa: E402
from dpsvm_tpu_torch.data.synth import make_mnist_like  # noqa: E402

assert dt.__file__.startswith(os.path.abspath(pkg)), dt.__file__
x, y = make_mnist_like(n=60_000, d=784, seed=7, noise=0.1)
x, y = x[:16384], y[:16384]
cfg = dt.SVMConfig(c=10.0, gamma=0.125, epsilon=0.01, max_iter=1024,
                   engine="xla", dtype="bfloat16", budget_mode=True)
mesh = dt.Mesh([torch.device("cuda:0")] * 4)
out = {}
for label, kw in (("g", {}), ("h", dict(cache_lines=512))):
    dt.solve_mesh(x, y, cfg.replace(max_iter=64, **kw), mesh=mesh)
    r = dt.solve_mesh(x, y, cfg.replace(**kw), mesh=mesh)
    out[label] = dict(pairs=r.iterations, s=r.train_seconds,
                      hits=r.stats.get("cache_hits"),
                      reads=r.stats.get("host_reads"))
print("COMPARE", pkg, json.dumps(out), flush=True)
