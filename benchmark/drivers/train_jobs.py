"""Closed-loop training jobs: one caller trains a model, gets it back and
trains the next.

Each job is one call of ``dpsvm_tpu_torch.train.train(x, y, config)`` on
host numpy arrays. The jobs cycle through a pool of distinct data sets,
made on the card in set-up and brought to the host once, so no job
trains on the array the job before it used: the port's one-entry memos
of the last array miss, as they do for a user training a new model, and
every job pays its upload and norms.

The pool holds ``fixed_sets`` sets from the configuration's
``sample_seed``, the same for every run, and ``seeded_sets`` drawn from
the run's seed; the run's seed also draws the order in which the jobs
take them. How many rounds a solve needs depends on its data, so most
of the work is the same from seed to seed, while every seed's own set
is trained in the window and judged, so the checks meet new data in
every run.

The window runs jobs back to back from its start; the job in flight when
the seconds end is finished and counted, so the window holds whole jobs.
A traced run profiles whole jobs from the second one on until the slice
has lasted ``trace_slice_s``; the host-clock readings come from the
other jobs.
"""

from __future__ import annotations

import sys
import time
import traceback

import numpy as np

from benchmark.drivers.common import failed_check, generator, svm_config
from benchmark.lib.seeds import sub_seed
from benchmark.lib.trace import Slice, span
from benchmark.reference import svm as ref


def setup(cell, seed: int, device, svm_overrides=None) -> dict:
    import torch

    from dpsvm_tpu_torch.train import train

    conf, tr = cell.config, cell.traffic
    gen = generator(conf)
    data = conf["data"]
    n = int(data["rows"])
    n_fixed = int(tr["fixed_sets"])
    sets = ([gen.make_host(n, data, sub_seed(int(data["sample_seed"]),
                                             10 + k), device)
             for k in range(n_fixed)]
            + [gen.make_host(n, data, sub_seed(seed, 20 + k), device)
               for k in range(int(tr["seeded_sets"]))])
    order = np.random.default_rng(sub_seed(seed, 10)).permutation(len(sets))
    pool = [sets[k] for k in order]
    seeded = [i for i, k in enumerate(order) if k >= n_fixed]
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    cfg = svm_config(conf, svm_overrides)
    # Warm-up: a few rounds on the cell's own shapes (the kernel loads,
    # the library's handles, the allocator's blocks) on the pool's last
    # set, so that the window's first job meets a cold memo.
    x, y = pool[-1]
    train(x, y, cfg.replace(max_iter=int(tr["warmup_pairs"])),
          device=device)
    return {"cell": cell, "seed": seed, "device": device, "pool": pool,
            "seeded": seeded, "cfg": cfg, "n": n, "d": int(data["d"]),
            "kept": []}


def window(state: dict, seconds: float, trace: bool) -> dict:
    from dpsvm_tpu_torch.train import train

    pool, cfg, device = state["pool"], state["cfg"], state["device"]
    slice_s = float(state["cell"].traffic["trace_slice_s"])
    jobs, kept = [], state["kept"]
    sl, slice_done, summary = None, not trace, None
    t0 = time.perf_counter()
    close = t0 + seconds
    i = 0
    while True:
        if not slice_done and sl is None and i >= 1:
            sl = Slice().__enter__()
        k = i % len(pool)
        x, y = pool[k]
        t_a = time.perf_counter()
        try:
            with span("bench/train", sl is not None):
                model, res = train(x, y, cfg, device=device)
        except Exception:  # a job that raises is a failed job
            traceback.print_exc(file=sys.stderr)
            model = res = None
        t_b = time.perf_counter()
        rec = {"pool": k, "wall_s": t_b - t_a, "profiled": sl is not None,
               "ok": bool(res is not None and res.converged)}
        if res is not None:
            rec.update(train_s=float(res.train_seconds),
                       pairs=int(res.iterations),
                       rounds=int(res.stats["outer_rounds"]),
                       n_sv=int(model.n_sv))
            kept.append((len(jobs), model, res))
        jobs.append(rec)
        if sl is not None and (t_b - sl.t0 >= slice_s or t_b >= close):
            sl.__exit__(None, None, None)
            summary, sl, slice_done = sl.summary, None, True
        i += 1
        if t_b >= close:
            break
    t_end = t_b
    q = min(int(cfg.working_set_size), state["n"])
    return {"kind": "train", "window_s": t_end - t0, "t0": t0, "jobs": jobs,
            "n": state["n"], "d": state["d"], "q": q - q % 2,
            "slice": summary}


def check(state: dict, run: dict) -> list:
    """Judge a sample of the window's models: the first job on each set
    drawn from the run's seed, the job with the most rounds, and others
    drawn from the seed up to ``check_jobs``. For each, the gradient the
    solver carried against the reference's from the returned alphas
    (f_gap, relative to the size of its terms), the intercept against
    the reference's (b_gap, relative to the size of the terms of the
    two gradients that define it), the KKT gap of those alphas on the
    reference's gradient (kkt_gap), and the model's support vectors,
    alphas, labels and b against those the solution defines, and the
    alphas' box (model_diff, exact)."""
    import torch

    lim = state["cell"].limits
    names = ("f_gap", "b_gap", "kkt_gap", "model_diff")
    kept = state["kept"]
    if not kept:
        return [failed_check(nm, lim.get(nm, float("nan"))) for nm in names]
    rng = np.random.default_rng(sub_seed(state["seed"], 99))
    pools = [run["jobs"][job]["pool"] for job, _, _ in kept]
    take = [pools.index(k) for k in state["seeded"] if k in pools]
    take.append(max(range(len(kept)), key=lambda j: kept[j][2].stats[
        "outer_rounds"]))
    take = list(dict.fromkeys(take))
    rest = [j for j in range(len(kept)) if j not in take]
    take += list(rng.permutation(rest)[
        :max(0, int(state["cell"].traffic["check_jobs"]) - len(take))])
    c = float(state["cfg"].c)
    gamma = float(state["cfg"].gamma)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    worst = {nm: 0.0 for nm in names}
    for j in take:
        job, model, res = kept[j]
        x, y = state["pool"][run["jobs"][job]["pool"]]
        alpha = np.asarray(res.alpha, np.float32)
        f_ref, scale = ref.gradient(x, y, alpha, gamma, dev)
        f_gap = float(np.max(np.abs(np.asarray(res.stats["f"], np.float64)
                                    - f_ref) / scale))
        b_ref, b_size = ref.intercept(f_ref, scale, alpha, y, c)
        b_gap = abs(float(res.b) - b_ref) / b_size
        kkt = ref.kkt_gap(f_ref, alpha, y, c)
        sv_x, sv_a, sv_y = ref.model_of(x, y, alpha)
        diff = (int(sv_x.shape != model.sv_x.shape)
                or int(np.count_nonzero(sv_x != model.sv_x))
                + int(np.count_nonzero(sv_a != model.sv_alpha))
                + int(np.count_nonzero(sv_y != model.sv_y)))
        diff += int(model.b != res.b)
        diff += int(np.count_nonzero((alpha < 0) | (alpha > c)))
        for nm, v in zip(names, (f_gap, b_gap, kkt, float(diff))):
            worst[nm] = max(worst[nm], v)
    return [(nm, worst[nm], float(lim.get(nm, "nan"))) for nm in names]


def close(state: dict) -> None:
    """Nothing of the program outlives a job but its returned models."""
