"""The continuous-learning loop (counterpart of dpsvm_tpu/learn.py).

``cli learn`` ingests a row stream, retrains each increment FROM THE
PREVIOUS GENERATION'S SUPPORT VECTORS plus the fresh rows
(solver/cascade.py, one warm-started solve for increments at or under
``--block-rows``) and publishes every generation into a live serving
engine (serving/dispatch.py ServingEngine) by hot swap: ``register`` for
generation 0, ``swap`` after, and a probe ``submit`` / ``drain`` after
each publish, so a generation counts as published only once the engine
has served it.

The increment is ``concat(prev.sv_x, fresh_rows)`` seeded by
``seed_from_model(prev)``. Each generation's pairs are compared with a
cold solve of the same increment (``--cold-baseline``, forced by
``--smoke``) or with generation 0's pairs-per-row rate (an estimate,
flagged ``estimated``). With an engine, the counters
``learn.generations_total``, ``learn.pairs_total`` and
``learn.pairs_saved_total`` go on ``engine.metrics`` (its /metrics
exposition). The JAX package's run-log stream (the ``generation``
events and the ``learn`` column of ``obs report``) waits for ROADMAP
queue A item 11: the loop runs without it, and ``--obs`` is refused.

Solves run on `device` (None: the CUDA card; the tests pass "cpu").
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Iterator, Optional, Tuple

import numpy as np

__all__ = ["synthetic_stream", "file_stream", "train_generation",
           "run_learn", "run_cli"]


# ----------------------------------------------------------- streams

def synthetic_stream(seed: int, d: int, rows: int, generations: int,
                     drift: float) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """A drifting labelled row stream: the separating direction turns by
    `drift` radians a generation in the (0, 1) feature plane. Yields
    `generations` increments (x (rows, d) float32, y (rows,) +-1), the
    JAX package's draws from the same seed."""
    rng = np.random.default_rng(seed)
    for g in range(generations):
        theta = g * float(drift)
        w = np.zeros(d, np.float64)
        w[0], w[1 % d] = np.cos(theta), np.sin(theta)
        x = rng.normal(size=(rows, d)).astype(np.float32)
        margin = x.astype(np.float64) @ w + 0.35 * rng.normal(size=rows)
        y = np.where(margin > 0, 1, -1).astype(np.int32)
        yield x, y


def file_stream(path: str, increment_rows: int
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Replay an .npz with arrays ``x`` (n, d) and ``y`` (n,) in
    `increment_rows` chunks (the last partial one included); two label
    values, the larger one +1."""
    z = np.load(path, allow_pickle=False)
    if "x" not in z or "y" not in z:
        raise ValueError(f"{path}: stream npz needs arrays 'x' and 'y'")
    x = np.asarray(z["x"], np.float32)
    y = np.asarray(z["y"])
    if x.shape[0] != y.shape[0]:
        raise ValueError(f"{path}: x has {x.shape[0]} rows, y {y.shape[0]}")
    uniq = np.unique(y)
    if uniq.shape[0] != 2:
        raise ValueError(f"{path}: learn is binary-only ({uniq.shape[0]} "
                         "classes in y)")
    y_pm = np.where(y == uniq.max(), 1, -1).astype(np.int32)
    for s in range(0, x.shape[0], int(increment_rows)):
        yield x[s:s + increment_rows], y_pm[s:s + increment_rows]


# ----------------------------------------------------------- training

def train_generation(prev_model, x_fresh, y_fresh, config, kp,
                     block_rows: int = 4096, cold_baseline: bool = False,
                     cold_rate: Optional[float] = None, device=None):
    """One generation: a cold solve of the fresh rows for generation 0
    (`prev_model` None), else the warm cascade of concat(prev SVs,
    fresh). Returns (model, info): rows, seed_sv, pairs, pairs_cold
    (measured, or rate-estimated with ``estimated`` set), pairs_saved,
    sv, train_seconds."""
    from dpsvm_tpu_torch.models.svm_model import SVMModel
    from dpsvm_tpu_torch.solver.cascade import cascade_solve
    from dpsvm_tpu_torch.solver.solve import solve
    from dpsvm_tpu_torch.solver.warmstart import seed_from_model

    t0 = time.perf_counter()
    if prev_model is None:
        res = solve(x_fresh, y_fresh, config, device=device)
        model = SVMModel.from_dense(x_fresh, y_fresh, res.alpha, res.b, kp)
        return model, {"rows": int(x_fresh.shape[0]), "seed_sv": 0,
                       "pairs": int(res.iterations),
                       "pairs_cold": int(res.iterations), "pairs_saved": 0,
                       "estimated": False, "sv": int(model.sv_x.shape[0]),
                       "train_seconds": time.perf_counter() - t0}
    x_inc = np.concatenate([np.asarray(prev_model.sv_x, np.float32),
                            np.asarray(x_fresh, np.float32)])
    y_inc = np.concatenate([np.asarray(prev_model.sv_y, np.int32),
                            np.asarray(y_fresh, np.int32)])
    res, st = cascade_solve(x_inc, y_inc, config,
                            seed=seed_from_model(prev_model),
                            block_rows=block_rows, device=device)
    pairs = int(st["total_iterations"])
    warm_seconds = time.perf_counter() - t0
    if cold_baseline:
        cold = solve(x_inc, y_inc, config, device=device)
        pairs_cold, estimated = int(cold.iterations), False
    else:
        # An estimate from generation 0's pairs-per-row rate, flagged so
        # it never reads as a measurement.
        rate = cold_rate if cold_rate else 1.0
        pairs_cold, estimated = int(round(rate * x_inc.shape[0])), True
    model = SVMModel.from_dense(x_inc, y_inc, res.alpha, res.b, kp)
    return model, {"rows": int(x_inc.shape[0]),
                   "seed_sv": int(prev_model.sv_x.shape[0]),
                   "pairs": pairs, "pairs_cold": pairs_cold,
                   "pairs_saved": pairs_cold - pairs,
                   "estimated": estimated, "sv": int(model.sv_x.shape[0]),
                   "train_seconds": warm_seconds}


# ----------------------------------------------------------- the loop

def run_learn(stream, config, model_dir: str, kp, block_rows: int = 4096,
              cold_baseline: bool = False, engine=None,
              model_name: str = "learn", probe_rows: int = 8,
              on_generation=None, device=None) -> dict:
    """Drive the loop over `stream` (an iterator of (x, y) increments),
    writing generation g's model to ``model_dir/gen_gggg.npz``. With
    `engine` (a serving ServingEngine) each generation is published:
    ``register`` for generation 0, ``swap`` after, then a probe of the
    fresh rows' first `probe_rows` through ``submit`` / ``drain``
    (info["probe_verdict"]). Returns the loop summary."""
    os.makedirs(model_dir, exist_ok=True)
    model, cold_rate = None, None
    gens = []
    pairs_total = saved_total = 0
    for g, (x_fresh, y_fresh) in enumerate(stream):
        if x_fresh.shape[0] == 0:
            continue
        model, info = train_generation(
            model, x_fresh, y_fresh, config, kp, block_rows=block_rows,
            cold_baseline=cold_baseline, cold_rate=cold_rate, device=device)
        if g == 0:
            cold_rate = info["pairs"] / max(1, info["rows"])
        path = os.path.join(model_dir, f"gen_{g:04d}.npz")
        model.save(path)
        info["gen"] = g
        info["path"] = path
        pairs_total += info["pairs"]
        saved_total += max(0, info["pairs_saved"]) if g else 0
        if engine is not None:
            if g == 0:
                engine.register(model_name, path)
            else:
                engine.swap(model_name, path)
            # Published means served: a decision row back from the
            # freshly swapped model, not just a registry pointer flip.
            t = engine.submit(np.asarray(x_fresh[:probe_rows], np.float32),
                              model=model_name)
            out = engine.drain().get(t)
            info["probe_verdict"] = out.verdict if out else "lost"
            engine.metrics.counter("learn.generations_total").add(1)
            engine.metrics.counter("learn.pairs_total").add(info["pairs"])
            engine.metrics.counter("learn.pairs_saved_total").add(
                max(0, info["pairs_saved"]))
        gens.append(info)
        if on_generation is not None:
            on_generation(g, model, info)
    return {"generations": len(gens), "pairs_total": pairs_total,
            "pairs_saved_total": saved_total, "gens": gens,
            "model_dir": model_dir}


# ----------------------------------------------------------- CLI

def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dpsvm_tpu_torch learn",
        description="continuous-learning loop: warm-start retraining "
                    "from the previous generation's support vectors, "
                    "published into a live serving engine")
    src = p.add_argument_group("stream")
    src.add_argument("--stream", default=None,
                     help=".npz with arrays x, y to replay as the row "
                          "stream (default: synthetic drifting stream)")
    src.add_argument("--increment-rows", type=int, default=512,
                     help="rows per increment when replaying --stream")
    src.add_argument("--generations", type=int, default=4)
    src.add_argument("--rows", type=int, default=512,
                     help="fresh rows per synthetic generation")
    src.add_argument("--d", type=int, default=16)
    src.add_argument("--drift", type=float, default=0.1,
                     help="radians the synthetic decision boundary "
                          "turns per generation")
    src.add_argument("--seed", type=int, default=0)
    slv = p.add_argument_group("solver")
    slv.add_argument("--c", type=float, default=1.0)
    slv.add_argument("--gamma", type=float, default=None,
                     help="RBF gamma (default: 1/d)")
    slv.add_argument("--kernel", default="rbf")
    slv.add_argument("--tol", type=float, default=1e-3)
    slv.add_argument("--max-iter", type=int, default=200_000)
    slv.add_argument("--block-rows", type=int, default=4096,
                     help="cascade block size; increments at or under "
                          "it run as one warm solve")
    slv.add_argument("--cold-baseline", action="store_true",
                     help="also cold-solve each increment to MEASURE "
                          "pairs saved (default: estimate from the "
                          "gen-0 rate)")
    out = p.add_argument_group("publish")
    out.add_argument("--model-dir", default=None,
                     help="directory for per-generation model .npz "
                          "(default: ./learn_models)")
    out.add_argument("--serve", action="store_true",
                     help="publish generations into an in-process "
                          "serving engine by hot swap")
    out.add_argument("--metrics-port", type=int, default=None,
                     help="with --serve: OpenMetrics endpoint port "
                          "(0 = ephemeral)")
    out.add_argument("--json", action="store_true",
                     help="print the loop summary as JSON")
    p.add_argument("--obs", action="store_true",
                   help="the run-log stream (not ported: ROADMAP queue A "
                        "item 11)")
    p.add_argument("--device", default=None,
                   help="torch device of the solves and the engine "
                        "(default: the CUDA card; 'cpu' for the plain "
                        "path)")
    p.add_argument("--smoke", action="store_true",
                   help="CI shape: tiny drifting stream, two "
                        "generations, in-process engine; checks pairs "
                        "saved > 0 and that the post-swap probe serves")
    return p


def run_cli(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    from dpsvm_tpu_torch.config import ServeConfig, SVMConfig
    from dpsvm_tpu_torch.ops.kernels import KernelParams

    if args.obs:
        print("error: --obs (the learn run-log stream) is not ported "
              "(ROADMAP queue A item 11)", file=sys.stderr)
        return 2
    if args.smoke:
        args.generations, args.rows, args.d = 2, 240, 6
        args.drift = max(args.drift, 0.1)
        args.cold_baseline = True
        args.serve = True
    gamma = args.gamma if args.gamma is not None else 1.0 / args.d
    cfg = SVMConfig(c=args.c, kernel=args.kernel, gamma=gamma,
                    epsilon=args.tol, max_iter=args.max_iter)
    kp = KernelParams(cfg.kernel, gamma, cfg.degree, cfg.coef0)
    if args.stream:
        stream = file_stream(args.stream, args.increment_rows)
    else:
        stream = synthetic_stream(args.seed, args.d, args.rows,
                                  args.generations, args.drift)
    model_dir = args.model_dir or os.path.join(os.getcwd(), "learn_models")

    engine = None
    if args.serve:
        from dpsvm_tpu_torch.serving import ServingEngine

        engine = ServingEngine(ServeConfig(
            buckets=(64,), metrics_port=args.metrics_port),
            device=args.device)
    try:
        summary = run_learn(stream, cfg, model_dir, kp,
                            block_rows=args.block_rows,
                            cold_baseline=args.cold_baseline,
                            engine=engine, device=args.device)
    finally:
        if engine is not None:
            engine.close()

    for info in summary["gens"]:
        tag = "" if not info["estimated"] else " (est)"
        probe = (f" probe={info['probe_verdict']}"
                 if "probe_verdict" in info else "")
        print(f"gen {info['gen']}: rows={info['rows']} "
              f"seed_sv={info['seed_sv']} sv={info['sv']} "
              f"pairs={info['pairs']} cold={info['pairs_cold']}{tag} "
              f"saved={info['pairs_saved']}{probe}")
    print(f"learn: {summary['generations']} generations, "
          f"{summary['pairs_total']} pairs, "
          f"{summary['pairs_saved_total']} saved vs cold")
    if args.json:
        print(json.dumps(summary, default=str))
    if args.smoke:
        warm_gens = [i for i in summary["gens"] if i["gen"] > 0]
        saved = sum(i["pairs_saved"] for i in warm_gens)
        verdicts = [i.get("probe_verdict") for i in warm_gens]
        if not warm_gens or saved <= 0 or any(v != "ok" for v in verdicts):
            print(f"learn smoke FAIL: {len(warm_gens)} warm generation(s), "
                  f"{saved} pairs saved, post-swap probes {verdicts}",
                  file=sys.stderr)
            return 1
        print("learn smoke PASS: warm start saved "
              f"{saved} pairs across {len(warm_gens)} warm generation(s), "
              "post-swap probes ok")
    return 0


if __name__ == "__main__":
    sys.exit(run_cli())
