#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (dpsvm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero and no
result line is printed:

  1. device  -- the card's name and power limit (nvidia-smi); no CUDA
                device is a failure;
  2. build   -- every kernel of the main path built from csrc/ with nvcc;
  3. headline -- the block-engine headline configuration (c=10,
                gamma=0.125, eps=0.01, q=256, bfloat16 X) on the 60000 x
                784 MNIST-shaped data, trained through dpsvm_tpu_torch.train
                with every launch count set to 0 just before: it must
                converge, and the kernel launch count must equal the outer
                rounds (every round dispatches the subproblem);
  4. kernels -- each kernel held against its plain PyTorch version on the
                card, on working sets that select_block picks from the
                same data at the start point and at the headline's end
                state (q = 128 and 256, both selection rules): same pair
                count, alpha within rtol 1e-6 / atol 1e-7; times of
                kernel and plain version; then the headline solved once
                more with the round loop's four stage functions timed
                by CUDA events;
  5. oracle  -- float32 at eps=5e-4 against the committed LibSVM oracle
                (artifacts/oracle60k.{json,npz}): converged, SV count
                within 3% of the oracle's, decision-sign agreement
                >= 99.8%; the model saved as .txt and .npz and reloaded
                decides the same.

The second-to-last lines are the per-kernel JSON record and the card's
name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores

HEADLINE = dict(c=10.0, gamma=0.125, epsilon=0.01, max_iter=150_000,
                engine="block", working_set_size=256, dtype="bfloat16")
ORACLE_RUN = dict(c=10.0, gamma=0.125, epsilon=5e-4, max_iter=2_000_000,
                  engine="block", working_set_size=256)
SV_TOL = 0.03
SIGN_TOL = 0.998
RTOL, ATOL = 1e-6, 1e-7


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over `reps` calls after one warm-up,
    between CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def subproblem_inputs(x_dev, y_dev, x_sq, k_diag, alpha, f, c, q, kp):
    """A real working set of the data: select_block's W at (alpha, f),
    with its gathered Gram block and per-slot state."""
    from dpsvm_tpu_torch.solver.block import gather_block, select_block

    w, ok, _, _ = select_block(f, alpha, y_dev, c, q)
    _, _, kb, kd, a0, yw, f0 = gather_block(x_dev, y_dev, x_sq, k_diag, f,
                                            alpha, w, kp)
    return kb, a0, yw, f0, kd, ok.float()


def phase_kernels(dev, x_dev, y_dev, x_sq, k_diag, states, kp, c, tau,
                  reps: int) -> dict:
    """Kernel B1 against its plain version on real working sets. Returns
    the JSON record's measured fields (timed at q=256, limit=512)."""
    import torch

    from dpsvm_tpu_torch.ops.subproblem import (_solve_subproblem,
                                                solve_subproblem)

    worst = 0.0
    rec = {}
    for sname, (alpha, f, eps) in states.items():
        for q, limit in ((128, 256), (128, 512), (256, 512)):
            for rule in ("mvp", "second_order"):
                kb, a0, yw, f0, kd, ok = subproblem_inputs(
                    x_dev, y_dev, x_sq, k_diag, alpha, f, c, q, kp)
                lim = torch.tensor(limit, dtype=torch.int32, device=dev)
                a_k, t_k = solve_subproblem(kb, a0, yw, f0, kd, ok, lim, c,
                                            eps, tau, rule=rule)
                rows = set()
                a_p, _, t_p = _solve_subproblem(kb, kd, ok > 0, a0, yw, f0,
                                                c, eps, tau, limit, rule,
                                                rows_read=rows)
                t_k, t_p = int(t_k), int(t_p)
                err = float((a_k - a_p).abs().max())
                worst = max(worst, err)
                if t_k != t_p:
                    raise AssertionError(
                        f"{sname} q={q} {rule}: kernel ran {t_k} pairs, "
                        f"plain {t_p}")
                np.testing.assert_allclose(a_k.cpu().numpy(),
                                           a_p.cpu().numpy(),
                                           rtol=RTOL, atol=ATOL)
                ms = time_ms(functools.partial(
                    solve_subproblem, kb, a0, yw, f0, kd, ok, lim, c, eps,
                    tau, rule=rule), reps)
                plain_ms = time_ms(functools.partial(
                    _solve_subproblem, kb, kd, ok > 0, a0, yw, f0, c, eps,
                    tau, limit, rule), 1)
                # Least time for the same work: each distinct Gram row the
                # solve reads (once; the kernel re-reads them from L2),
                # five vectors in and alpha out, over the device memory
                # rate; against ~12 q float32 flops per trip over the
                # float32 rate. The kernel itself is held back by neither:
                # its trips form a serial chain of dependent reductions.
                nbytes = 4 * (len(rows) * q + 6 * q)
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                ops_ms = 12 * q * t_k / F32_FLOPS * 1e3
                bound_ms = max(bytes_ms, ops_ms)
                bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
                print(f"[kernels] subproblem {sname} q={q} limit={limit} "
                      f"{rule}: pairs={t_k} rows_read={len(rows)} "
                      f"max_abs_err={err:.3g} ms={ms:.4f} "
                      f"plain_ms={plain_ms:.3f} bound_ms={bound_ms:.6f} "
                      f"({bound_by}) us_per_pair="
                      f"{1e3 * ms / max(t_k, 1):.3f}", flush=True)
                if (sname, q, limit, rule) == ("start", 256, 512, "mvp"):
                    rec = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by, serial_trips=t_k)
    rec["max_abs_err"] = worst
    return rec


STAGES = ("select_block", "gather_block", "dispatch_subproblem",
          "fold_block")


def phase_stages(x, y, cfg) -> None:
    """The headline solve once more through dpsvm_tpu_torch.train, with
    the four stage functions its round loop calls (solver/block.py
    select_block, gather_block, dispatch_subproblem, fold_block) wrapped
    in CUDA events. Prints each stage's device time per round and the
    stages' share of train_seconds; the rest is the round's own small
    ops, host work and the once-per-round gap read."""
    import torch

    from dpsvm_tpu_torch import train
    from dpsvm_tpu_torch.solver import block

    events = {name: [] for name in STAGES}
    originals = {name: getattr(block, name) for name in STAGES}

    def timed(name, fn):
        def run(*args, **kwargs):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args, **kwargs)
            e1.record()
            events[name].append((e0, e1))
            return out
        return run

    for name, fn in originals.items():
        setattr(block, name, timed(name, fn))
    try:
        _, res = train(x, y, cfg)
    finally:
        for name, fn in originals.items():
            setattr(block, name, fn)
    torch.cuda.synchronize()
    rounds = res.stats["outer_rounds"]
    if not res.converged or any(len(e) != rounds for e in events.values()):
        raise AssertionError("stage-timed headline solve did not run every "
                             "stage once per round to convergence")
    ms = {name: sum(e0.elapsed_time(e1) for e0, e1 in evs)
          for name, evs in events.items()}
    total = sum(ms.values())
    print(f"[stages] headline: rounds={rounds} pairs={res.iterations} "
          f"train_seconds={res.train_seconds:.4f} "
          f"stage_share_of_train={100 * total / (1e3 * res.train_seconds):.1f}%"
          " | " + " ".join(
              f"{k}={v / rounds:.4f}ms({100 * v / total:.1f}%)"
              for k, v in ms.items()), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from dpsvm_tpu_torch import SVMConfig, SVMModel, decision_function, train
    from dpsvm_tpu_torch.data.synth import make_mnist_like
    from dpsvm_tpu_torch.device import resolve_device
    from dpsvm_tpu_torch.ops import _build
    from dpsvm_tpu_torch.ops.kernels import (KernelParams, kernel_diag,
                                             squared_norms)
    from dpsvm_tpu_torch.ops.subproblem import solve_subproblem
    from dpsvm_tpu_torch.solver.smo import init_state

    # ---- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = resolve_device(None)
    print(f"[device] {torch.cuda.get_device_name(0)} | {smi} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    # ---- 2. build
    t0 = time.perf_counter()
    reports = _build.build(["subproblem"])
    print(f"[build] subproblem in {time.perf_counter() - t0:.2f}s", flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    # ---- data
    t0 = time.perf_counter()
    x, y = make_mnist_like(n=60_000, d=784, seed=7, noise=0.1)
    print(f"[data] 60000 x 784 in {time.perf_counter() - t0:.2f}s", flush=True)
    cfg = SVMConfig(**HEADLINE)
    kp = KernelParams("rbf", cfg.gamma)
    c = cfg.c_bounds()
    tau = float(cfg.tau)
    x_dev = torch.as_tensor(x, device=dev).to(torch.bfloat16)
    y_dev = torch.as_tensor(y.astype(np.float32), device=dev)
    x_sq = squared_norms(x_dev)
    k_diag = kernel_diag(x_sq, kp)
    alpha0, f0, _, _ = init_state(y_dev)

    # ---- 3. headline solve (its end state feeds phase 4), after a short
    # warm-up solve so train_seconds leaves out one-time CUDA set-up.
    t0 = time.perf_counter()
    train(x[:4096], y[:4096], cfg.replace(max_iter=2048))
    print(f"[headline] warm-up solve on 4096 rows in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    solve_subproblem.launches = 0
    model, res = train(x, y, cfg)
    launches = solve_subproblem.launches
    rounds = res.stats["outer_rounds"]
    print(f"[headline] converged={res.converged} pairs={res.iterations} "
          f"outer_rounds={rounds} launches={launches} "
          f"train_seconds={res.train_seconds:.4f} n_sv={res.n_sv} "
          f"b={res.b:.6f}", flush=True)
    if not res.converged:
        raise AssertionError("headline solve did not converge")
    if launches != rounds or launches == 0:
        raise AssertionError(
            f"subproblem kernel launched {launches} times over {rounds} "
            "rounds: the main path did not run through it")
    f_end = torch.as_tensor(res.stats["f"], device=dev)
    a_end = torch.as_tensor(res.alpha, device=dev)
    # ---- 4. kernels against their plain versions
    states = {"start": (alpha0, f0, cfg.epsilon),
              "converged@eps1e-3": (a_end, f_end, 1e-3)}
    rec = phase_kernels(dev, x_dev, y_dev, x_sq, k_diag, states, kp, c,
                        tau, reps=20)
    phase_stages(x, y, cfg)

    # ---- 5. oracle
    with open(os.path.join(ROOT, "artifacts", "oracle60k.json")) as fh:
        oracle = json.load(fh)
    with np.load(os.path.join(ROOT, "artifacts", "oracle60k.npz")) as z:
        sk_dec = np.asarray(z["dec"])
    model, res = train(x, y, SVMConfig(**ORACLE_RUN))
    dec = decision_function(model, x)
    sv_dev = abs(res.n_sv - oracle["n_sv"]) / oracle["n_sv"]
    agree = float(np.mean(np.sign(dec) == np.sign(sk_dec)))
    print(f"[oracle] converged={res.converged} pairs={res.iterations} "
          f"outer_rounds={res.stats['outer_rounds']} "
          f"train_seconds={res.train_seconds:.4f} n_sv={res.n_sv} "
          f"(oracle {oracle['n_sv']}, dev {100 * sv_dev:.2f}%) "
          f"sign_agree={100 * agree:.3f}%", flush=True)
    if not res.converged:
        raise AssertionError("oracle-contract solve did not converge")
    if sv_dev > SV_TOL:
        raise AssertionError(f"n_sv {res.n_sv} is {100 * sv_dev:.2f}% off "
                             f"the oracle's {oracle['n_sv']}")
    if agree < SIGN_TOL:
        raise AssertionError(f"decision sign agreement {agree:.4f} < "
                             f"{SIGN_TOL}")
    out_dir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    for ext in ("txt", "npz"):
        path = os.path.join(out_dir, f"model60k.{ext}")
        model.save(path)
        diff = float(np.max(np.abs(
            decision_function(SVMModel.load(path), x) - dec)))
        print(f"[oracle] reloaded .{ext}: max |dec diff| = {diff:.3g}",
              flush=True)
        if diff > 1e-6:
            raise AssertionError(f".{ext} round trip changed decisions")

    kernels = [{
        "name": "solve_subproblem",
        "route": "cuda",
        "source": "dpsvm_tpu_torch/csrc/subproblem.cu",
        "replaces": "dpsvm_tpu/ops/pallas_subproblem.py:253",
        "launches": launches,
        "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"],
        "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"],
        "serial_trips": rec["serial_trips"],
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
