"""Exact float64 gradient reconstruction legs (config.reconstruct_every;
counterpart of dpsvm_tpu/solver/reconstruct.py).

At extreme C the solver's float32 incremental gradient drifts until the
carried stopping rule b_lo <= b_hi + 2 eps cannot be trusted. This module
runs the device solve in LEGS of at most ``config.reconstruct_every``
pair updates and, between legs,

  1. recomputes the gradient EXACTLY in float64 on the host from alpha,
  2. REJECTS a leg whose true gap regressed, reverting and halving the
     next leg's budget,
  3. judges convergence ONLY on the reconstructed gap, and reports the
     reconstructed extrema as the model's (b_hi, b_lo).

With ``config.compensated`` (Kahan gradient carry) the within-leg drift
is second order, so legs rarely reject. The legs run on the device
(CUDA); the O(n * n_sv) float64 certification runs on the host.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from dpsvm_tpu_torch.config import SVMConfig
from dpsvm_tpu_torch.ops.kernels import KernelParams
from dpsvm_tpu_torch.ops.select import extrema_np
from dpsvm_tpu_torch.solver.result import SolveResult
from dpsvm_tpu_torch.utils.checkpoint import (PeriodicCheckpointer,
                                              resume_solver_state)

# Smallest leg budget the halving scheme will run before giving up: below
# this the per-leg overhead (dispatch + reconstruction) dwarfs progress.
_LEG_FLOOR = 2048
_MAX_LEGS = 1000  # runaway guard; real runs end on gap/budget/floor

# Hybrid tail engine (engine='block' runs only): a full block leg that
# fails to cut the TRUE gap below this fraction of the previous one, or
# regresses it, is declared stalled, and every remaining leg runs the
# per-pair engine instead (block working sets can cycle at extreme-C
# tails while per-pair global selection closes them).
_BLOCK_STALL_RATIO = 0.5

# Upfront regime gate: C·n/d at or above this, with the resident (n, n)
# Gram within the device's budget, starts the legs on the per-pair
# engine. Its two halves (the JAX package's, reconstruct.py:60-107):
# C·n/d discriminates the regime where block working sets cycle (the
# algorithm's property, on any device); "the per-pair tail beats block
# legs when its rows are Gram gathers" was timed on the TPU. The
# threshold is carried over unmeasured on the H100 (ROADMAP A.4b); the
# budget half uses this port's own solve.resolve_gram budget.
_UPFRONT_CND = 1e6


def block_tail_doomed(config: SVMConfig, n: int, d: int, device=None,
                      gram_budget_bytes: int = None) -> bool:
    """True when a hybrid (engine='block' + reconstruction legs) run
    should START on the per-pair engine (+ auto resident Gram) instead
    of a block leg the C·n/d heuristic predicts will stall.
    `gram_budget_bytes` overrides the device's budget (tests)."""
    if config.c * n / max(d, 1) < _UPFRONT_CND:
        return False
    from dpsvm_tpu_torch.device import resolve_device
    from dpsvm_tpu_torch.solver.solve import _GRAM_MIN_N
    from dpsvm_tpu_torch.solver.solve import gram_budget_bytes as budget

    if gram_budget_bytes is None:
        gram_budget_bytes = budget(resolve_device(device))
    return n >= _GRAM_MIN_N and 4 * n * n <= gram_budget_bytes


def _stored_x64(x, dtype: str) -> np.ndarray:
    """The float64 view of X as the solver sees it: bfloat16 storage
    rounds the features (to nearest even, as the device stores them), and
    the reconstruction must certify the problem being solved."""
    x = np.asarray(x, np.float32)
    if dtype == "bfloat16":
        x = torch.from_numpy(np.ascontiguousarray(x)).to(
            torch.bfloat16).float().numpy()
    return x.astype(np.float64)


def gram_matvec_f64(x, coef, kp: KernelParams, dtype: str = "float32",
                    block: int = 4096, queries=None) -> np.ndarray:
    """K(x, x_active) @ coef_active in float64 on the host, blocked so at
    most a (block, n_active) kernel tile is live; only nonzero-coef
    columns are evaluated. Returns (len(queries) or n,) float64.

    `queries=None` evaluates at x's own rows (gradient reconstruction,
    with x rounded through `dtype` as the solver stored it); a (m, d)
    query matrix evaluates at arbitrary points (predict.py's float64
    path). Mirrors kernel_from_dots, the RBF distance clamp at 0
    included."""
    coef = np.asarray(coef, np.float64)
    if kp.kind == "precomputed":
        if queries is not None:
            raise ValueError(
                "precomputed kernels carry no feature vectors; gather "
                "K(query, train) columns instead "
                "(models/precomputed.py decision_function)")
        # x IS the (n, n) Gram: its active columns, read blockwise
        # through the stored dtype (the device gathers bf16-rounded rows
        # under dtype='bfloat16').
        active = np.nonzero(coef != 0.0)[0]
        out = np.zeros(x.shape[0], np.float64)
        for s in range(0, x.shape[0], block):
            blk = np.asarray(x[s:s + block][:, active], np.float32)
            out[s:s + block] = _stored_x64(blk, dtype) @ coef[active]
        return out
    xq = (_stored_x64(x, dtype) if queries is None
          else np.asarray(queries, np.float64))
    m = xq.shape[0]
    active = np.nonzero(coef != 0.0)[0]
    if active.size == 0:
        return np.zeros(m, np.float64)
    x64 = xq if queries is None else _stored_x64(x, dtype)
    xa = x64[active]
    ca = coef[active]
    out = np.empty(m, np.float64)
    if kp.kind == "rbf":
        sq = np.einsum("nd,nd->n", xq, xq)
        sqa = np.einsum("nd,nd->n", xa, xa)
    for s in range(0, m, block):
        t = xq[s:s + block]
        dots = t @ xa.T
        if kp.kind == "linear":
            k = dots
        elif kp.kind == "rbf":
            d2 = np.maximum(sq[s:s + block, None] + sqa[None, :]
                            - 2.0 * dots, 0.0)
            k = np.exp(-kp.gamma * d2)
        elif kp.kind == "poly":
            k = (kp.gamma * dots + kp.coef0) ** kp.degree
        elif kp.kind == "sigmoid":
            k = np.tanh(kp.gamma * dots + kp.coef0)
        else:
            raise ValueError(f"unknown kernel kind {kp.kind!r}")
        out[s:s + block] = k @ ca
    return out


def _linear_term(x, y64, alpha_init, f_init, kp: KernelParams,
                 dtype: str) -> np.ndarray:
    """The y-scaled linear term of the dual, recovered from the caller's
    start point: f_i = sum_j a_j y_j K_ij + y_i p_i, so
    y*p = f_init - K @ (alpha_init * y). For the plain C-SVC start
    (f_init is None) it is exactly -y; the SVR / one-class / nu
    reductions (models/*.py) supply their transformed f_init."""
    if f_init is None:
        return -y64
    yp = np.asarray(f_init, np.float64).copy()
    if alpha_init is not None and np.any(np.asarray(alpha_init) != 0):
        yp -= gram_matvec_f64(
            x, np.asarray(alpha_init, np.float64) * y64, kp, dtype)
    return yp


def solve_in_legs(base_solve, x, y, config: SVMConfig, callback=None,
                  checkpoint_path: Optional[str] = None, resume: bool = False,
                  alpha_init=None, f_init=None, **solve_kw) -> SolveResult:
    """Run ``base_solve`` (solver/solve.py solve) in reconstruction
    legs. See the module docstring for the scheme.

    Contract notes:
      * ``iterations`` counts ALL pair updates executed, including those
        of rejected legs (the budget was genuinely spent);
      * ``converged``/``b_hi``/``b_lo`` come from the float64
        reconstruction, never the carried state;
      * checkpoints (``checkpoint_path``) are written once per leg with
        the reconstructed state, so a resume restarts from certified
        ground truth rather than drifted carry.
    """
    x = np.asarray(x, np.float32)
    y_i32 = np.asarray(y, np.int32)
    y64 = y_i32.astype(np.float64)
    n, d = x.shape
    kp = KernelParams(config.kernel, config.resolve_gamma(d),
                      config.degree, config.coef0)
    target = 2.0 * config.epsilon
    # Legs aim BELOW the outer target (0.35x, the JAX package's measured
    # factor): carried-converging at exactly the target stalls the true
    # gap just above it once residual drift is added back. The outer
    # config's RESOLVED matmul precision is pinned explicitly: the inner
    # legs have reconstruct_every=0, so auto would drop the accuracy-mode
    # escalation to "highest".
    inner = config.replace(reconstruct_every=0,
                           epsilon=0.35 * config.epsilon,
                           checkpoint_every=0,
                           matmul_precision=config.resolve_precision()
                           or "default")
    yp = _linear_term(x, y64, alpha_init, f_init, kp, config.dtype)

    alpha_cur = (None if alpha_init is None
                 else np.asarray(alpha_init, np.float32))
    f_cur = None if f_init is None else np.asarray(f_init, np.float32)
    pairs_done = 0
    if resume:
        restored = resume_solver_state(checkpoint_path, config, n)
        if restored is not None:
            alpha_cur = restored[0]
            f_cur = restored[1]
            pairs_done = int(restored[2])
    ckpt = PeriodicCheckpointer(checkpoint_path, config, pairs_done)

    aborted = [False]
    if callback is not None and hasattr(callback, "on_start"):
        # Fired ONCE with the cumulative (possibly resumed) pair count.
        # The per-leg wrappers deliberately carry no on_start: the inner
        # solves must not re-baseline a resume-aware metrics callback at
        # every leg.
        callback.on_start(pairs_done)

    def wrap_cb(offset):
        # Leg-local iteration counts are re-based onto the cumulative
        # pair count; a truthy return aborts the leg AND the leg loop.
        if callback is None:
            return None

        def cb(it, bh, bl, st):
            r = callback(offset + it, bh, bl, st)
            if r:
                aborted[0] = True
            return r

        return cb

    gap = np.inf
    b_hi = b_lo = None
    leg_budget = int(config.reconstruct_every)
    floor = min(_LEG_FLOOR, leg_budget)
    device_s = recon_s = 0.0
    recons = legs = 0
    converged = False
    hybrid = config.engine == "block"
    switch_pairs = None  # cumulative pair count at the block->xla switch
    upfront = False

    def switch_to_per_pair():
        # The per-pair engine takes over for the remaining legs: same
        # selection rule, block-only knobs reset (they would fail
        # validation on engine='xla').
        nonlocal inner, switch_pairs
        inner = inner.replace(engine="xla", pair_batch=1,
                              active_set_size=0, fused_fold=None,
                              fused_round=None, pipeline_rounds=None,
                              local_working_sets=None, sync_rounds=1)
        switch_pairs = pairs_done
        if config.verbose and not upfront:
            print(f"[reconstruct] block legs stalled at true gap "
                  f"{gap:.6f} after {pairs_done} pairs; switching "
                  f"remaining legs to the per-pair engine", flush=True)

    if hybrid and block_tail_doomed(config, n, d,
                                    device=solve_kw.get("device")):
        # Upfront regime gate: start the per-pair (+ auto resident Gram)
        # tail directly: at this (C, n, d) block legs are expected to
        # cycle, and the reactive stall detector below would burn a full
        # leg re-learning it (see _UPFRONT_CND).
        upfront = True
        switch_to_per_pair()
        if config.verbose:
            print(f"[reconstruct] upfront regime gate: C*n/d = "
                  f"{config.c * n / max(d, 1):.3g} >= {_UPFRONT_CND:.0e} "
                  f"and the resident Gram fits — starting legs on the "
                  f"per-pair engine", flush=True)

    def reconstruct(alpha):
        f64 = gram_matvec_f64(
            x, np.asarray(alpha, np.float64) * y64, kp, config.dtype) + yp
        bh, bl = extrema_np(f64, alpha, y_i32, config.c_bounds(),
                            rule=config.selection)
        return f64, float(bh), float(bl)

    if alpha_cur is not None and np.any(alpha_cur != 0):
        # Warm start / resume: establish the rejection baseline from the
        # CURRENT state, or the first leg would be accepted even if it
        # regressed below the (possibly already good) starting point.
        t0 = time.perf_counter()
        f64_new, b_hi, b_lo = reconstruct(alpha_cur)
        recon_s += time.perf_counter() - t0
        recons += 1
        f_cur = f64_new.astype(np.float32)
        gap = b_lo - b_hi
        converged = gap <= target

    while (not converged and legs < _MAX_LEGS
           and pairs_done < config.max_iter):
        legs += 1
        cfg = inner.replace(
            max_iter=min(leg_budget, config.max_iter - pairs_done))
        res = base_solve(x, y_i32, cfg, callback=wrap_cb(pairs_done),
                         alpha_init=alpha_cur, f_init=f_cur, **solve_kw)
        pairs_done += int(res.iterations)
        device_s += res.train_seconds
        t0 = time.perf_counter()
        f64_new, bh, bl = reconstruct(res.alpha)
        recon_s += time.perf_counter() - t0
        recons += 1
        new_gap = bl - bh
        if config.verbose:
            print(f"[reconstruct] leg={legs} budget={cfg.max_iter} "
                  f"pairs={pairs_done} "
                  f"carried_gap={float(res.b_lo - res.b_hi):.6f} "
                  f"true_gap={new_gap:.6f}", flush=True)
        if np.isfinite(gap) and new_gap > gap:
            # REJECT: revert to the kept state. A regressed BLOCK leg in
            # hybrid mode is the cycling signature — switch engines at
            # the full budget; otherwise halve (drift floor semantics:
            # the true gap descends monotonically by construction).
            if hybrid and inner.engine == "block":
                switch_to_per_pair()
                if aborted[0]:
                    break
                continue
            leg_budget //= 2
            if leg_budget < floor or aborted[0]:
                break
            continue
        prev_gap = gap
        alpha_cur = res.alpha
        f_cur = f64_new.astype(np.float32)
        gap, b_hi, b_lo = float(new_gap), bh, bl
        if ckpt.active:
            ckpt.save(pairs_done, alpha_cur, f_cur, b_hi, b_lo, force=True)
        if gap <= target:
            converged = True
            break
        if aborted[0]:
            break
        if (hybrid and inner.engine == "block" and np.isfinite(prev_gap)
                and gap > _BLOCK_STALL_RATIO * prev_gap):
            # Accepted but stalled block leg: hand the tail to the
            # per-pair engine (supersedes the drift-floor halving — the
            # slow progress is the engine, not the leg length).
            switch_to_per_pair()
            continue
        if np.isfinite(prev_gap) and gap > 0.85 * prev_gap:
            # Near the per-leg drift floor: finer legs resolve further.
            leg_budget //= 2
            if leg_budget < floor:
                break

    if b_hi is None:
        # No leg ran (resumed at budget) or none was accepted: certify
        # whatever state we hold so the result is still reconstructed.
        if alpha_cur is None:
            alpha_cur = np.zeros(n, np.float32)
        t0 = time.perf_counter()
        f64_new, b_hi, b_lo = reconstruct(alpha_cur)
        recon_s += time.perf_counter() - t0
        recons += 1
        f_cur = f64_new.astype(np.float32)
        gap = b_lo - b_hi
        converged = gap <= target

    return SolveResult(
        alpha=alpha_cur,
        b=float((b_lo + b_hi) / 2.0),
        b_hi=float(b_hi),
        b_lo=float(b_lo),
        iterations=pairs_done,
        converged=converged,
        train_seconds=device_s,
        stats={
            "f": f_cur,
            "true_gap": float(gap),
            "legs": legs,
            "reconstructions": recons,
            "reconstruct_seconds": recon_s,
            "final_leg_budget": leg_budget,
            # Cumulative pair count at which hybrid mode handed the tail
            # to the per-pair engine (None: never switched / not block;
            # 0 with hybrid_upfront: the C·n/d regime gate fired before
            # any leg ran).
            "hybrid_switch_pairs": switch_pairs,
            "hybrid_upfront": upfront,
        },
    )
