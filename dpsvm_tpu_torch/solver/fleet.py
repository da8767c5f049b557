"""Batched multi-problem SMO: a FLEET of binary problems over one shared X
(counterpart of dpsvm_tpu/solver/fleet.py).

The per-problem carries (alpha, f, b_hi, b_lo, it) are stacked (k, n) /
(k,) tensors; X, or the resident Gram, is on the device once. One trip
advances every still-active problem by one maximal-violating-pair
iteration:

* selection is one batched masked argmin / argmax
  (ops/select.py select_working_set_batched);
* the 2k kernel rows of a trip come from ONE (2k, d) x (d, n) product,
  or as 2k row gathers of the resident (or precomputed) Gram;
* the pair algebra is the per-pair engine's pair_alpha_update on (k,)
  vectors, and the rank-2 gradient update its two fused multiply-adds;
* a problem that has converged (or spent max_iter) is FROZEN: its
  update is gated off with torch.where, so alpha, f, the extrema and
  the pair count stay bit for bit what they were at its stop, and a
  non-finite kernel value in a frozen lane cannot leak into it.

OvO's class subsets are row masks over the shared X (`valid`), and each
problem carries its own box bounds, so a C sweep shares one fleet
(estimators.svc_c_sweep).

The host loop. JAX runs the trips as one lax.while_loop on the device.
Here a chunk of FLEET_TRIPS trips is queued with no host read at all:
the pair ids stay on the device (index_select gathers the rows), and
the loop's stop test, "any problem active", is read ONCE a chunk. On
CUDA the chunk is captured once as a CUDA graph and replayed
(FleetGraph), so a chunk costs one launch, not one host dispatch per
kernel. Trips queued after the last problem froze are gated no-ops and
are not counted (`t` counts the trips on which some problem was active,
JAX's trip count). Each problem's trajectory is the per-pair mvp
engine's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from dpsvm_tpu_torch.config import SVMConfig
from dpsvm_tpu_torch.device import precision_ctx, resolve_device, synchronize
from dpsvm_tpu_torch.ops.kernels import (KernelParams, kernel_rows,
                                         resolve_bf16_gram,
                                         warn_if_bf16_degrades)
from dpsvm_tpu_torch.ops.select import (refresh_extrema_host,
                                        select_working_set_batched)
from dpsvm_tpu_torch.solver.result import SolveResult
from dpsvm_tpu_torch.solver.smo import fma32, pair_alpha_update
from dpsvm_tpu_torch.solver.solve import (_BUDGET_EPS, check_precomputed,
                                          resolve_gram, stage_x)

# Trips queued between two reads of the stop test when nothing observes
# the fleet (verbose reads every chunk_iters trips). At most this many
# gated no-op trips run after the last problem freezes.
FLEET_TRIPS = 256


@dataclasses.dataclass
class FleetProblem:
    """One binary problem over the fleet's SHARED row set.

    y         (n,) labels in {-1, +1} over ALL shared rows (values
              outside `row_mask` are ignored);
    row_mask  (n,) bool marking this problem's rows (None: all rows);
              OvO subsets ride the shared X this way;
    c         box bound override: a scalar C (the config's class weights
              still apply) or an explicit (c_pos, c_neg); None: the
              config's c_bounds();
    tag       caller bookkeeping, returned in stats["tag"];
    alpha_init / f_init  a per-problem warm start over the shared rows,
              both or neither (already feasible for this problem's box,
              zero outside row_mask).
    """

    y: np.ndarray
    row_mask: Optional[np.ndarray] = None
    c: object = None
    tag: object = None
    alpha_init: Optional[np.ndarray] = None
    f_init: Optional[np.ndarray] = None


class FleetState(NamedTuple):
    """The fleet's carry, on the device: the per-pair state stacked
    along the problem axis, and the trip count."""

    alpha: torch.Tensor  # (k, n) float32
    f: torch.Tensor  # (k, n) float32
    b_hi: torch.Tensor  # (k,) float32
    b_lo: torch.Tensor  # (k,) float32
    it: torch.Tensor  # (k,) int32 pair updates
    t: torch.Tensor  # () int32 trips on which some problem was active


def active_mask(st: FleetState, max_iter: int, eps: float) -> torch.Tensor:
    """(k,) bool: the problems still iterating (pairs left and the
    carried gap open, tested in float32 as the loop condition)."""
    return (st.it < max_iter) & (st.b_lo > st.b_hi + 2.0 * eps)


def _col(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """a[j, i[j]] for each row j."""
    return torch.gather(a, 1, i[:, None])[:, 0]


def fleet_trip(x, y, x_sq, valid, cb, st: FleetState, max_iter: int,
               kp: KernelParams, eps: float, tau: float) -> FleetState:
    """ONE trip of the fleet: every active problem takes one mvp pair
    update; frozen problems are gated out bit for bit. No host read."""
    k = y.shape[0]
    active = active_mask(st, max_iter, eps)
    i_hi, b_hi, i_lo, b_lo = select_working_set_batched(
        st.f, st.alpha, y, cb[:, 0:1], cb[:, 1:2], valid)
    idx = torch.cat([i_hi, i_lo])
    rows = kernel_rows(x, x_sq, x.index_select(0, idx),
                       x_sq.index_select(0, idx), kp)
    rows_hi, rows_lo = rows[:k], rows[k:]
    eta = torch.clamp(_col(rows_hi, i_hi) + _col(rows_lo, i_lo)
                      - 2.0 * _col(rows_hi, i_lo), min=tau)
    y_hi, y_lo = _col(y, i_hi), _col(y, i_lo)
    a_hi_old, a_lo_old = _col(st.alpha, i_hi), _col(st.alpha, i_lo)
    c_hi = torch.where(y_hi > 0, cb[:, 0], cb[:, 1])
    c_lo = torch.where(y_lo > 0, cb[:, 0], cb[:, 1])
    a_hi_new, a_lo_new = pair_alpha_update(
        a_hi_old, a_lo_old, y_hi, y_lo, b_hi, b_lo, eta, c_hi, c_lo,
        gate=active)
    rowid = torch.arange(k, device=y.device)
    # lo first, hi second: the per-pair engine's override order.
    alpha = st.alpha.index_put((rowid, i_lo), a_lo_new)
    alpha = alpha.index_put((rowid, i_hi), a_hi_new)
    d_hi = ((a_hi_new - a_hi_old) * y_hi)[:, None]
    d_lo = ((a_lo_new - a_lo_old) * y_lo)[:, None]
    f = fma32(d_lo, rows_lo, fma32(d_hi, rows_hi, st.f))
    f = torch.where(active[:, None], f, st.f)
    return FleetState(alpha, f, torch.where(active, b_hi, st.b_hi),
                      torch.where(active, b_lo, st.b_lo),
                      st.it + active.to(torch.int32),
                      st.t + active.any().to(torch.int32))


def run_fleet_chunk(x, y, x_sq, valid, cb, state: FleetState, max_iter: int,
                    kp: KernelParams, eps: float, tau: float,
                    trips: int) -> FleetState:
    """Queue `trips` trips (the JAX package's _run_fleet_chunk, with the
    stop test left to the caller's one read a chunk)."""
    for _ in range(trips):
        state = fleet_trip(x, y, x_sq, valid, cb, state, max_iter, kp, eps,
                           tau)
    return state


class FleetGraph:
    """`trips` fleet trips captured once as a CUDA graph and replayed
    (CUDA only): a trip is some forty small kernels, and a replay queues
    all of a chunk's at the cost of one launch instead of one host
    dispatch each. The carry lives in static buffers (`state`) that the
    graph reads and writes back, so replays chain; the trips are
    run_fleet_chunk's, kernel for kernel."""

    def __init__(self, x, y, x_sq, valid, cb, state: FleetState,
                 max_iter: int, kp: KernelParams, eps: float, tau: float,
                 trips: int):
        dev = y.device
        self.state = FleetState(*(t.clone() for t in state))
        args = (x, y, x_sq, valid, cb)
        rest = (max_iter, kp, eps, tau)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):  # warm-up, as capture requires
            fleet_trip(*args, self.state, *rest)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            out = run_fleet_chunk(*args, self.state, *rest, trips)
            for dst, src in zip(self.state, out):
                dst.copy_(src)

    def run(self) -> FleetState:
        """Replay the chunk; returns the carry (the static buffers)."""
        self.graph.replay()
        return self.state


def fleet_routing_reasons(config: SVMConfig) -> list:
    """Why a config cannot ROUTE through the fleet (empty: eligible): the
    gate models/multiclass.py _fleet_eligible and estimators.svc_c_sweep
    share. solve_fleet itself also takes kernel='precomputed'; these are
    the router's rules, where a silent engine swap would make results
    incomparable with what the user configured."""
    reasons = []
    if config.engine != "xla" or config.selection != "mvp" \
            or config.pair_batch != 1:
        reasons.append(
            "the fleet executor is the per-pair MVP engine "
            "(engine='xla', selection='mvp', pair_batch=1)")
    if config.kernel == "precomputed":
        reasons.append("kernel='precomputed' (per-split Gram sub-matrices)")
    if config.compensated or config.reconstruct_every:
        reasons.append("accuracy-mode (compensated/reconstruction) solves")
    return reasons


def _fleet_bucket(k_real: int) -> int:
    """The power-of-two fleet height of k_real problems (the JAX package
    pads a short chunk to it so one compiled shape serves; the port keeps
    the same stack shape, so both packages solve the same problems)."""
    return 1 << max(0, k_real - 1).bit_length()


def _problem_bounds(p: FleetProblem, config: SVMConfig) -> tuple:
    """(c_pos, c_neg) of one problem: the config's bounds, a scalar C
    override (the class weights still apply) or an explicit pair."""
    if p.c is None:
        return config.c_bounds()
    if isinstance(p.c, tuple):
        cp, cn = p.c
        return float(cp), float(cn)
    c = float(p.c)
    if c <= 0:
        raise ValueError("FleetProblem.c must be > 0")
    return c * config.weight_pos, c * config.weight_neg


def _stack_problems(problems, config: SVMConfig, n: int, n_pad: int,
                    k_pad: int) -> tuple:
    """The host stacks (y (k_pad, n_pad) float32, valid bool, cb
    (k_pad, 2) float32, masks) of the problems, with the JAX package's
    checks. Bucket-padding problems have no rows: their sets are empty,
    the gap reads closed after one sentinel trip and they freeze."""
    y_stack = np.ones((k_pad, n_pad), np.float32)
    valid = np.zeros((k_pad, n_pad), bool)
    cb = np.ones((k_pad, 2), np.float32)
    masks = []
    for j, p in enumerate(problems):
        yj = np.asarray(p.y)
        if yj.shape != (n,):
            raise ValueError(
                f"problem {j}: y has shape {yj.shape}, expected "
                f"({n},) over the shared row set")
        if p.row_mask is None:
            mask = np.ones((n,), bool)
        else:
            mask = np.asarray(p.row_mask, bool)
            if mask.shape != (n,):
                raise ValueError(
                    f"problem {j}: row_mask has shape {mask.shape}, "
                    f"expected ({n},)")
        lab = set(np.unique(yj[mask]).tolist())
        if not lab <= {-1, 1, -1.0, 1.0}:
            raise ValueError(
                f"problem {j}: masked labels must be in {{-1, +1}}, "
                f"got {sorted(lab)[:6]}")
        y_stack[j, :n] = np.where(mask, yj, 1.0).astype(np.float32)
        valid[j, :n] = mask
        cb[j] = _problem_bounds(p, config)
        masks.append(mask)
        if (p.alpha_init is None) != (p.f_init is None):
            raise ValueError(
                f"problem {j}: alpha_init and f_init come together")
    return y_stack, valid, cb, masks


def _start_stacks(problems, masks, y_stack, n: int) -> tuple:
    """(alpha0, f0) host stacks: the cold start (alpha 0, f -y), with
    each warm-started problem's rows written in."""
    alpha = np.zeros_like(y_stack)
    f = (-y_stack).astype(np.float32)
    for j, p in enumerate(problems):
        if p.alpha_init is None:
            continue
        a_j = np.asarray(p.alpha_init, np.float32)
        f_j = np.asarray(p.f_init, np.float32)
        if a_j.shape != (n,) or f_j.shape != (n,):
            raise ValueError(
                f"problem {j}: alpha_init/f_init must be ({n},) over the "
                f"shared row set, got {a_j.shape} / {f_j.shape}")
        alpha[j, :n] = np.where(masks[j], a_j, 0.0)
        f[j, :n] = np.where(masks[j], f_j, f[j, :n])
    return alpha, f


def _fleet_dtype(x, problems, config: SVMConfig, gamma: float) -> tuple:
    """(storage dtype, stats entries): config.dtype, or bfloat16 where
    config.bf16_gram's gate accepts for the WHOLE fleet (shared X, one
    storage dtype), judged at the largest box bound any problem runs
    under; a refusal stays float32 and warns."""
    if not config.bf16_gram:
        return config.dtype, {}
    c_max = max(config.c_bounds())
    for p in problems:
        if p.c is not None:
            c_max = max(c_max, float(np.max(np.asarray(p.c, np.float64))))
    active, _, entry = resolve_bf16_gram(
        x, config, gamma, c_max=c_max,
        scope="for the fleet (largest per-problem C)")
    if not active:
        import warnings

        warnings.warn(entry["note"], stacklevel=3)
    return ("bfloat16" if active else "float32"), {"bf16_gram": entry}


class FleetRun(NamedTuple):
    """A fleet staged on its device: the trips' arguments, the start
    carry, and the host stacks the results are cut from."""

    args: tuple  # (x, y, x_sq, valid, cb) on the device
    rest: tuple  # (max_iter, kp, eps, tau) of the trips
    state: FleetState  # the start carry
    y_stack: np.ndarray  # (k_pad, n) float32
    cb: np.ndarray  # (k_pad, 2) float32 box bounds
    masks: list  # the real problems' (n,) row masks
    use_gram: bool
    extra: dict  # stats entries (the bf16_gram gate)


def stage_fleet(x, problems: list, config: SVMConfig, dev: torch.device,
                pad_to: Optional[int] = None) -> FleetRun:
    """Check the problems and the config as the JAX package's solve_fleet
    does, and stage X (or the resident Gram, or the caller's Gram), the
    stacks and the start carry on `dev`."""
    if config.selection != "mvp":
        raise ValueError(
            "solve_fleet implements the reference MVP rule only "
            f"(selection={config.selection!r}); run those problems "
            "through sequential solve()")
    if config.compensated or config.reconstruct_every:
        raise ValueError(
            "solve_fleet does not implement the compensated/"
            "reconstruction accuracy stack; use sequential solve() for "
            "extreme-C problems")
    config.check_ported()
    x = np.asarray(x, np.float32)
    n, d = x.shape
    gamma = config.resolve_gamma(d)
    kp = KernelParams(config.kernel, gamma, config.degree, config.coef0)
    warn_if_bf16_degrades(x, config)
    store_dtype, extra = _fleet_dtype(x, problems, config, gamma)
    if kp.kind == "precomputed":
        check_precomputed(x, max(n, int(pad_to or 0)))
    k_pad = _fleet_bucket(len(problems))
    y_stack, valid, cb, masks = _stack_problems(problems, config, n, n,
                                                k_pad)
    alpha0, f0 = _start_stacks(problems, masks, y_stack, n)
    use_gram = resolve_gram(config, max(n, int(pad_to or 0)), dev)
    x_dev, x_sq, _, kp_run = stage_x(x, n, store_dtype, kp, use_gram,
                                     config, dev)

    def on(a):
        return torch.as_tensor(a, device=dev)

    state = FleetState(
        on(alpha0), on(f0), torch.full((k_pad,), -float("inf"), device=dev),
        torch.full((k_pad,), float("inf"), device=dev),
        torch.zeros(k_pad, dtype=torch.int32, device=dev),
        torch.zeros((), dtype=torch.int32, device=dev))
    eps_run = _BUDGET_EPS if config.budget_mode else float(config.epsilon)
    return FleetRun((x_dev, on(y_stack), x_sq, on(valid), on(cb)),
                    (int(config.max_iter), kp_run, eps_run,
                     float(config.tau)),
                    state, y_stack, cb, masks, use_gram, extra)


def solve_fleet(x, problems: list, config: SVMConfig, device=None,
                pad_to: Optional[int] = None) -> list:
    """Train every FleetProblem of `problems` (all over `x`) as one fleet
    on `device` (None: the CUDA card). Returns one SolveResult per
    problem, in order; each result's alpha and f cover only that
    problem's rows (aligned with x[row_mask]), so it feeds the same model
    assembly as a sequential solve of the subset.

    Every problem runs the per-pair mvp iteration (engine="xla",
    selection="mvp", pair_batch=1): config.engine is not consulted, the
    fleet is its own executor. Honored: the kernel (precomputed too),
    epsilon, max_iter, tau, class weights (per-problem C overrides
    compose with them), dtype and bf16_gram, budget_mode, gram_resident
    (one shared resident Gram, memoized as solve's), matmul_precision,
    chunk_iters with verbose (one line a chunk). Not here: callbacks,
    checkpoints, the compensated and reconstruction stacks, the row
    cache, nu / second-order selection. `pad_to` sizes the resident-Gram
    budget, as solve's does.

    `train_seconds` is the fleet's time split evenly over the real
    problems (the graph's capture is set-up, outside it); stats["fleet"]
    holds the whole fleet's numbers (trips, host reads of the stop test,
    seconds, the capture's seconds)."""
    if not problems:
        return []
    dev = resolve_device(device)
    k_real = len(problems)
    # Trips between two reads: verbose reads every chunk_iters trips,
    # rounded up to whole replays of the FLEET_TRIPS-trip graph.
    replays = -(-int(config.chunk_iters) // FLEET_TRIPS) if config.verbose \
        else 1
    with precision_ctx(config):
        run = stage_fleet(x, problems, config, dev, pad_to)
        state, k_pad, eps_run = run.state, run.cb.shape[0], run.rest[2]
        t0 = time.perf_counter()
        graph = (FleetGraph(*run.args, state, *run.rest, FLEET_TRIPS)
                 if dev.type == "cuda" else None)
        synchronize(dev)
        capture_seconds = time.perf_counter() - t0
        train_seconds = 0.0
        reads = 0
        while True:
            t0 = time.perf_counter()
            for _ in range(replays):
                state = (graph.run() if graph is not None else
                         run_fleet_chunk(*run.args, state, *run.rest,
                                         FLEET_TRIPS))
            # The chunk's one host read: the stop test and, with them,
            # every problem's extrema and pair count.
            act = active_mask(state, run.rest[0], eps_run)
            obs = torch.cat([act.float(), state.b_hi, state.b_lo,
                             state.it.float(), state.t.float()[None]])
            obs = obs.cpu().numpy()
            train_seconds += time.perf_counter() - t0
            reads += 1
            active = obs[:k_pad] > 0
            if config.verbose:
                gaps = (obs[2 * k_pad:3 * k_pad] - obs[k_pad:2 * k_pad])
                print(f"[fleet] trips={int(obs[-1])} "
                      f"active={int(active[:k_real].sum())}/{k_real} "
                      f"max_gap={float(np.max(gaps[:k_real])):.6f}")
            if not active.any():
                break
    b_hi = state.b_hi.cpu().numpy()
    b_lo = state.b_lo.cpu().numpy()
    it = state.it.cpu().numpy()
    t_trips = int(state.t)
    alpha_all = state.alpha.cpu().numpy()
    f_all = state.f.cpu().numpy()
    fleet = {"size": k_real, "bucket": k_pad, "dispatches": reads,
             "host_reads": reads, "trips": t_trips,
             "device_seconds": train_seconds,
             "capture_seconds": capture_seconds, "graph": graph is not None,
             "gram_resident": bool(run.use_gram)}
    cb = run.cb
    results = []
    for j, p in enumerate(problems):
        rows_idx = np.nonzero(run.masks[j])[0]
        full = rows_idx.shape[0] == alpha_all.shape[1]
        a_sub = alpha_all[j] if full else alpha_all[j][rows_idx]
        f_sub = f_all[j] if full else f_all[j][rows_idx]
        y_sub = (run.y_stack[j] if full
                 else run.y_stack[j][rows_idx]).astype(np.int32)
        bh, bl = float(b_hi[j]), float(b_lo[j])
        conv = not (bl > bh + 2.0 * eps_run)
        if config.budget_mode:
            # As solve: a budget exit reports the stopping rule at the
            # real epsilon on the final state.
            bh, bl, conv = refresh_extrema_host(
                f_sub, a_sub, y_sub, (float(cb[j, 0]), float(cb[j, 1])),
                config.epsilon)
        results.append(SolveResult(
            alpha=a_sub, b=float((bl + bh) / 2.0), b_hi=bh, b_lo=bl,
            iterations=int(it[j]), converged=bool(conv),
            train_seconds=train_seconds / k_real, dispatches=reads,
            stats={"f": f_sub, "tag": p.tag, "device": str(dev),
                   "fleet": {**fleet, "index": j}, **run.extra}))
    return results


def fleet_chunks(items: list, fleet_size: int) -> list:
    """Split a work list into fleets of at most fleet_size (the
    multiclass router's bucketing helper)."""
    size = max(1, int(fleet_size))
    return [items[s:s + size] for s in range(0, len(items), size)]
