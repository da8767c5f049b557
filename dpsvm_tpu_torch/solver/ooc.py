"""Out-of-core block engine: train with X resident on the HOST
(counterpart of dpsvm_tpu/solver/ooc.py solve_ooc and its single-device
round loop).

X stays in host memory, a NumPy array or an np.memmap, and never lives
on the device whole. The device holds the O(n) solver vectors (f, alpha,
y, x_sq, k_diag), two (tile, d) float32 tile buffers and, with
config.ooc_cache_lines, an (L, n) cache of dot rows. Each outer round
runs the in-core block engine's algebra (solver/block.py): selection
over the device gradient, the (q, q) Gram block of the working set's
rows (gathered on the host, uploaded once a round), the subproblem
(block.dispatch_subproblem: kernel B1 on the card) and the fold
f += coef @ K(W, :), which streams over tiles (ops/ooc.py fold_tile_body).

The stream (TileStream, the one-shard case of MeshTileStream). On the
card a tile goes memmap or array -> one of two pinned float32 buffers (a
host copy into its NumPy view) -> the device on a side stream, where an
event marks the copy; the compute stream waits on that event, casts to
the storage dtype (bfloat16 rounds to nearest even there, as on the
host) and folds. A pinned buffer and its device twin are rewritten only
after the event recorded behind the fold that read them has passed, so
the host's copy of tile t+1 overlaps the upload and fold of tile t and
nothing calls torch.cuda.synchronize. On the CPU the tiles are read in
turn.

Bits. The device state has the in-core engine's n rows (no padding:
the JAX package pads to whole tiles and masks the padding out), and a
tile's fold runs on its real rows only, so selection is the in-core
selection and every fold is the in-core fold's algebra on the same
columns. Where the library reduces the (q, T) tile products as it
reduces those columns of the in-core (q, n) products, the trajectory is
the in-core engine's bit for bit; on the CPU that holds when the tile is
a multiple of 16 rows and every tile has more than one row
(tests/test_torch_ooc.py pins it; ROADMAP.md C.26 records the rest).

Around the base round, as in the JAX package:

* the block cache (ooc_cache_lines): keys and ticks on the host, rows
  on the device (solver/cache.py probe_rows / refresh_rows); a round
  whose whole live working set hits reads its Gram block and fold rows
  from the lines and streams nothing;
* the shrunken stream (ooc_shrink / active_set_size): cycles of
  in-cycle rounds that select from an active view and stream only its
  tiles, each cycle opened by one full selection (the only stopping
  decision while shrinking), closed by a full reconstruction of f
  (solver/warmstart.py warm_f_rebuild, this stream's fold), and the
  endgame demotion to the exact full stream;
* checkpoints of the full carry (raw f, f_err, counters, the shrink
  keys) at round boundaries (cycle boundaries while shrinking); a
  cache-off resume is the uninterrupted run bit for bit; the cache is
  never saved, so a resumed cache-on run restarts it cold
  (stats["cache_cold_restart"]).

The mesh stream (solve_ooc_mesh, MeshTileStream): shard r of the mesh
owns rows [r n_loc, (r+1) n_loc) with n_loc = tile * ceil(n / (P tile)),
and stream step j carries tile j of every shard: the P tiles are copied
into one pinned block and uploaded once per distinct device. A round
selects across the shards (parallel/dist_block.py ooc_mesh_select, one
masked sum for the working set's scalars), reads the extrema once,
gathers the working set's rows on the host and uploads them once per
device, solves the subproblem once per device (kernel B1 on the card)
and folds each shard's own tiles with no exchange. Each shard's tile is
the one-device stream's tile r tiles_loc + j, folded on its real rows,
so the mesh stream's trajectory is the one-device stream's bit for bit
wherever that one is the in-core engine's (tests/test_torch_ooc_mesh.py).
The block cache and the shrunken stream stay single-device (refused with
the JAX package's ValueError).

Both solvers run inside the fault retry (solver/smo.py
run_with_fault_retry; solve() and solve_mesh add the non-finite
demotion), with the ``ooc_tile_put`` seam before every tile (mesh: every
step) upload and the ``dispatch`` seam before every round, and write the
JAX package's run-log records: a ``solver/ooc_setup_stream`` span, a
``solver/ooc_round`` span and a chunk record per round, and the
``resume``, ``shrink_reconstruct`` and ``shrink_demote`` events.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from dpsvm_tpu_torch.config import SVMConfig
from dpsvm_tpu_torch.device import precision_ctx, resolve_device
from dpsvm_tpu_torch.ops import ooc as ooc_ops
from dpsvm_tpu_torch.ops.kernels import (KernelParams, kernel_diag,
                                         kernel_from_dots, squared_norms,
                                         warn_if_bf16_degrades)
from dpsvm_tpu_torch.ops.select import refresh_extrema_host, shrink_view
from dpsvm_tpu_torch.solver import block, chunks
from dpsvm_tpu_torch.solver.cache import init_cache, probe_rows, refresh_rows
from dpsvm_tpu_torch.solver.result import SolveResult
from dpsvm_tpu_torch.solver.smo import (gap_open, maybe_kahan,
                                        run_with_fault_retry)
from dpsvm_tpu_torch.testing import faults
from dpsvm_tpu_torch.solver.solve import _BUDGET_EPS, _tdtype, block_height
from dpsvm_tpu_torch.utils.checkpoint import PeriodicCheckpointer


class OocState(NamedTuple):
    """The round state handed to callbacks (solve()'s callback
    contract)."""

    alpha: torch.Tensor
    f: torch.Tensor
    b_hi: float
    b_lo: float
    pairs: int
    rounds: int
    hits: int


# The shrunken stream's constants, the JAX package's: a cycle runs at
# most 32 rounds against its view; shrinking hands over to the full
# stream for good once the cycle-start gap is within 10x of eps, or the
# gap fails to shrink by 5% over a cycle twice in a row.
_SHRINK_CYCLE_ROUNDS = 32
_SHRINK_DEMOTE_EPS_MULT = 10.0
_SHRINK_STALL_FACTOR = 0.95
_SHRINK_STALL_CYCLES = 2

def _tile_host(x, s: int, t: int, n: int, d: int) -> np.ndarray:
    """Rows [s, s+t) of host X as a float32 (t, d) block, zero-padded
    past n. Slicing keeps a memmap lazy until here."""
    blk = np.asarray(x[s:min(s + t, n)], np.float32)
    if blk.shape[0] < t:
        pad = np.zeros((t, d), np.float32)
        pad[:blk.shape[0]] = blk
        return pad
    return np.ascontiguousarray(blk)


def host_rows(x, w: np.ndarray, dev: torch.device, dtype: str):
    """Rows w of host X on `dev` in the storage dtype: one fancy index
    of q rows on the host (a memmap reads just those) and one upload."""
    rows = np.ascontiguousarray(np.asarray(x[w], np.float32))
    return torch.from_numpy(rows).to(dev).to(_tdtype(dtype))


def solve_ooc(x, y, config: SVMConfig, callback=None, device=None,
              checkpoint_path=None, resume: bool = False, alpha_init=None,
              f_init=None, pad_to=None, warm_start=None) -> SolveResult:
    """Train binary C-SVC with host-resident X (config.ooc): the result
    contract of solver/solve.py solve. `x` may be any array-like the
    host can slice row blocks from, np.ndarray or np.memmap; it is never
    copied whole.

    `callback(pairs, b_hi, b_lo, state)` runs after every round (state:
    OocState); a truthy return stops there and forces a checkpoint.
    With `checkpoint_path` and config.checkpoint_every > 0 the full
    carry is saved at round boundaries (cycle boundaries while
    shrinking); `resume=True` restores it, from either package's file.
    `warm_start` (solver/warmstart.py WarmStart) is repaired and its
    gradient rebuilt by this solver's tile stream, then passed on as
    alpha_init / f_init; a seed that repairs to zeros runs the cold path
    bit for bit. `pad_to` is accepted and changes nothing (no compiled
    shape to bucket for). A transient fault is retried (config.
    retry_faults) from the last checkpoint this run wrote."""
    config.check_ported()
    if warm_start is not None:
        if alpha_init is not None or f_init is not None:
            raise ValueError(
                "pass either warm_start or alpha_init/f_init, not both")
        from dpsvm_tpu_torch.solver.warmstart import prepare_warm_start

        a0, f0, wstats = prepare_warm_start(x, y, config, warm_start,
                                            device=device)
        res = solve_ooc(x, y, config, callback=callback, device=device,
                        checkpoint_path=checkpoint_path, resume=resume,
                        alpha_init=a0, f_init=f0)
        res.stats["warm_start"] = wstats
        return res
    dev = resolve_device(device)

    def attempt(cfg_k, res_k, _k):
        return _solve_ooc_impl(x, y, cfg_k, callback, dev, checkpoint_path,
                               res_k, alpha_init, f_init)

    with precision_ctx(config):
        return run_with_fault_retry(config, checkpoint_path, resume, attempt)


def _ooc_select(f, f_err, alpha, y, valid, c, q: int, selection: str):
    """One selection over the device gradient and ONE host read of its
    outputs: (w, slot_ok, b_hi_t, b_lo_t) on the device and (w, slot_ok,
    b_hi, b_lo) on the host (the extrema as their float32 values)."""
    f_cur = f if f_err is None else f - f_err
    w, slot_ok, b_hi, b_lo = block.select_block(f_cur, alpha, y, c, q,
                                                valid=valid, rule=selection)
    packed = torch.cat([w.to(torch.int32), slot_ok.to(torch.int32),
                        torch.stack([b_hi, b_lo]).float().view(torch.int32)])
    host = packed.cpu().numpy()
    bh, bl = host[2 * q:].view(np.float32)
    return ((w, slot_ok, b_hi, b_lo),
            (host[:q].astype(np.int64), host[q:2 * q].astype(bool),
             float(bh), float(bl)))


def _ws_scalars(w, f_cur, alpha, y, x_sq, k_diag):
    """The working set's per-slot scalars (q, 5) [x_sq, k_diag, alpha, y,
    f_eff] at W, as the mesh stream gathers them."""
    return torch.stack([x_sq[w], k_diag[w], alpha[w], y[w], f_cur[w]],
                       dim=1)


def _ooc_subproblem(qx, w, slot_ok, scal, b_hi_t, b_lo_t, budget_left: int,
                    kb_w, kp, c, eps: float, tau: float, inner: int,
                    selection: str, pair_batch: int):
    """The round's subproblem (the in-core gather_block + limit +
    dispatch_subproblem, kernel B1 on the card) from W's rows `qx` and
    scalars `scal` (_ws_scalars; on the mesh, zero at dead slots, which
    the subproblem masks): (a_w, coef, t, qsq). `kb_w` is the Gram block
    when the caller has it (an all-hit round reads it from the cache),
    else it is built from `qx`."""
    qsq, kd_w, a_w0, y_w, f_w0 = (scal[:, k].contiguous() for k in range(5))
    if kb_w is None:
        kb_w = block.gram_block(qx, qsq, w, kp)
    budget = torch.tensor(budget_left, dtype=torch.int32,
                          device=scal.device)
    limit = torch.clamp(budget, max=inner)
    limit = torch.where(b_lo_t > b_hi_t + 2.0 * eps, limit, 0).to(
        torch.int32)
    a_w, coef, t = block.dispatch_subproblem(
        kb_w, kd_w, slot_ok, a_w0, y_w, f_w0, c, eps, tau, limit, selection,
        pair_batch)
    return a_w, coef, t, qsq


def _ooc_round_cached(cache, slot_np, ok_np, w, slot_ok, f, f_err, alpha,
                      y, x_sq, k_diag, b_hi_t, b_lo_t, budget_left: int,
                      stamp: int, sub: tuple):
    """ONE all-hit round: the Gram block and the fold rows both read from
    the cache lines `slot_np`, nothing streamed or recomputed; the live
    lines are stamped. The rows are full width, so the round is exact on
    every row even mid-cycle. Returns (f, f_err, alpha, t)."""
    kp = sub[0]
    dots_w = cache.data[torch.as_tensor(slot_np, device=f.device)]
    qsq = x_sq[w]
    kb_w = kernel_from_dots(dots_w[:, w], qsq, qsq, kp)
    scal = _ws_scalars(w, f if f_err is None else f - f_err, alpha, y, x_sq,
                       k_diag)
    a_w, coef, t, qsq = _ooc_subproblem(None, w, slot_ok, scal, b_hi_t,
                                        b_lo_t, budget_left, kb_w, *sub)
    f, f_err = maybe_kahan(f, f_err,
                           coef @ kernel_from_dots(dots_w, x_sq, qsq, kp))
    cache.ticks[slot_np[ok_np]] = stamp
    return f, f_err, block.scatter_alpha(alpha, w, slot_ok, a_w), t


def _ooc_fold_stream(stream: TileStream, order, x_sq, f, f_err, qx, qsq,
                     coef, kp, want_dots: bool) -> tuple:
    """A stream round's fold over the tiles `order`, each tile's slice
    folded by ops/ooc.py ooc_fold_tile into new (f, f_err) (the old ones
    may be held by a callback); tiles not in `order` pass through.
    Returns (f, f_err, the (q, rows) dot rows when `want_dots`, tiles
    streamed)."""
    f = f.clone()
    f_err = None if f_err is None else f_err.clone()
    dots = []
    streamed = 0
    for i, xt, rows in stream.walk(order):
        s = i * stream.tile
        ft, et, dt = ooc_ops.ooc_fold_tile(
            xt, x_sq[s:s + rows], f[s:s + rows],
            None if f_err is None else f_err[s:s + rows], qx, qsq, coef, kp,
            want_dots=want_dots, compensated=f_err is not None)
        f[s:s + rows] = ft
        if et is not None:
            f_err[s:s + rows] = et
        if want_dots:
            dots.append(dt)
        streamed += 1
    return f, f_err, dots, streamed


def _solve_ooc_impl(x, y, config: SVMConfig, callback, dev, checkpoint_path,
                    resume, alpha_init, f_init) -> SolveResult:
    t_entry = time.perf_counter()
    y_np = np.asarray(y, np.int32)
    n, d = x.shape
    kp = KernelParams(config.kernel, config.resolve_gamma(d), config.degree,
                      config.coef0)
    dtype = config.dtype
    if dtype == "bfloat16":
        warn_if_bf16_degrades(np.asarray(x[:min(n, 4096)], np.float32),
                              config)
    tile = min(int(config.ooc_tile_rows), n)
    tiles = -(-n // tile)
    q, inner = block_height(config, n)
    lines = int(config.ooc_cache_lines)
    use_cache = lines > 0

    # The shrunken stream: active_set_size asks for it and sizes the
    # view; ooc_shrink=True asks for the auto-sized view; None consults
    # the device profile's ooc_shrink gate (default off). The auto view
    # is sized on the whole tiles' rows, as the JAX package sizes it on
    # its padded rows.
    gate, autotune_embed = block.autotune_gate_resolver(dev)
    if config.active_set_size:
        use_shrink, shrink_m = True, int(config.active_set_size)
    elif config.ooc_shrink is not None:
        use_shrink, shrink_m = bool(config.ooc_shrink), 0
    else:
        use_shrink, shrink_m = bool(gate("ooc_shrink", False)), 0
    if use_shrink:
        rows_pad = tiles * tile
        if shrink_m <= 0:
            shrink_m = max(4 * q, rows_pad // 8)
        shrink_m = max(q, min(shrink_m, rows_pad))
        shrink_m -= shrink_m % 2

    obs = chunks.open_run_obs(
        "solve", config,
        {"n": n, "d": d, "n_pad": n, "engine": config.engine,
         "kernel": config.kernel, "selection": config.selection,
         "ooc": True, "ooc_tile_rows": tile, "ooc_tiles": tiles,
         "ooc_cache_lines": lines, "ooc_shrink": use_shrink,
         "shrink_m": shrink_m if use_shrink else 0, **autotune_embed()},
        dev)
    y_dev = torch.as_tensor(y_np.astype(np.float32), device=dev)
    stream = TileStream(x, n, d, tile, dev, dtype)
    # The setup pass: the squared norms of the STORED rows, tile by tile
    # (a row's reduction is the in-core squared_norms', so x_sq is the
    # same bits).
    with obs.span("solver/ooc_setup_stream"):
        x_sq = torch.empty(n, dtype=torch.float32, device=dev)
        stream.seam = False
        for i, xt, rows in stream.walk(range(tiles)):
            x_sq[i * tile:i * tile + rows] = squared_norms(xt)
        stream.seam = True
        k_diag = kernel_diag(x_sq, kp)
    setup_bytes = stream.bytes  # the stream counters leave the setup out

    start = chunks.start_state(y_np, config, checkpoint_path, resume,
                               alpha_init, f_init)
    if start.resumed:
        obs.event("resume", iteration=start.pairs, rounds=start.rounds,
                  cache_cold_restart=bool(use_cache),
                  shrink_demoted=bool(start.shrink_demoted))
    alpha = torch.as_tensor(start.alpha, device=dev)
    f = torch.as_tensor(start.f, device=dev)
    f_err = (None if start.f_err is None
             else torch.as_tensor(start.f_err, device=dev))
    cache = init_cache(lines, n, dev) if use_cache else None

    c = config.c_bounds()
    eps_run = _BUDGET_EPS if config.budget_mode else float(config.epsilon)
    max_iter = int(config.max_iter)
    tau = float(config.tau)
    sub = (kp, c, eps_run, tau, inner, config.selection,
           int(config.pair_batch))

    ckpt = PeriodicCheckpointer(checkpoint_path, config, start.pairs)
    if callback is not None and hasattr(callback, "on_start"):
        callback.on_start(start.pairs)
    pairs, rounds = start.pairs, start.rounds
    tiles_streamed = cache_hits = cache_lookups = cache_evictions = 0
    cached_rounds = 0
    b_hi, b_lo = -np.inf, np.inf
    converged = False
    train_seconds = 0.0
    phase_seconds = {"setup": time.perf_counter() - t_entry, "solve": 0.0,
                     "observe": 0.0, "finalize": 0.0}

    # Shrink cycle state: `active` is the device view mask while a cycle
    # is open (None between cycles); `stale` is set by the first round
    # that skips a tile and cleared only by a full reconstruction, which
    # every exit path runs while stale.
    shrink_live = use_shrink and not start.shrink_demoted
    shrink_demoted = use_shrink and start.shrink_demoted
    last_cycle_gap = start.shrink_gap
    stall_streak = start.shrink_stall
    active = None
    live_list = []
    cycle_rounds = 0
    stale = False
    shrink_cycles = reconstructions = 0
    tiles_skipped = bytes_skipped = tiles_in_cycle = 0

    def reconstruct(reason: str) -> int:
        """Rebuild f from alpha over all n in one streamed pass (the
        warm-start fold, this solver's stream) and restart the Kahan
        residual at zero. Returns the tiles it streamed."""
        nonlocal f, f_err, stale, reconstructions, tiles_streamed
        from dpsvm_tpu_torch.solver.warmstart import warm_f_rebuild

        alpha_h = alpha.cpu().numpy()
        f = torch.as_tensor(
            warm_f_rebuild(x, y_np, alpha_h, kp, device=dev, tile_rows=tile,
                           dtype=dtype, stream=stream), device=dev)
        if f_err is not None:
            f_err = torch.zeros_like(f)
        stale = False
        reconstructions += 1
        tr = tiles if np.any(alpha_h != 0.0) else 0
        tiles_streamed += tr
        obs.event("shrink_reconstruct", reason=reason, rounds=rounds,
                  pairs=pairs, tiles=tr)
        return tr

    def check_extrema() -> None:
        nonlocal b_hi, b_lo
        b_hi, b_lo = faults.poison_obs(b_hi, b_lo)
        chunks.check_obs_finite(b_hi, b_lo, pairs, pairs > start.pairs,
                                "ooc")

    dispatches = 0
    while True:
        # The span brackets the round; try/finally so a fault mid-round
        # cannot leave it (and its profiler annotation) open.
        span = obs.span("solver/ooc_round")
        span.__enter__()
        try:
            t0 = time.perf_counter()
            dispatches += 1
            faults.device_fault("dispatch", f"ooc round {rounds + 1}")
            round_hits = round_evicts = round_tiles = round_skipped = 0
            recon_tiles = 0
            all_hit = False
            recon_only = False
            live = 0

            # Cycle start: ONE selection of m over the full problem is the
            # exact global stopping test, the demotion decision and the next
            # active view.
            if shrink_live and active is None:
                _, (w_m, ok_m, b_hi, b_lo) = _ooc_select(
                    f, f_err, alpha, y_dev, None, c, shrink_m, config.selection)
                check_extrema()
                converged = not gap_open(b_hi, b_lo, eps_run)
                if converged or pairs >= max_iter:
                    train_seconds += time.perf_counter() - t0
                    break
                gap_now = b_lo - b_hi
                demote = None
                if gap_now <= _SHRINK_DEMOTE_EPS_MULT * eps_run:
                    demote = "near_eps"
                elif (last_cycle_gap is not None
                      and gap_now > _SHRINK_STALL_FACTOR * last_cycle_gap):
                    stall_streak += 1
                    if stall_streak >= _SHRINK_STALL_CYCLES:
                        demote = "stalled"
                else:
                    stall_streak = 0
                if demote is None:
                    active_np, live_tiles = shrink_view(w_m, ok_m, n, n, tile)
                    if live_tiles.size >= tiles:
                        demote = "full_view"  # a cycle would stream it all
                if demote is not None:
                    shrink_live = False
                    shrink_demoted = True
                    obs.event("shrink_demote", reason=demote, rounds=rounds,
                              pairs=pairs, gap=gap_now)
                else:
                    last_cycle_gap = gap_now
                    active = torch.as_tensor(active_np, device=dev)
                    live_list = [int(i) for i in live_tiles]
                    cycle_rounds = 0
                    shrink_cycles += 1

            in_cycle = shrink_live and active is not None
            (w, slot_ok, bh_t, bl_t), (w_np, ok_np, b_hi, b_lo) = _ooc_select(
                f, f_err, alpha, y_dev, active if in_cycle else None, c, q,
                config.selection)
            check_extrema()
            closed = not gap_open(b_hi, b_lo, eps_run)
            if not in_cycle:
                converged = closed
                if converged or pairs >= max_iter:
                    train_seconds += time.perf_counter() - t0
                    break
            else:
                # In-cycle extrema are the view's: they steer the view, never
                # the stopping test.
                converged = False
                if pairs >= max_iter:
                    if stale:
                        recon_tiles += reconstruct("budget")
                    active = None
                    train_seconds += time.perf_counter() - t0
                    break
                if closed:
                    if stale:
                        recon_tiles += reconstruct("view_converged")
                    active = None
                    recon_only = True

            in_cycle = in_cycle and not recon_only
            if not recon_only:
                live = int(ok_np.sum())
                stamp = rounds + 1
                if use_cache:
                    hit_np, slot_np = probe_rows(cache.keys, w_np, ok_np)
                    all_hit = live > 0 and bool(np.all(hit_np[ok_np]))
                if all_hit:
                    f, f_err, alpha, t_d = _ooc_round_cached(
                        cache, slot_np, ok_np, w, slot_ok, f, f_err, alpha,
                        y_dev, x_sq, k_diag, bh_t, bl_t, max_iter - pairs,
                        stamp, sub)
                    round_hits = live
                    cached_rounds += 1
                else:
                    qx = host_rows(x, w_np, dev, dtype)
                    scal = _ws_scalars(w, f if f_err is None else f - f_err,
                                       alpha, y_dev, x_sq, k_diag)
                    a_w, coef, t_d, qsq = _ooc_subproblem(
                        qx, w, slot_ok, scal, bh_t, bl_t, max_iter - pairs,
                        None, *sub)
                    # A shrunken round walks only the view's tiles; a skipped
                    # tile's f slice goes stale, and the cache is not
                    # refreshed (a partial dot row would poison it).
                    order = live_list if in_cycle else range(tiles)
                    want_dots = use_cache and not in_cycle
                    f, f_err, dots, round_tiles = _ooc_fold_stream(
                        stream, order, x_sq, f, f_err, qx, qsq, coef, kp,
                        want_dots)
                    round_skipped = tiles - round_tiles
                    if round_skipped:
                        stale = True
                        tiles_skipped += round_skipped
                        bytes_skipped += sum(stream.rows(i) for i in range(tiles)
                                             if i not in live_list) * d * 4
                    tiles_streamed += round_tiles
                    alpha = block.scatter_alpha(alpha, w, slot_ok, a_w)
                    if want_dots:
                        round_hits, round_evicts = refresh_rows(
                            cache, w_np, ok_np, torch.cat(dots, dim=1), stamp)
                pairs += int(t_d)
                rounds += 1
                if use_cache:
                    cache_lookups += live
                    cache_hits += round_hits
                    cache_evictions += round_evicts
                if in_cycle:
                    cycle_rounds += 1
                    if cycle_rounds >= _SHRINK_CYCLE_ROUNDS:
                        # Close the cycle: the next round re-derives the view
                        # from an exact gradient (and a checkpoint can land).
                        if stale:
                            recon_tiles += reconstruct("cadence")
                        active = None
            round_dt = time.perf_counter() - t0
            train_seconds += round_dt
        finally:
            span.__exit__(None, None, None)

        t_obs = time.perf_counter()
        if in_cycle:
            tiles_in_cycle += round_tiles + recon_tiles
        if obs.live:
            obs.chunk(pairs=pairs, b_hi=b_hi, b_lo=b_lo,
                      device_seconds=round_dt, dispatch=dispatches,
                      tiles=round_tiles + recon_tiles,
                      cached_round=bool(all_hit), cache_hits=round_hits,
                      tiles_skipped=round_skipped, shrink_active=bool(in_cycle))
        abort = False
        if callback is not None:
            abort = bool(callback(pairs, b_hi, b_lo,
                                  OocState(alpha, f, b_hi, b_lo, pairs,
                                           rounds, cache_hits)))
        if config.check_numerics:
            chunks.assert_finite_state(((f,), (alpha,)), pairs, "ooc")
        if abort and shrink_live and active is not None:
            # Abort mid-cycle: nothing stale may reach the checkpoint or
            # the result.
            if stale:
                reconstruct("abort")
            active = None
        if ((ckpt.due(pairs) or (abort and ckpt.active))
                and (not shrink_live or active is None)):
            # The RAW f with its residual (the compensated resume goes on
            # with the same Kahan bits) and the shrink keys.
            ckpt.save(pairs, alpha.cpu().numpy(), f.cpu().numpy(), b_hi,
                      b_lo, force=True,
                      f_err=None if f_err is None else f_err.cpu().numpy(),
                      rounds=rounds,
                      shrink_demoted=shrink_demoted if use_shrink else None,
                      shrink_gap=last_cycle_gap,
                      shrink_stall=stall_streak if use_shrink else None)
        if config.verbose:
            print(f"[ooc] round={rounds} pairs={pairs} "
                  f"gap={b_lo - b_hi:.6f} tiles={round_tiles} "
                  f"skip={round_skipped} hits={round_hits}", flush=True)
        phase_seconds["observe"] += time.perf_counter() - t_obs
        if abort:
            break

    t_fin = time.perf_counter()
    alpha_np = alpha.cpu().numpy()
    f_final = (f if f_err is None else f - f_err).cpu().numpy()
    if not converged:
        b_hi, b_lo, converged = refresh_extrema_host(
            f_final, alpha_np, y_np, c, config.epsilon, rule=config.selection)
    phase_seconds["solve"] = train_seconds
    phase_seconds["finalize"] = time.perf_counter() - t_fin
    stats = {
        "f": f_final, "outer_rounds": rounds, "device": str(dev),
        "n_pad": n, "ooc": True, "ooc_tile_rows": tile,
        "tiles_streamed": tiles_streamed, "tile_bytes_h2d": stream.bytes - setup_bytes,
        "cached_rounds": cached_rounds, "cache_hits": cache_hits,
        "cache_lookups": cache_lookups,
        "cache_hit_rate": (cache_hits / cache_lookups
                           if cache_lookups else 0.0),
        "cache_evictions": cache_evictions, "phase_seconds": phase_seconds,
        "ooc_shrink": use_shrink,
    }
    if use_shrink:
        stats.update(
            shrink_m=shrink_m, shrink_cycles=shrink_cycles,
            shrink_reconstructions=reconstructions,
            shrink_demoted=shrink_demoted, tiles_skipped=tiles_skipped,
            tile_bytes_skipped=bytes_skipped,
            shrink_tiles_in_cycle=tiles_in_cycle,
            shrink_active_fraction=round(min(1.0, shrink_m / max(n, 1)), 6))
    stats.update(autotune_embed())
    if start.resumed:
        stats["resumed_from"] = start.pairs
        stats["cache_cold_restart"] = use_cache
    res = SolveResult(
        alpha=alpha_np, b=float((b_lo + b_hi) / 2.0), b_hi=b_hi, b_lo=b_lo,
        iterations=pairs, converged=converged, train_seconds=train_seconds,
        stats=stats, dispatches=dispatches)
    chunks.finish_run_obs(
        obs, res, dispatches,
        **{k: stats[k] for k in (
            "tiles_streamed", "tile_bytes_h2d", "cached_rounds",
            "cache_hits", "cache_lookups", "cache_evictions", "ooc_shrink",
            "shrink_reconstructions", "shrink_demoted",
            "shrink_active_fraction", "tiles_skipped",
            "tile_bytes_skipped") if k in stats},
        cache_hit_rate=round(stats["cache_hit_rate"], 6))
    return res



# ---------------------------------------------------------------------
# The out-of-core mesh stream (the JAX package's solve_ooc_mesh).


class MeshTileStream:
    """Host X streamed to the shards of a mesh: stream step j carries
    tile j of every shard (shard r's rows [r n_loc + j tile, + tile),
    clipped at n). A process streams its own ranks only: on a mesh that
    spans processes, local position i holds global rank
    ``mesh.local_ranks[i]``.

    ``walk(steps)`` yields (j, tiles) with tiles[i] = (x_tile, rows): local
    position i's real rows on its device in the storage dtype (None where
    a shard has no real row in the step), valid until the next step. On
    CUDA a step's L local tiles are copied into one of two pinned
    (L tile, d) blocks, laid out device by device, and uploaded once per
    distinct device on that device's side stream; the compute streams
    wait on the upload's event, and a pinned block and its device twins
    are rewritten only after the events recorded behind the folds that
    read them, so the host's copy of step j+1 overlaps the upload and
    folds of step j and nothing synchronizes the device. The
    ``ooc_tile_put`` seam fires before each step while `seam` is set.
    `bytes` and `tiles` count the float32 bytes and the tiles of real
    rows this process uploaded; `job_bytes` and `job_tiles` those of
    every process of the job (the same numbers in one process)."""

    def __init__(self, x, n: int, d: int, tile: int, n_loc: int, mesh,
                 dtype: str = "float32"):
        self.x, self.n, self.d, self.tile, self.n_loc = x, n, d, tile, n_loc
        self.mesh = mesh
        self.ranks = mesh.local_ranks  # local position -> global rank
        self.dtype = _tdtype(dtype)
        self.bytes = self.tiles = self.job_bytes = self.job_tiles = 0
        self.seam = True
        self.cuda = mesh.devices[0].type == "cuda"
        # Local position i's row offset in the pinned block: device by
        # device.
        self.offset = [0] * len(mesh.devices)
        pos = 0
        self.group_rows = []
        for _, positions in mesh.groups:
            self.group_rows.append(pos * tile)
            for i in positions:
                self.offset[i] = pos * tile
                pos += 1
        if self.cuda:
            self.pinned = [torch.empty((len(mesh.devices) * tile, d),
                                       dtype=torch.float32, pin_memory=True)
                           for _ in range(2)]
            self.staged = [[torch.empty((len(positions) * tile, d),
                                        dtype=torch.float32, device=dev)
                            for dev, positions in mesh.groups]
                           for _ in range(2)]
            self.copier = [torch.cuda.Stream(device=dev)
                           for dev, _ in mesh.groups]
            self.copied = [None, None]
            self.released = [None, None]

    def shard_rows(self, r: int, j: int) -> int:
        """Global rank r's real rows in step j."""
        s = r * self.n_loc + j * self.tile
        return max(0, min(self.tile, self.n - s))

    def _count(self, j: int) -> None:
        """Step j's uploads: this process's and the job's."""
        for r in range(self.mesh.size):
            rows = self.shard_rows(r, j)
            if rows:
                self.job_tiles += 1
                self.job_bytes += rows * self.d * 4
                if r in self.ranks:
                    self.tiles += 1
                    self.bytes += rows * self.d * 4

    def _host(self, r: int, j: int, rows: int) -> np.ndarray:
        s = r * self.n_loc + j * self.tile
        return self.x[s:s + rows]

    def _seam(self, j: int) -> None:
        if self.seam:
            faults.device_fault(
                "ooc_tile_put", f"mesh stream step {j} (tile rows/device "
                f"[{j * self.tile}, {(j + 1) * self.tile}))")

    def _stage(self, slot: int, j: int) -> None:
        """Copy step j's tiles into pinned block `slot` and queue one
        upload per device."""
        self._seam(j)
        done = self.released[slot]
        if done is not None:
            for ev in done:
                ev.synchronize()  # the folds that read this slot have run
        pin = self.pinned[slot].numpy()
        for i, r in enumerate(self.ranks):
            rows = self.shard_rows(r, j)
            if rows:
                o = self.offset[i]
                np.copyto(pin[o:o + rows], self._host(r, j, rows),
                          casting="same_kind")
        events = []
        for g, (dev, positions) in enumerate(self.mesh.groups):
            # A group's real rows are a prefix of its slice: full tiles,
            # then at most one partial tile, then empty ones.
            cnt = sum(self.shard_rows(self.ranks[i], j) for i in positions)
            with torch.cuda.stream(self.copier[g]):
                if done is not None:
                    self.copier[g].wait_event(done[g])
                if cnt:
                    o = self.group_rows[g]
                    self.staged[slot][g][:cnt].copy_(
                        self.pinned[slot][o:o + cnt], non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(self.copier[g])
            events.append(ev)
        self.copied[slot] = events
        self._count(j)

    def walk(self, steps):
        steps = list(steps)
        mesh = self.mesh
        if not self.cuda:
            for j in steps:
                self._seam(j)
                tiles = []
                for r, dev in zip(self.ranks, mesh.devices):
                    rows = self.shard_rows(r, j)
                    if not rows:
                        tiles.append((None, 0))
                        continue
                    blk = _tile_host(self.x, r * self.n_loc + j * self.tile,
                                     rows, self.n, self.d)
                    if not blk.flags.writeable:  # a read-only memmap's view
                        blk = blk.copy()
                    tiles.append((torch.from_numpy(blk).to(dev).to(
                        self.dtype), rows))
                self._count(j)
                yield j, tiles
            return
        if not steps:
            return
        compute = [torch.cuda.current_stream(dev) for dev, _ in mesh.groups]
        self._stage(0, steps[0])
        for k, j in enumerate(steps):
            slot = k % 2
            if k + 1 < len(steps):
                self._stage(slot ^ 1, steps[k + 1])
            for g in range(len(mesh.groups)):
                compute[g].wait_event(self.copied[slot][g])
            tiles = []
            for i, r in enumerate(self.ranks):
                rows = self.shard_rows(r, j)
                if not rows:
                    tiles.append((None, 0))
                    continue
                g = mesh.group_of[i]
                o = self.offset[i] - self.group_rows[g]
                tiles.append((self.staged[slot][g][o:o + rows].to(self.dtype),
                              rows))
            yield j, tiles
            events = []
            for g in range(len(mesh.groups)):
                ev = torch.cuda.Event()
                ev.record(compute[g])
                events.append(ev)
            self.released[slot] = events


class TileStream(MeshTileStream):
    """Host X streamed to one device in (tile, d) tiles: the mesh stream
    of a one-shard mesh, whose step i is tile i. ``walk(order)`` yields
    (i, x_tile, rows) for each tile index in `order` (any order, the
    shrunken stream's view included)."""

    def __init__(self, x, n: int, d: int, tile: int, dev: torch.device,
                 dtype: str = "float32"):
        from dpsvm_tpu_torch.parallel.mesh import Mesh

        super().__init__(x, n, d, tile, -(-n // tile) * tile, Mesh([dev]),
                         dtype)

    def rows(self, i: int) -> int:
        return self.shard_rows(0, i)

    def _seam(self, i: int) -> None:
        if self.seam:
            s = i * self.tile
            faults.device_fault("ooc_tile_put",
                                f"tile rows [{s}, {s + self.rows(i)})")

    def walk(self, order):
        for i, tiles in super().walk(order):
            xt, rows = tiles[0]
            yield i, xt, rows


_MESH_CACHE_REFUSAL = (
    "ooc_cache_lines with backend='mesh' is not implemented: the (L, n) "
    "kernel-row cache is a single-chip HBM structure — drop "
    "ooc_cache_lines, or use backend='single'")
_MESH_SHRINK_REFUSAL = (
    "the shrunken tile stream (active_set_size / ooc_shrink) is "
    "single-chip: the live-tile skip is host bookkeeping over one stream "
    "— drop it, or use backend='single'")


def solve_ooc_mesh(x, y, config: SVMConfig, num_devices=None, mesh=None,
                   callback=None, checkpoint_path=None, resume: bool = False,
                   alpha_init=None, f_init=None,
                   warm_start=None) -> SolveResult:
    """Out-of-core training over the mesh's shards (backend="mesh" with
    config.ooc; solve_mesh routes here): X stays on the host (an
    np.ndarray or np.memmap, never copied whole) and each shard streams
    its own row tiles (MeshTileStream). `mesh=None` takes the visible
    CUDA cards (the first `num_devices`) and raises without one;
    ``Mesh([torch.device("cuda:0")] * 4)`` runs four logical shards of
    one card, ``Mesh(["cpu"] * 2)`` the plain path.

    The result contract is solve_ooc's; checkpoints are its v2 files,
    gathered to the host, so a file of either package and of either
    stream resumes here and back. `warm_start` is repaired and its
    gradient rebuilt by one streamed pass on the mesh's first device,
    then passed on as alpha_init / f_init. A transient fault is retried
    (config.retry_faults) from this run's last checkpoint. The block
    cache and the shrunken stream are single-device: refused with
    ValueError, as in the JAX package.

    On a mesh that spans processes every process streams its own ranks'
    tiles from its own host X, computes the same round from the same
    gathered candidates, and gets the same result; checkpoints and the
    run log come from process 0, `tiles_streamed` / `tile_bytes_h2d`
    count the job's uploads (`process_tiles_streamed` /
    `process_tile_bytes_h2d` this process's), and in-process fault retry
    is off, as in solve_mesh."""
    if config.ooc_cache_lines:
        raise ValueError(_MESH_CACHE_REFUSAL)
    if config.active_set_size or config.ooc_shrink:
        raise ValueError(_MESH_SHRINK_REFUSAL)
    config.check_ported()
    if mesh is None:
        from dpsvm_tpu_torch.parallel.mesh import make_data_mesh

        mesh = make_data_mesh(num_devices)
    if warm_start is not None:
        if alpha_init is not None or f_init is not None:
            raise ValueError(
                "pass either warm_start or alpha_init/f_init, not both")
        from dpsvm_tpu_torch.solver.warmstart import prepare_warm_start

        a0, f0, wstats = prepare_warm_start(x, y, config, warm_start,
                                            device=mesh.devices[0])
        res = solve_ooc_mesh(x, y, config, mesh=mesh, callback=callback,
                             checkpoint_path=checkpoint_path, resume=resume,
                             alpha_init=a0, f_init=f0)
        res.stats["warm_start"] = wstats
        return res
    for dev, _ in mesh.groups:
        resolve_device(dev)  # raises without CUDA; the float32 policy

    def attempt(cfg_k, res_k, _k):
        return _solve_ooc_mesh_impl(x, y, cfg_k, mesh, callback,
                                    checkpoint_path, res_k, alpha_init,
                                    f_init)

    if mesh.num_processes > 1:
        # As solve_mesh: across processes the recovery is a relaunch with
        # --resume, not an in-process retry.
        from dpsvm_tpu_torch.parallel.dist_smo import (
            _warn_multihost_retry_dropped)

        _warn_multihost_retry_dropped(config, mesh.num_processes)
        config = config.replace(retry_faults=0)
    with precision_ctx(config):
        return run_with_fault_retry(config, checkpoint_path, resume, attempt)


def _solve_ooc_mesh_impl(x, y, config: SVMConfig, mesh, callback,
                         checkpoint_path, resume, alpha_init,
                         f_init) -> SolveResult:
    from dpsvm_tpu_torch.parallel.dist_block import (ooc_mesh_fold,
                                                     ooc_mesh_norms,
                                                     ooc_mesh_scatter,
                                                     ooc_mesh_select)
    from dpsvm_tpu_torch.parallel.mesh import unshard

    t_entry = time.perf_counter()
    y_np = np.asarray(y, np.int32)
    n, d = x.shape
    kp = KernelParams(config.kernel, config.resolve_gamma(d), config.degree,
                      config.coef0)
    dtype = config.dtype
    if dtype == "bfloat16":
        warn_if_bf16_degrades(np.asarray(x[:min(n, 4096)], np.float32),
                              config)
    n_dev = mesh.size
    # Process 0 of a job writes the run log and the verbose lines.
    lead = mesh.process_index == 0
    # Every shard a whole number of stream tiles.
    tile = min(int(config.ooc_tile_rows), n)
    n_loc = -(-n // (n_dev * tile)) * tile
    n_pad = n_dev * n_loc
    steps = n_loc // tile
    # h = q/2 candidates a side must fit a shard's rows.
    q = max(2, min(config.working_set_size, 2 * n_loc))
    q -= q % 2
    inner = config.inner_iters or 2 * q
    c = config.c_bounds()
    eps_run = _BUDGET_EPS if config.budget_mode else float(config.epsilon)
    max_iter = int(config.max_iter)
    sub = (kp, c, eps_run, float(config.tau), inner, config.selection,
           int(config.pair_batch))

    def shard(arr, dt=torch.float32):
        return [torch.as_tensor(arr[r * n_loc:(r + 1) * n_loc],
                                device=dev).to(dt)
                for r, dev in zip(mesh.local_ranks, mesh.devices)]

    y_p = np.ones((n_pad,), np.float32)
    y_p[:n] = y_np
    valid_p = np.zeros((n_pad,), bool)
    valid_p[:n] = True
    y_sh = shard(y_p)
    valid_sh = shard(valid_p, torch.bool)

    obs = chunks.open_run_obs(
        "solve", config,
        {"n": n, "d": d, "n_pad": n_pad, "engine": config.engine,
         "kernel": config.kernel, "selection": config.selection,
         "ooc": True, "ooc_mesh": True, "devices": n_dev,
         "mesh_devices": mesh.describe(), "ooc_tile_rows": tile,
         "ooc_tiles": steps * n_dev, "ooc_cache_lines": 0,
         "ooc_shrink": False, "shrink_m": 0}, list(mesh.devices),
        write=lead)

    stream = MeshTileStream(x, n, d, tile, n_loc, mesh, dtype)
    with obs.span("solver/ooc_setup_stream"):
        x_sq = [torch.zeros(n_loc, dtype=torch.float32, device=dev)
                for dev in mesh.devices]
        for j, tiles in stream.walk(range(steps)):
            ooc_mesh_norms(tiles, j, tile, x_sq)
        k_diag = [kernel_diag(s, kp) for s in x_sq]
    setup = (stream.tiles, stream.bytes, stream.job_bytes)

    start = chunks.start_state(y_np, config, checkpoint_path, resume,
                               alpha_init, f_init)
    if start.resumed:
        obs.event("resume", iteration=start.pairs, rounds=start.rounds,
                  ooc_mesh=True)
    a0, f0, e0 = start.padded(n_pad)
    alpha = shard(a0)
    f = shard(f0)
    f_err = None if e0 is None else shard(e0)

    ckpt = PeriodicCheckpointer(checkpoint_path, config, start.pairs)
    if callback is not None and hasattr(callback, "on_start"):
        callback.on_start(start.pairs)
    mesh.synchronize()
    ex0 = (mesh.exchanges, mesh.exchange_seconds)
    pairs, rounds = start.pairs, start.rounds
    tiles_streamed = dispatches = 0
    b_hi, b_lo = -np.inf, np.inf
    converged = False
    train_seconds = 0.0
    phase_seconds = {"setup": time.perf_counter() - t_entry, "solve": 0.0,
                     "observe": 0.0, "finalize": 0.0}
    groups = mesh.groups

    while True:
        span = obs.span("solver/ooc_round")
        span.__enter__()
        try:
            t0 = time.perf_counter()
            round_tiles = 0
            dispatches += 1
            faults.device_fault("dispatch", f"ooc mesh round {rounds + 1}")
            sel, owners = ooc_mesh_select(mesh, f, f_err, alpha, y_sh, x_sq,
                                          k_diag, valid_sh, c, q,
                                          config.selection)
            # The round's one host read: W, its live slots, the extrema.
            w0, ok0, bh0, bl0, _ = sel[0]
            packed = torch.cat([w0.to(torch.int32), ok0.to(torch.int32),
                                torch.stack([bh0, bl0]).float().view(
                                    torch.int32)])
            host = packed.cpu().numpy()
            b_hi, b_lo = (float(v) for v in host[2 * q:].view(np.float32))
            b_hi, b_lo = faults.poison_obs(b_hi, b_lo)
            chunks.check_obs_finite(b_hi, b_lo, pairs, pairs > start.pairs,
                                    "ooc")
            converged = not gap_open(b_hi, b_lo, eps_run)
            if converged or pairs >= max_iter:
                train_seconds += time.perf_counter() - t0
                break
            # The working set's rows, gathered once on the host by global
            # id (dead slots may name pad rows: clipped) and uploaded once
            # to each device.
            w_np = np.clip(host[:q].astype(np.int64), 0, n - 1)
            rows_np = np.ascontiguousarray(np.asarray(x[w_np], np.float32))
            rows_t = torch.from_numpy(rows_np)
            core = []
            for g, (dev, _) in enumerate(groups):
                w, slot_ok, bh_t, bl_t, scal = sel[g]
                qx = rows_t.to(dev).to(_tdtype(dtype))
                core.append((qx, *_ooc_subproblem(
                    qx, w, slot_ok, scal, bh_t, bl_t, max_iter - pairs,
                    None, *sub)))
            qx = [cr[0] for cr in core]
            coef = [cr[2] for cr in core]
            qsq = [cr[4] for cr in core]
            job_tiles = stream.job_tiles
            for j, tiles in stream.walk(range(steps)):
                ooc_mesh_fold(mesh, tiles, j, tile, x_sq, f, f_err, qx, qsq,
                              coef, kp)
            round_tiles = stream.job_tiles - job_tiles
            alpha = ooc_mesh_scatter(mesh, alpha, owners,
                                     [cr[1] for cr in core])
            pairs += int(core[0][3])
            rounds += 1
            tiles_streamed += round_tiles
            round_dt = time.perf_counter() - t0
            train_seconds += round_dt
        finally:
            span.__exit__(None, None, None)

        t_obs = time.perf_counter()
        if obs.live:
            obs.chunk(pairs=pairs, b_hi=b_hi, b_lo=b_lo,
                      device_seconds=round_dt, dispatch=dispatches,
                      tiles=round_tiles)
        abort = False
        if callback is not None:
            abort = bool(callback(pairs, b_hi, b_lo,
                                  OocState(alpha, f, b_hi, b_lo, pairs,
                                           rounds, 0)))
        if config.check_numerics:
            chunks.assert_finite_state((f, alpha), pairs, "ooc")
        if ckpt.due(pairs) or (abort and ckpt.active):
            # The one-device stream's v2 file, gathered to the host (a
            # collective: `pairs` is the same in every process): the raw
            # f with its residual.
            ckpt.save(pairs, unshard(alpha, mesh)[:n], unshard(f, mesh)[:n],
                      b_hi, b_lo, force=True,
                      f_err=(None if f_err is None
                             else unshard(f_err, mesh)[:n]),
                      rounds=rounds)
        if config.verbose and lead:
            print(f"[ooc-mesh] round={rounds} pairs={pairs} "
                  f"gap={b_lo - b_hi:.6f} tiles={round_tiles} "
                  f"devices={n_dev}", flush=True)
        phase_seconds["observe"] += time.perf_counter() - t_obs
        if abort:
            break

    t_fin = time.perf_counter()
    alpha_np = unshard(alpha, mesh)[:n]
    f_eff = f if f_err is None else [a - b for a, b in zip(f, f_err)]
    f_final = unshard(f_eff, mesh)[:n]
    if not converged:
        b_hi, b_lo, converged = refresh_extrema_host(
            f_final, alpha_np, y_np, c, config.epsilon, rule=config.selection)
    phase_seconds["solve"] = train_seconds
    phase_seconds["finalize"] = time.perf_counter() - t_fin
    stats = {
        "f": f_final, "outer_rounds": rounds, "device": str(mesh.devices[0]),
        "n_pad": n_pad, "ooc": True, "ooc_mesh": True, "ooc_devices": n_dev,
        "num_devices": n_dev, "mesh_devices": mesh.describe(),
        "ooc_tile_rows": tile, "ooc_tiles": steps * n_dev,
        "tiles_streamed": tiles_streamed,
        "tile_bytes_h2d": stream.job_bytes - setup[2], "cached_rounds": 0,
        "cache_hits": 0, "cache_lookups": 0, "cache_hit_rate": 0.0,
        "cache_evictions": 0, "phase_seconds": phase_seconds,
        "ooc_shrink": False,
    }
    if mesh.num_processes > 1:
        # The job's totals above; this process's own uploads beside them.
        stats.update(num_processes=mesh.num_processes,
                     process_backend=mesh.backend,
                     exchanges=mesh.exchanges - ex0[0],
                     exchange_seconds=mesh.exchange_seconds - ex0[1],
                     process_tiles_streamed=stream.tiles - setup[0],
                     process_tile_bytes_h2d=stream.bytes - setup[1])
    if start.resumed:
        stats["resumed_from"] = start.pairs
    res = SolveResult(
        alpha=alpha_np, b=float((b_lo + b_hi) / 2.0), b_hi=b_hi, b_lo=b_lo,
        iterations=pairs, converged=converged, train_seconds=train_seconds,
        stats=stats, dispatches=dispatches)
    chunks.finish_run_obs(obs, res, dispatches,
                          tiles_streamed=tiles_streamed,
                          tile_bytes_h2d=stats["tile_bytes_h2d"],
                          ooc_mesh=True, devices=n_dev)
    return res
