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

The stream (TileStream). On the card a tile goes memmap or array ->
one of two pinned float32 buffers (a host copy into its NumPy view) ->
the device on a side stream, where an event marks the copy; the compute
stream waits on that event, casts to the storage dtype (bfloat16 rounds
to nearest even there, as on the host) and folds. A pinned buffer and
its device twin are rewritten only after the event recorded behind the
fold that read them has passed, so the host's copy of tile t+1 overlaps
the upload and fold of tile t and nothing calls torch.cuda.synchronize.
On the CPU the tiles are read in turn.

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

Not here: the mesh stream (solve_ooc_mesh, ROADMAP queue A item 10b),
the fault retry and the ``ooc_tile_put`` / ``dispatch`` fault seams and
the run-log events (item 11).
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
from dpsvm_tpu_torch.solver.smo import gap_open, maybe_kahan
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


class TileStream:
    """Host X streamed to the device in (tile, d) tiles.

    ``walk(order)`` yields (i, x_tile, rows) for each tile index in
    `order`: x_tile is tile i's `rows` real rows on the device in the
    storage dtype, valid until the next step of the walk. On CUDA tile
    t+1 is copied into the other pinned buffer and uploaded on a side
    stream while the caller folds tile t (the double buffer); `bytes`
    counts what crossed to the device."""

    def __init__(self, x, n: int, d: int, tile: int, dev: torch.device,
                 dtype: str = "float32"):
        self.x, self.n, self.d, self.tile = x, n, d, tile
        self.dev = dev
        self.dtype = _tdtype(dtype)
        self.bytes = 0
        self.cuda = dev.type == "cuda"
        if self.cuda:
            self.pinned = [torch.empty((tile, d), dtype=torch.float32,
                                       pin_memory=True) for _ in range(2)]
            self.staged = [torch.empty((tile, d), dtype=torch.float32,
                                       device=dev) for _ in range(2)]
            self.copier = torch.cuda.Stream(device=dev)
            self.copied = [None, None]
            self.released = [None, None]

    def rows(self, i: int) -> int:
        return min(self.tile, self.n - i * self.tile)

    def _stage(self, slot: int, i: int) -> None:
        """Copy tile i into pinned buffer `slot` and queue its upload."""
        rows = self.rows(i)
        s = i * self.tile
        done = self.released[slot]
        if done is not None:
            done.synchronize()  # the fold that read this slot has run
        np.copyto(self.pinned[slot].numpy()[:rows], self.x[s:s + rows],
                  casting="same_kind")
        with torch.cuda.stream(self.copier):
            if done is not None:
                self.copier.wait_event(done)
            self.staged[slot][:rows].copy_(self.pinned[slot][:rows],
                                           non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.copier)
        self.copied[slot] = ev
        self.bytes += rows * self.d * 4

    def walk(self, order):
        order = list(order)
        if not self.cuda:
            for i in order:
                rows = self.rows(i)
                blk = _tile_host(self.x, i * self.tile, self.tile, self.n,
                                 self.d)[:rows]
                if not blk.flags.writeable:  # a read-only memmap's view
                    blk = blk.copy()
                self.bytes += rows * self.d * 4
                yield i, torch.from_numpy(blk).to(self.dtype), rows
            return
        if not order:
            return
        compute = torch.cuda.current_stream(self.dev)
        self._stage(0, order[0])
        for k, i in enumerate(order):
            slot = k % 2
            if k + 1 < len(order):
                self._stage(slot ^ 1, order[k + 1])
            compute.wait_event(self.copied[slot])
            rows = self.rows(i)
            yield i, self.staged[slot][:rows].to(self.dtype), rows
            ev = torch.cuda.Event()
            ev.record(compute)
            self.released[slot] = ev


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
    shape to bucket for)."""
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
    with precision_ctx(config):
        return _solve_ooc_impl(x, y, config, callback, resolve_device(device),
                               checkpoint_path, resume, alpha_init, f_init)


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


def _ooc_subproblem(qx, w, slot_ok, f_cur, alpha, y, x_sq, k_diag, b_hi_t,
                b_lo_t, budget_left: int, kb_w, kp, c, eps: float,
                tau: float, inner: int, selection: str, pair_batch: int):
    """The round's subproblem (the in-core gather_block + limit +
    dispatch_subproblem, kernel B1 on the card): (a_w, coef, t, qsq).
    `kb_w` is the Gram block when the caller has it (an all-hit round
    reads it from the cache), else it is built from `qx`."""
    qsq = x_sq[w]
    if kb_w is None:
        kb_w = block.gram_block(qx, qsq, w, kp)
    budget = torch.tensor(budget_left, dtype=torch.int32, device=y.device)
    limit = torch.clamp(budget, max=inner)
    limit = torch.where(b_lo_t > b_hi_t + 2.0 * eps, limit, 0).to(
        torch.int32)
    a_w, coef, t = block.dispatch_subproblem(
        kb_w, k_diag[w], slot_ok, alpha[w], y[w], f_cur[w], c, eps, tau,
        limit, selection, pair_batch)
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
    a_w, coef, t, qsq = _ooc_subproblem(
        None, w, slot_ok, f if f_err is None else f - f_err, alpha, y, x_sq,
        k_diag, b_hi_t, b_lo_t, budget_left, kb_w, *sub)
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
    # view; ooc_shrink=True asks for the auto-sized view; None is the
    # JAX package's no-profile gate, off (no H100 measurement decides
    # it yet). The auto view is sized on the whole tiles' rows, as the
    # JAX package sizes it on its padded rows.
    if config.active_set_size:
        use_shrink, shrink_m = True, int(config.active_set_size)
    else:
        use_shrink, shrink_m = bool(config.ooc_shrink), 0
    if use_shrink:
        rows_pad = tiles * tile
        if shrink_m <= 0:
            shrink_m = max(4 * q, rows_pad // 8)
        shrink_m = max(q, min(shrink_m, rows_pad))
        shrink_m -= shrink_m % 2

    y_dev = torch.as_tensor(y_np.astype(np.float32), device=dev)
    stream = TileStream(x, n, d, tile, dev, dtype)
    # The setup pass: the squared norms of the STORED rows, tile by tile
    # (a row's reduction is the in-core squared_norms', so x_sq is the
    # same bits).
    x_sq = torch.empty(n, dtype=torch.float32, device=dev)
    for i, xt, rows in stream.walk(range(tiles)):
        x_sq[i * tile:i * tile + rows] = squared_norms(xt)
    k_diag = kernel_diag(x_sq, kp)
    setup_bytes = stream.bytes  # the stream counters leave the setup out

    start = chunks.start_state(y_np, config, checkpoint_path, resume,
                               alpha_init, f_init)
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

    def reconstruct() -> int:
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
        return tr

    def check_extrema() -> None:
        chunks.check_obs_finite(b_hi, b_lo, pairs, pairs > start.pairs,
                                "ooc")

    while True:
        t0 = time.perf_counter()
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
                    recon_tiles += reconstruct()
                active = None
                train_seconds += time.perf_counter() - t0
                break
            if closed:
                if stale:
                    recon_tiles += reconstruct()
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
                a_w, coef, t_d, qsq = _ooc_subproblem(
                    qx, w, slot_ok, f if f_err is None else f - f_err, alpha, y_dev, x_sq, k_diag,
                    bh_t, bl_t, max_iter - pairs, None, *sub)
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
                        recon_tiles += reconstruct()
                    active = None
        train_seconds += time.perf_counter() - t0

        t_obs = time.perf_counter()
        if in_cycle:
            tiles_in_cycle += round_tiles + recon_tiles
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
                reconstruct()
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
    if start.resumed:
        stats["resumed_from"] = start.pairs
        stats["cache_cold_restart"] = use_cache
    return SolveResult(
        alpha=alpha_np, b=float((b_lo + b_hi) / 2.0), b_hi=b_hi, b_lo=b_lo,
        iterations=pairs, converged=converged, train_seconds=train_seconds,
        stats=stats)

