"""Distributed SMO over the data mesh (counterpart of
dpsvm_tpu/parallel/dist_smo.py: ``solve_mesh``, ``_solve_mesh_impl`` and
the per-pair mesh engine).

Everything row-indexed is sharded over the mesh's ranks: X, y, f, alpha
(and the per-pair engine's row cache). Shards are equal by construction:
rows are padded to a multiple of the shard count (of 1024 a shard for
the fused-fold runner) and masked out of selection. One Python process
drives its shards (parallel/mesh.py): all of them, or, on a mesh that
spans processes (initialize_multihost), its contiguous block of ranks,
with every collective exchanged across the processes. Every process runs
the same solve on the same data and holds the same replicated state, so
the trajectory is bit for bit that of one process driving all P ranks.
Across processes the checkpoint and the run log are written by process
0 from the gathered state, in-process fault retry is off (a faulted
process cannot re-sync its peers' collectives: the job is relaunched
with --resume), the out-of-core mesh stream streams each process's own
ranks' tiles, the warm rebuild folds each process's own shards, and the
ring exchange is refused (ROADMAP item 6).

Engines: engine="xla" runs the per-pair mesh engine below; engine="block"
the block runners of parallel/dist_block.py, chosen with the JAX
package's precedence: the active-set runner when active_set_size > 0,
else the shard-local runner (local_working_sets >= 2), then the
pipelined runner (pipeline_rounds), then the fused fold (fused_fold),
else the global runner. fused_round=True is a single-device knob: the
mesh warns and keeps its own choice. The nu rule runs on the global,
active and per-pair engines; the other runners leave it to the global
one, as in the JAX package.

The solve is observed chunk by chunk as on one device
(solver/chunks.py): a callback, verbose, check_numerics and checkpoints
on every engine, with the same file as one device's (a one-device
checkpoint resumes on the mesh and back). Warm starts (alpha_init /
f_init, warm_start through the mesh rebuild of solver/warmstart.py) and
float64 reconstruction legs (solver/reconstruct.py solve_in_legs around
solve_mesh) run as in the JAX package.

The per-pair mesh engine (the JAX package's _iteration, _iteration_wss2
and the nu pair). Each trip selects the global pair from the P shards'
candidates ON THE DEVICE (lowest global id on ties), gathers its rows
and per-row scalars from the owning shard with masked sums (eta and the
squared norms come from the owner, so mesh and single-device
trajectories stay aligned), computes the kernel rows shard by shard and
updates f locally. No id leaves the device: the chunk runs through
solver/smo.py queue_trips as the single-device engines' chunks do, the
host reading (it, the stop flag, b_hi, b_lo) of the first device once
every smo.TRIPS trips, and a trip queued after the stop is masked: it
still calls every collective of a trip in every rank and every process
(each process stops at the same read of the same replicated values), and
changes nothing. The row cache is the sharded device form of
solver/cache.py (init_mesh_cache): each rank holds its columns of the
lines, each device one replicated copy of the keys and ticks, the slots
are decided on the device with the single-device rules, and kernel
cache_fill fills each shard's columns from the pair's query rows.

config.ooc routes to the out-of-core mesh stream (solver/ooc.py
solve_ooc_mesh). Every solve runs inside the fault retry and the
non-finite demotion (solver/smo.py run_with_fault_retry,
_solve_with_degradation) and writes a ``solve_mesh`` run log when obs is
on, with the ``shardlocal_demotion`` event.
"""

from __future__ import annotations

import time
import warnings
from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import torch

from dpsvm_tpu_torch.config import SVMConfig
from dpsvm_tpu_torch.device import precision_ctx, resolve_device
from dpsvm_tpu_torch.obs import NULL_OBS
from dpsvm_tpu_torch.ops.kernels import (KernelParams, kernel_diag,
                                         kernel_from_dots, row_dots,
                                         squared_norms,
                                         warn_if_bf16_degrades)
from dpsvm_tpu_torch.ops.select import (c_of, from_order_key, ieee_max,
                                        nu_stopping_pair, order_key,
                                        refresh_extrema_host, set_masks,
                                        split_c, take)
from dpsvm_tpu_torch.parallel.dist_block import (
    MeshBlockState, make_block_active_chunk_runner,
    make_block_chunk_runner, make_block_fused_chunk_runner,
    make_block_pipelined_chunk_runner, make_block_shardlocal_chunk_runner)
from dpsvm_tpu_torch.parallel.mesh import (Mesh, make_data_mesh, pad_rows,
                                           process_count, replicate_array,
                                           shard_padded_rows, unshard)
from dpsvm_tpu_torch.solver import chunks, smo
from dpsvm_tpu_torch.solver.block import autotune_gate_resolver, scatter_alpha
from dpsvm_tpu_torch.solver.cache import (MeshCacheState, init_mesh_cache,
                                          lookup_one_mesh, lookup_pair_mesh)
from dpsvm_tpu_torch.solver.result import SolveResult
from dpsvm_tpu_torch.solver.smo import (fma32, maybe_kahan,
                                        pair_alpha_update, read_obs,
                                        two_eps)
from dpsvm_tpu_torch.solver.solve import (_BUDGET_EPS, active_set_height,
                                          storage_dtype)
from dpsvm_tpu_torch.utils.checkpoint import PeriodicCheckpointer

# Shard-local chunks are bounded to this many sync windows: the host's
# endgame-demotion check reads the gap at chunk boundaries. Small enough
# that a stalled engine is demoted promptly; large enough that the check
# is amortized over thousands of pair updates.
_SHARDLOCAL_WINDOWS_PER_CHUNK = 8

# One-time flag of _warn_multihost_retry_dropped: a job of many solves
# (the model families' legs) warns once.
_WARNED_MULTIHOST_RETRY = False


def _warn_multihost_retry_dropped(config: SVMConfig, processes: int) -> None:
    """The JAX package's one-time notice that retry_faults was dropped:
    across processes a faulted process cannot re-sync its peers'
    collectives mid-job, so the recovery is a relaunch of the whole job
    with --resume against the same --checkpoint (written by process 0,
    readable by either package)."""
    global _WARNED_MULTIHOST_RETRY
    if _WARNED_MULTIHOST_RETRY or config.retry_faults <= 0:
        return
    _WARNED_MULTIHOST_RETRY = True
    warnings.warn(
        f"retry_faults={config.retry_faults} is disabled on this "
        f"{processes}-process job: a faulted process cannot re-sync its "
        "peers' collectives mid-job, so in-process retry cannot work "
        "across processes. Recovery procedure: run with --checkpoint "
        "PATH --checkpoint-every N, and on a fault RELAUNCH the whole "
        "job with --resume: training continues from the last "
        "checkpoint.", stacklevel=5)

_INF = float("inf")
_ID_MAX = 2 ** 62


# ---------------------------------------------------------------------
# The per-pair mesh engine.

class MeshPairState(NamedTuple):
    """The per-pair mesh loop's carry, all of it on the devices: alpha,
    f (and f_err) one tensor per rank; the carried extrema, the pair
    count and the cache hits one tensor per distinct device (replicated
    values); the sharded row cache (lines per rank, keys and ticks per
    device)."""

    alpha: list
    f: list
    b_hi: list
    b_lo: list
    it: list  # int32
    cache: Optional[MeshCacheState]
    hits: list  # 0-d int64
    f_err: Optional[list] = None


class _Lead(NamedTuple):
    """The first device's view of a MeshPairState: what queue_trips reads
    (its it, b_hi and b_lo; alpha names the device)."""

    alpha: torch.Tensor
    it: torch.Tensor
    b_hi: torch.Tensor
    b_lo: torch.Tensor


def _lead(st: MeshPairState) -> _Lead:
    return _Lead(st.alpha[0], st.it[0], st.b_hi[0], st.b_lo[0])


def _ieee_min(v: torch.Tensor) -> torch.Tensor:
    """min(v) as XLA reduces it: a +-0 tie gives -0.0."""
    return from_order_key(order_key(v).amin())


def _owner(i, rank: int, n_loc: int) -> tuple:
    """(own, l_safe (1,)): whether global row `i` (0-d) lives on shard
    `rank`, and its clipped local index."""
    l = i - rank * n_loc
    return (l >= 0) & (l < n_loc), l.clamp(0, n_loc - 1).reshape(1)


def _scalar_parts(vs, owners) -> list:
    """The terms of the owned entry of a row-sharded vector, replicated
    by a masked sum over the shards (the JAX package's _gather_scalar;
    + 0.0 turns a -0.0 into the +0.0 its reduction gives). Per local
    rank, 0-d."""
    return [torch.where(own, v.index_select(0, ls).reshape(()), 0.0) + 0.0
            for v, (own, ls) in zip(vs, owners)]


def _row_parts(x, owners) -> list:
    """The terms of the owned row of the row-sharded X as float32 (the
    JAX package's _gather_row). Per local rank, (d,)."""
    return [torch.where(own, xr.index_select(0, ls)[0].float(), 0.0) + 0.0
            for xr, (own, ls) in zip(x, owners)]


def _reduce_pair(g_vals, g_idx, col: int, take_min: bool):
    """The global extremum of one gathered candidate column and its
    lowest global id among equal values."""
    v = g_vals[:, col]
    best = _ieee_min(v) if take_min else ieee_max(v)
    return best, torch.where(v == best, g_idx[:, col], _ID_MAX).amin()


def _select_pair_mesh(mesh: Mesh, f, alpha, y, valid, c, rule: str):
    """The distributed maximal-violating pair (the JAX package's
    _select_global, or _select_global_nu under the nu rule): per shard
    the masked extrema and their global ids, one gather, the replicated
    reduction. Per group (i_hi, b_hi, i_lo, b_lo)."""
    vals, idx = [], []
    for i, r in enumerate(mesh.local_ranks):
        up, low = set_masks(alpha[i], y[i], c, valid[i])
        classes = ((y[i] > 0, y[i] <= 0) if rule == "nu" else (None,))
        v_r, i_r = [], []
        for cls in classes:
            u, lo = (up, low) if cls is None else (up & cls, low & cls)
            f_up = torch.where(u, f[i], _INF)
            f_low = torch.where(lo, f[i], -_INF)
            l_hi, l_lo = torch.argmin(f_up), torch.argmax(f_low)
            v_r += [take(f_up, l_hi), take(f_low, l_lo)]
            i_r += [l_hi, l_lo]
        off = r * f[i].shape[0]
        vals.append(torch.stack(v_r))
        idx.append(torch.stack(i_r) + off)
    out = []
    for g_vals, g_idx in zip(*mesh.all_gather_many(vals, idx)):
        bh, ih = _reduce_pair(g_vals, g_idx, 0, True)
        bl, il = _reduce_pair(g_vals, g_idx, 1, False)
        if rule == "nu":
            bh_n, ih_n = _reduce_pair(g_vals, g_idx, 2, True)
            bl_n, il_n = _reduce_pair(g_vals, g_idx, 3, False)
            take_p = (bl - bh) >= (bl_n - bh_n)
            ih, il = torch.where(take_p, ih, ih_n), torch.where(take_p, il,
                                                                il_n)
            bh, bl = nu_stopping_pair(bh, bl, bh_n, bl_n)
        out.append((ih, bh, il, bl))
    return out


def _pair_tail(mesh: Mesh, st: MeshPairState, sel, pair_scal, own_hi,
               own_lo, k_hi, k_lo, eta, c, gate):
    """The replicated alpha-pair algebra, the owned alpha writes (lo
    first, hi wins on i_hi == i_lo) and each shard's rank-2 gradient
    update in two fused multiply-adds, as the single-device engine
    (solver/smo.py apply_pair_update). `pair_scal` is (y_hi, y_lo,
    a_hi0, a_lo0), each per group (gathered with the pair's rows).
    `gate` (per group) forces an exact no-op. Returns (alpha, f, f_err)
    per local rank."""
    cp, cn = split_c(c)
    y_hi, y_lo, a_hi0, a_lo0 = pair_scal
    coefs = []
    for g, (_, b_hi, _, b_lo) in enumerate(sel):
        a_hi, a_lo = pair_alpha_update(
            a_hi0[g], a_lo0[g], y_hi[g], y_lo[g], b_hi, b_lo, eta[g],
            c_of(y_hi[g], cp, cn), c_of(y_lo[g], cp, cn), gate[g])
        coefs.append((a_hi, a_lo, (a_hi - a_hi0[g]) * y_hi[g],
                      (a_lo - a_lo0[g]) * y_lo[g]))
    alpha, f, f_err = [], [], ([] if st.f_err is not None else None)
    for i in range(len(mesh.devices)):
        a_hi, a_lo, coef_hi, coef_lo = coefs[mesh.group_of[i]]
        (oh, lh), (ol, ll) = own_hi[i], own_lo[i]
        a_r = scatter_alpha(st.alpha[i], ll, ol.reshape(1), a_lo.reshape(1))
        alpha.append(scatter_alpha(a_r, lh, oh.reshape(1), a_hi.reshape(1)))
        if st.f_err is None:
            f.append(fma32(coef_lo, k_lo[i], fma32(coef_hi, k_hi[i],
                                                   st.f[i])))
        else:
            f_r, e_r = maybe_kahan(st.f[i], st.f_err[i], fma32(
                coef_lo, k_lo[i], coef_hi * k_hi[i]))
            f.append(f_r)
            f_err.append(e_r)
    return alpha, f, f_err


def _kernel_rows(mesh: Mesh, x, x_sq, kp: KernelParams, q_rows, q_sq,
                 dots=None) -> list:
    """Per local rank, the kernel rows of the group's query rows against
    the shard: q_rows[g] (k, d) float32 and q_sq[g] (k,), or the dot
    rows `dots` per local rank (from the cache) with q_sq[g] 0-d. One
    product a shard when `dots` is None."""
    out = []
    for i in range(len(mesh.devices)):
        g = mesh.group_of[i]
        d = (row_dots(x[i], q_rows[g].to(x[i].dtype)) if dots is None
             else dots[i])
        out.append(kernel_from_dots(d, x_sq[i], q_sq[g], kp))
    return out


def _on_ranks(mesh: Mesh, x, per_group) -> list:
    """A per-group query row, per local rank in the shard's storage
    dtype."""
    return [per_group[mesh.group_of[i]].to(x[i].dtype)
            for i in range(len(mesh.devices))]


def make_pair_chunk_runner(mesh: Mesh, kp: KernelParams, c, eps: float,
                           tau: float, selection: str = "mvp"):
    """The per-pair mesh engine (engine="xla" on the mesh):
    run(x, y, x_sq, k_diag, valid, state, end, it_host=None, tally=None)
    -> state runs trips while it < end and the gap of the last selection
    is open; the trip that sees the closed gap still runs its
    (degenerate) update and counts, as on one device. The trips are
    queued smo.TRIPS at a time between host reads (smo.queue_trips,
    with `it_host` and `tally` as there); a trip never reads the host.
    selection "mvp", "nu" (the per-class pair) or "second_order" (i by
    violation, j by the largest gain over the sharded candidates: two
    gathers a trip). A trip is three exchanges (four under
    second_order): the candidates, then the pair's rows with their
    per-row scalars in one masked sum, then the kernel entries eta
    reads."""
    p_loc = len(mesh.devices)

    def owners_of(ids, n_loc):
        return [_owner(ids[mesh.group_of[i]], r, n_loc)
                for i, r in enumerate(mesh.local_ranks)]

    def first_order(x, y, x_sq, valid, st, f_cur, active):
        """mvp / nu: (pair, extrema, pair scalars, own_hi, own_lo, k_hi,
        k_lo, eta, elig, hits); pair = (i_hi, b_hi, i_lo, b_lo) per
        group, hits per group (None uncached)."""
        n_loc = y[0].shape[0]
        sel = _select_pair_mesh(mesh, f_cur, st.alpha, y, valid, c,
                                selection)
        own_hi = owners_of([s[0] for s in sel], n_loc)
        own_lo = owners_of([s[2] for s in sel], n_loc)
        # The squared norms from the owner, not from the fetched row: a
        # re-reduction may differ in the last ulp (the JAX package's
        # bit-parity note).
        q_hi, q_lo, sq_hi, sq_lo, *pair_scal = mesh.psum_many(
            _row_parts(x, own_hi), _row_parts(x, own_lo),
            _scalar_parts(x_sq, own_hi), _scalar_parts(x_sq, own_lo),
            _scalar_parts(y, own_hi), _scalar_parts(y, own_lo),
            _scalar_parts(st.alpha, own_hi), _scalar_parts(st.alpha, own_lo))
        hits = None
        if st.cache is not None:
            d_hi, d_lo, hits = lookup_pair_mesh(
                st.cache, x, [s[0] for s in sel], [s[2] for s in sel],
                _on_ranks(mesh, x, q_hi), _on_ranks(mesh, x, q_lo), st.it,
                active)
            k_hi = _kernel_rows(mesh, x, x_sq, kp, None, sq_hi, d_hi)
            k_lo = _kernel_rows(mesh, x, x_sq, kp, None, sq_lo, d_lo)
        else:
            k2 = _kernel_rows(mesh, x, x_sq, kp,
                              [torch.stack(p) for p in zip(q_hi, q_lo)],
                              [torch.stack(p) for p in zip(sq_hi, sq_lo)])
            k_hi, k_lo = [k[0] for k in k2], [k[1] for k in k2]
        # eta from the owners' kernel entries, as one device reads
        # k_hi[i_hi], k_lo[i_lo] and k_hi[i_lo].
        k_hh, k_ll, k_hl = mesh.psum_many(
            _scalar_parts(k_hi, own_hi), _scalar_parts(k_lo, own_lo),
            _scalar_parts(k_hi, own_lo))
        eta = [torch.clamp(a + b - 2.0 * h, min=tau)
               for a, b, h in zip(k_hh, k_ll, k_hl)]
        return (sel, [(s[1], s[3]) for s in sel], pair_scal, own_hi, own_lo,
                k_hi, k_lo, eta, None, hits)

    def second_order(x, y, x_sq, k_diag, valid, st, f_cur, active):
        """The second-order pair (the JAX package's _iteration_wss2): i
        and the global b_lo from the first gather, j from the second;
        the update runs on (b_hi, f_j), gated on an eligible j."""
        n_loc = y[0].shape[0]
        vals, idx, lows = [], [], []
        for i, r in enumerate(mesh.local_ranks):
            up, low = set_masks(st.alpha[i], y[i], c, valid[i])
            lows.append(low)
            f_up = torch.where(up, f_cur[i], _INF)
            l_hi = torch.argmin(f_up)
            vals.append(torch.stack([take(f_up, l_hi), ieee_max(
                torch.where(low, f_cur[i], -_INF))]))
            idx.append(torch.stack([l_hi + r * n_loc,
                                    torch.zeros_like(l_hi)]))
        first = []
        for g_vals, g_idx in zip(*mesh.all_gather_many(vals, idx)):
            b_hi, i_hi = _reduce_pair(g_vals, g_idx, 0, True)
            first.append((i_hi, b_hi, ieee_max(g_vals[:, 1])))
        own_hi = owners_of([s[0] for s in first], n_loc)
        # K(hi, hi) from the diagonal, as one device reads k_diag[i_hi].
        q_hi, sq_hi, k_hh, y_hi, a_hi0 = mesh.psum_many(
            _row_parts(x, own_hi), _scalar_parts(x_sq, own_hi),
            _scalar_parts(k_diag, own_hi), _scalar_parts(y, own_hi),
            _scalar_parts(st.alpha, own_hi))
        hits = None
        if st.cache is not None:
            # JAX's stamps: 2 it + 1 for hi, 2 it + 2 for lo.
            stamp = [2 * it for it in st.it]
            d_hi, hits = lookup_one_mesh(
                st.cache, x, [s[0] for s in first], _on_ranks(mesh, x, q_hi),
                [s + 1 for s in stamp], active)
            k_hi = _kernel_rows(mesh, x, x_sq, kp, None, sq_hi, d_hi)
        else:
            k_hi = [k[0] for k in _kernel_rows(
                mesh, x, x_sq, kp, [q[None] for q in q_hi],
                [s.reshape(1) for s in sq_hi])]
        gains, jidx = [], []
        for i, r in enumerate(mesh.local_ranks):
            g = mesh.group_of[i]
            diff = f_cur[i] - first[g][1]
            eta_j = torch.clamp(k_hh[g] + k_diag[i] - 2.0 * k_hi[i], min=tau)
            gain = torch.where(lows[i] & (diff > 0), diff * diff / eta_j,
                               -_INF)
            l_lo = torch.argmax(gain)
            gains.append(take(gain, l_lo).reshape(1, 1))
            jidx.append((l_lo + r * n_loc).reshape(1, 1))
        i_lo, elig = [], []
        for g, (g_gain, g_j) in enumerate(zip(*mesh.all_gather_many(gains,
                                                                    jidx))):
            best, j = _reduce_pair(g_gain[:, 0], g_j[:, 0], 0, False)
            any_elig = best > -_INF
            i_lo.append(torch.where(any_elig, j, first[g][0]))
            elig.append(any_elig)
        own_lo = owners_of(i_lo, n_loc)
        f_lo, q_lo, sq_lo, k_ll, k_hl, y_lo, a_lo0 = mesh.psum_many(
            _scalar_parts(f_cur, own_lo), _row_parts(x, own_lo),
            _scalar_parts(x_sq, own_lo), _scalar_parts(k_diag, own_lo),
            _scalar_parts(k_hi, own_lo), _scalar_parts(y, own_lo),
            _scalar_parts(st.alpha, own_lo))
        if st.cache is not None:
            d_lo, hit_lo = lookup_one_mesh(
                st.cache, x, i_lo, _on_ranks(mesh, x, q_lo),
                [s + 2 for s in stamp], active)
            hits = [h.long() + hl.long() for h, hl in zip(hits, hit_lo)]
            k_lo = _kernel_rows(mesh, x, x_sq, kp, None, sq_lo, d_lo)
        else:
            k_lo = [k[0] for k in _kernel_rows(
                mesh, x, x_sq, kp, [q[None] for q in q_lo],
                [s.reshape(1) for s in sq_lo])]
        eta = [torch.clamp(a + b - 2.0 * h, min=tau)
               for a, b, h in zip(k_hh, k_ll, k_hl)]
        pair = [(s[0], s[1], il, fl) for s, il, fl in zip(first, i_lo, f_lo)]
        return (pair, [(s[1], s[2]) for s in first], (y_hi, y_lo, a_hi0,
                                                       a_lo0),
                own_hi, own_lo, k_hi, k_lo, eta, elig, hits)

    def trip(x, y, x_sq, k_diag, valid, st: MeshPairState, end: int,
             eps2, active0):
        """One trip, gated by the loop's condition on every device
        (`active0` the first device's, as queue_trips computed it)."""
        f_cur = (st.f if st.f_err is None
                 else [f - e for f, e in zip(st.f, st.f_err)])
        active = [active0] + [
            (it < end) & (bl > bh + e2)
            for it, bh, bl, e2 in zip(st.it[1:], st.b_hi[1:], st.b_lo[1:],
                                      eps2[1:])]
        if selection == "second_order":
            out = second_order(x, y, x_sq, k_diag, valid, st, f_cur,
                               active)
        else:
            out = first_order(x, y, x_sq, valid, st, f_cur, active)
        pair, ext, pair_scal, own_hi, own_lo, k_hi, k_lo, eta, elig, \
            hits = out
        gate = active if elig is None else [a & e for a, e in
                                            zip(active, elig)]
        alpha, f, f_err = _pair_tail(mesh, st, pair, pair_scal, own_hi,
                                     own_lo, k_hi, k_lo, eta, c, gate)
        keep = [active[mesh.group_of[i]] for i in range(p_loc)]
        f = [torch.where(k, a, b) for k, a, b in zip(keep, f, st.f)]
        if f_err is not None:
            f_err = [torch.where(k, a, b)
                     for k, a, b in zip(keep, f_err, st.f_err)]
        return MeshPairState(
            alpha, f,
            [torch.where(a, e[0], bh) for a, e, bh in zip(active, ext,
                                                          st.b_hi)],
            [torch.where(a, e[1], bl) for a, e, bl in zip(active, ext,
                                                          st.b_lo)],
            [it + a.to(torch.int32) for it, a in zip(st.it, active)],
            st.cache,
            st.hits if hits is None else [h + n for h, n in zip(st.hits,
                                                                hits)],
            f_err)

    def run(x, y, x_sq, k_diag, valid, state: MeshPairState, end: int,
            it_host: Optional[int] = None, tally: Optional[dict] = None):
        # 2 eps in float32 on each device, so every device's condition
        # is queue_trips's (smo.trip_active) bit for bit.
        eps2 = [two_eps(eps, dev) for dev, _ in mesh.groups]
        return smo.queue_trips(
            lambda st, active: trip(x, y, x_sq, k_diag, valid, st, end,
                                    eps2, active),
            state, end, eps, state_of=_lead, it_host=it_host, tally=tally)

    return run


def solve_mesh(x, y, config: SVMConfig, num_devices: Optional[int] = None,
               mesh: Optional[Mesh] = None, callback=None,
               checkpoint_path: Optional[str] = None, resume: bool = False,
               alpha_init=None, f_init=None,
               warm_start=None) -> SolveResult:
    """Train binary C-SVC row-sharded over the mesh.

    `mesh=None` takes the visible CUDA cards (the first `num_devices` of
    them) and raises without one. ``Mesh([torch.device("cuda:0")] * 4)``
    runs four logical shards on one card; ``Mesh(["cpu"] * 2)`` runs the
    plain PyTorch path. stats["mesh_devices"] lists the devices by rank.
    `callback`, `checkpoint_path` and `resume` follow solve()'s contract
    (solver/solve.py), on every engine. `alpha_init` / `f_init` override
    the start point as in solve() (the model families' hook);
    `warm_start` is repaired and its gradient rebuilt on the mesh
    (solver/warmstart.py warm_rebuild_mesh), then passed on as
    alpha_init / f_init. config.reconstruct_every runs the solve in
    float64 reconstruction legs. config.ooc runs the out-of-core mesh
    stream (solver/ooc.py solve_ooc_mesh: X stays on the host, each
    shard streams its own row tiles).

    On a mesh that spans processes (parallel/mesh.py
    initialize_multihost; `mesh=None` spans them too) every process
    calls solve_mesh with the same arguments and gets the same result;
    the callback must decide the same in every process (it sees the same
    observations).
    """
    if config.engine not in ("xla", "block"):
        raise ValueError(
            f"engine={config.engine!r} is implemented for the single-chip "
            "solver only; the mesh backend supports engine='xla' (per-pair) "
            "and engine='block' (distributed decomposition)")
    if config.kernel == "precomputed" and config.engine != "block":
        raise ValueError(
            "kernel='precomputed' on the mesh is implemented for "
            "engine='block' (Gram symmetry makes its fold a local column "
            "gather and the (q, q) block a q^2-sized psum — "
            "parallel/dist_block.py); the per-pair mesh engine would "
            "move a full (n,) Gram row per pair update — use "
            "engine='block' or backend='single'")
    if config.selection == "nu" and alpha_init is None:
        # The nu rule is degenerate without the nu trainers' feasible
        # warm start (solver/solve.py).
        raise ValueError(
            "selection='nu' is internal to the nu duals — call "
            "train_nusvc/train_nusvr (models/nusvm.py) instead")
    spans = (mesh.num_processes > 1 if mesh is not None
             else process_count() > 1)
    if spans:
        _refuse_across_processes(config)
    if config.ooc:
        # Routed before the warm-start recursion: the stream solver
        # repairs a seed and rebuilds its gradient itself.
        from dpsvm_tpu_torch.solver.ooc import solve_ooc_mesh
        from dpsvm_tpu_torch.solver.smo import _solve_with_degradation

        return _solve_with_degradation(
            config, checkpoint_path, resume,
            lambda cfg, res: solve_ooc_mesh(
                x, y, cfg, num_devices=num_devices, mesh=mesh,
                callback=callback, checkpoint_path=checkpoint_path,
                resume=res, alpha_init=alpha_init, f_init=f_init,
                warm_start=warm_start))
    if mesh is None:
        mesh = make_data_mesh(num_devices)
    if warm_start is not None:
        if alpha_init is not None or f_init is not None:
            raise ValueError(
                "pass either warm_start or alpha_init/f_init, not both")
        from dpsvm_tpu_torch.solver.warmstart import prepare_warm_start

        a0, f0, wstats = prepare_warm_start(x, y, config, warm_start,
                                            mesh=mesh)
        res = solve_mesh(x, y, config, mesh=mesh, callback=callback,
                         checkpoint_path=checkpoint_path, resume=resume,
                         alpha_init=a0, f_init=f0)
        res.stats["warm_start"] = wstats
        return res
    if config.reconstruct_every:
        from dpsvm_tpu_torch.solver.reconstruct import solve_in_legs

        return solve_in_legs(partial(solve_mesh, mesh=mesh), x, y, config,
                             callback=callback,
                             checkpoint_path=checkpoint_path, resume=resume,
                             alpha_init=alpha_init, f_init=f_init)
    config.check_ported()
    from dpsvm_tpu_torch.solver.smo import (_retry_callback,
                                            _solve_with_degradation,
                                            run_with_fault_retry)

    def run(cfg, res):
        def attempt(cfg_k, res_k, k):
            return _solve_mesh_impl(
                x, y, cfg_k, mesh,
                _retry_callback(callback, cfg_k, checkpoint_path, k),
                checkpoint_path, res_k, alpha_init, f_init)

        # In-process retry is single-controller only: across processes
        # the recovery is a relaunch with --resume, which the one-time
        # warning names.
        if mesh.num_processes > 1:
            _warn_multihost_retry_dropped(cfg, mesh.num_processes)
            cfg = cfg.replace(retry_faults=0)
        return run_with_fault_retry(cfg, checkpoint_path, res, attempt)

    return _solve_with_degradation(config, checkpoint_path, resume, run)


def _refuse_across_processes(config: SVMConfig) -> None:
    """The mesh path that does not run across processes, refused at
    solve_mesh's entry with the ROADMAP item that carries it."""
    if config.ring_exchange:
        raise ValueError(
            "ring_exchange=True does not run on a mesh that spans "
            "processes: kernels B7 / B8 move peer shards within one "
            "process, as ops/ring.py refuses several cards (ROADMAP item "
            "6)")


def _solve_mesh_impl(x, y, config: SVMConfig, mesh: Mesh, callback,
                     checkpoint_path, resume, alpha_init,
                     f_init) -> SolveResult:
    """One attempt of solve_mesh: stage the shards, run the chunk loop,
    assemble."""
    t_entry = time.perf_counter()
    x = np.asarray(x, np.float32)
    warn_if_bf16_degrades(x, config)
    for dev in {d for d, _ in mesh.groups}:
        resolve_device(dev)  # raises without CUDA; sets the float32 policy

    y_np = np.asarray(y, np.int32)
    n, d = x.shape
    kp = KernelParams(config.kernel, config.resolve_gamma(d), config.degree,
                      config.coef0)
    n_dev = mesh.size
    use_block = config.engine == "block"
    nu = config.selection == "nu"
    gram = kp.kind == "precomputed"
    # The engine choice of the JAX package's _solve_mesh_impl: an
    # explicit knob always wins; a None (auto) local_working_sets,
    # pipeline_rounds or ring_exchange asks the device profile's gate
    # (default off), in the JAX package's order and only where the knob
    # could run. The shard-local gate needs n_dev > 1 BEFORE the
    # profile: one shard is pure sync overhead, which a verdict measured
    # on several must not engage. The mesh's pipelined engine has its
    # own gate ("pipeline_rounds_mesh"): its overlap is the exchange
    # racing the replicated chain, not the one-device kernel order. The
    # nu rule and the active set keep the all_gather path.
    gate, autotune_embed = autotune_gate_resolver(mesh.devices[0])
    lws = config.local_working_sets
    plain_only = not use_block or nu or gram or bool(config.active_set_size)
    use_shardlocal = (not plain_only and not config.budget_mode
                      and not config.pipeline_rounds
                      and (lws >= 2 if lws is not None
                           else (n_dev > 1
                                 and gate("local_working_sets", False))))
    use_pipe = (not plain_only and not use_shardlocal
                and (config.pipeline_rounds
                     if config.pipeline_rounds is not None
                     else gate("pipeline_rounds_mesh", False)))
    # Across processes the ring is refused at the entry, and its gate is
    # not asked.
    use_ring = (not plain_only and n_dev > 1 and mesh.num_processes == 1
                and (config.ring_exchange
                     if config.ring_exchange is not None
                     else gate("ring_exchange", False)))
    n_loc_f = pad_rows(n, n_dev, multiple=1024) // n_dev
    use_fused = (not plain_only and not use_pipe and not use_shardlocal
                 and not use_ring and bool(config.fused_fold)
                 and min(config.working_set_size, n_loc_f)
                 <= n_loc_f // 64)
    if config.fused_round:
        warnings.warn(
            "fused_round=True is a single-chip knob; solve_mesh keeps "
            "its per-shard fused fold+select path (config.fused_fold) "
            "— the forced one-pass round does not apply on the mesh",
            stacklevel=2)
    mult = 1024 if use_fused else 8

    n_pad = pad_rows(n, n_dev, mult)
    n_loc = n_pad // n_dev
    y_p = np.ones((n_pad,), np.float32)
    y_p[:n] = y_np
    valid_p = np.zeros((n_pad,), bool)
    valid_p[:n] = True
    store_dtype, extra = storage_dtype(x, config, kp.gamma)
    dtype = torch.bfloat16 if store_dtype == "bfloat16" else torch.float32
    shard = partial(shard_padded_rows, mesh, multiple=mult)
    y_sh = shard(y_p)
    valid_sh = shard(valid_p)
    if gram:
        if n != d:
            raise ValueError(
                f"kernel='precomputed' needs the square (n, n) Gram "
                f"matrix as x; got {x.shape}")
        # Both axes padded: rows shard over the ranks, and the symmetric
        # column gathers index columns by the same padded global ids
        # (padded rows and columns are zero and masked out by `valid`).
        x_cols = np.zeros((n, n_pad), np.float32)
        x_cols[:, :n] = x
        x_sh = shard(x_cols, dtype=dtype)
        # The diagonal through the storage rounding of the shards, so
        # eta mixes equal precisions as on one device.
        diag = torch.as_tensor(np.ascontiguousarray(np.diagonal(x)))
        diag_p = np.zeros((n_pad,), np.float32)
        diag_p[:n] = diag.to(dtype).float().numpy()
        k_diag = shard(diag_p)
        x_sq = [torch.zeros_like(kd) for kd in k_diag]
    else:
        x_sh = shard(x, dtype=dtype)
        # x_sq from the STORED (possibly rounded) rows, as on a single
        # device.
        x_sq = [squared_norms(xr) for xr in x_sh]
        k_diag = [kernel_diag(s, kp) for s in x_sq]

    def rep(value, dt):
        return replicate_array(mesh, np.asarray(value, dt))

    start = chunks.start_state(y_np, config, checkpoint_path, resume,
                               alpha_init, f_init)
    a_start, f_start, err_start = start.padded(n_pad)
    ckpt = PeriodicCheckpointer(checkpoint_path, config, start.pairs)
    observe = chunks.observed(config, callback, ckpt)
    eps_run = _BUDGET_EPS if config.budget_mode else float(config.epsilon)
    err_sh = None if err_start is None else shard(err_start)
    common_state = (shard(a_start), shard(f_start),
                    rep(start.b_hi, np.float32), rep(start.b_lo, np.float32),
                    rep(start.pairs, np.int32))
    args = (x_sh, y_sh, x_sq, k_diag, valid_sh)
    if use_block:
        engine = _BlockEngine(mesh, config, kp, eps_run, n_loc, observe,
                               dict(shardlocal=use_shardlocal, pipe=use_pipe,
                                    ring=use_ring, fused=use_fused))
        state = MeshBlockState(*common_state,
                               rounds=rep(start.rounds, np.int32),
                               f_err=err_sh)
        run_chunk = engine.run_chunk(args)
    else:
        cache_lines = min(config.cache_lines, n_loc)
        cache = (init_mesh_cache(cache_lines, n_loc, mesh)
                 if cache_lines > 0 else None)
        state = MeshPairState(*common_state, cache=cache,
                              hits=rep(0, np.int64), f_err=err_sh)
        runner = make_pair_chunk_runner(mesh, kp, config.c_bounds(),
                                        eps_run, float(config.tau),
                                        config.selection)
        # The pair count the chunk loop last read: it cuts a batch to the
        # trips the chunk has left, as on one device.
        seen = {"it": start.pairs}
        tally = {"trips": 0, "reads": 0}

        def run_chunk(st):
            return runner(*args, st,
                          chunks.pair_end(config, observe, seen["it"]),
                          it_host=seen["it"], tally=tally)

    def read(st):
        pairs = st.pairs if use_block else st.it
        (it,), (b_hi, b_lo) = read_obs((pairs[0],), (st.b_hi[0],
                                                     st.b_lo[0]))
        if use_block:
            engine.obs = (it, b_hi, b_lo)
        else:
            seen["it"] = it
            tally["reads"] += 1
        return it, b_hi, b_lo

    def payload(st):
        # Gathered from every process (a collective: every process's
        # checkpointer is due at the same pair count).
        err = None if st.f_err is None else unshard(st.f_err, mesh)[:n]
        rounds = int(st.rounds[0]) if use_block else None
        return (unshard(st.alpha, mesh)[:n], unshard(st.f, mesh)[:n], err,
                rounds)

    obs = chunks.open_run_obs(
        "solve_mesh", config,
        {"n": n, "d": d, "n_pad": n_pad, "n_devices": n_dev,
         "engine": config.engine, "kernel": config.kernel,
         "selection": config.selection,
         "shardlocal": bool(use_shardlocal),
         "pipelined": bool(use_block and use_pipe),
         "fused_fold": bool(use_block and use_fused),
         "ring_exchange": bool(use_ring), "observed_chunks": observe,
         "mesh_devices": mesh.describe(), **autotune_embed()},
        list(mesh.devices), write=mesh.process_index == 0)
    ex0 = (mesh.exchanges, mesh.exchange_seconds)
    fields = None
    if use_block:
        engine.obs_run = obs
        fields = lambda: {"shardlocal": bool(engine.local)}  # noqa: E731
    with precision_ctx(config):
        out = chunks.run_chunks(
            run_chunk, state, read, config=config, eps_run=eps_run,
            callback=callback, ckpt=ckpt, start_iter=start.pairs,
            sync=mesh.synchronize, payload=payload,
            tensors=lambda st: (st.f, st.alpha), backend=f"mesh p={n_dev}",
            t_entry=t_entry, obs=obs, span="mesh/chunk",
            chunk_fields=fields)
    t_fin = time.perf_counter()
    state = out.state
    it, b_hi, b_lo = out.it, out.b_hi, out.b_lo
    converged = not (b_lo > b_hi + 2.0 * eps_run)
    alpha = unshard(state.alpha, mesh)[:n]
    f_parts = (state.f if state.f_err is None
               else [f - e for f, e in zip(state.f, state.f_err)])
    f_final = unshard(f_parts, mesh)[:n]
    if (use_block or config.budget_mode) and not converged:
        b_hi, b_lo, converged = refresh_extrema_host(
            f_final, alpha, y_np, config.c_bounds(), config.epsilon,
            rule=config.selection)
    stats = {
        "num_devices": n_dev,
        "mesh_devices": mesh.describe(),
        "rows_padded": n_pad - n,
        "f": f_final,
        "device": str(mesh.devices[0]),
        "n_pad": n_pad,
        "chunks": out.chunks,
        "phase_seconds": out.phase_seconds,
        **extra,
        **autotune_embed(),
    }
    if mesh.num_processes > 1:
        stats.update(num_processes=mesh.num_processes,
                     process_backend=mesh.backend,
                     exchanges=mesh.exchanges - ex0[0],
                     exchange_seconds=mesh.exchange_seconds - ex0[1])
    if use_block:
        stats.update(engine.stats(state))
    else:
        lookups = 2 * (it - start.pairs) if state.cache is not None else 0
        (hits,), _ = read_obs((state.hits[0],))
        stats.update(cache_hits=hits, cache_lookups=lookups,
                     cache_hit_rate=hits / lookups if lookups else 0.0,
                     trips_queued=tally["trips"], host_reads=tally["reads"])
    out.phase_seconds["finalize"] = time.perf_counter() - t_fin
    res = SolveResult(
        alpha=alpha, b=float((b_lo + b_hi) / 2.0), b_hi=b_hi, b_lo=b_lo,
        iterations=it, converged=converged,
        train_seconds=out.train_seconds, stats=stats,
        dispatches=out.chunks)
    chunks.finish_run_obs(obs, res, out.chunks, **(
        {"shardlocal_demoted": stats["shardlocal_demoted"]}
        if "shardlocal_demoted" in stats else {}))
    return res


class _BlockEngine:
    """The block engine of one mesh solve: the runner the knobs choose
    and, for the shard-local runner, the endgame demotion (the
    concurrent shard-local chains are a bulk-phase accelerator: once the
    global gap stops halving across a chunk's worth of local rounds, or
    is within 10 epsilon of done, the host swaps in the exact
    global-working-set runner for the tail; the test runs on the last
    chunk's observation, before the next chunk)."""

    def __init__(self, mesh: Mesh, config: SVMConfig, kp: KernelParams,
                 eps_run: float, n_loc: int, observe: bool, use: dict):
        self.mesh, self.config, self.use = mesh, config, use
        gran = 4 if config.selection == "nu" else 2
        # Block height clamped so each shard can produce q/gran
        # candidates a side (a class quarter under the nu rule).
        q = max(gran, min(config.working_set_size, gran * n_loc))
        q -= q % gran
        inner = config.inner_iters or 2 * q
        self.m_act = active_set_height(config, q, gran * n_loc)
        self.r_sync = int(config.sync_rounds)
        bound = chunks.round_bound(config, observe, inner)
        base = (mesh, kp, config.c_bounds(), eps_run, float(config.tau), q,
                inner)
        common = dict(selection=config.selection,
                      compensated=config.compensated,
                      pair_batch=int(config.pair_batch))
        # The default dispatch, and the shard-local engine's endgame
        # demotion. The ring exchange rides along (bit-identical).
        self.plain = partial(make_block_chunk_runner, *base, bound,
                             ring_exchange=use["ring"], **common)
        if self.m_act:
            runner = make_block_active_chunk_runner(
                *base, bound, self.m_act, int(config.reconcile_rounds),
                **common)
        elif use["shardlocal"]:
            # The demotion reads the gap at chunk boundaries, so
            # shard-local chunks are always bounded (an observed solve's
            # chunk is its round bound in whole sync windows).
            win = (max(1, bound // self.r_sync) if observe
                   else _SHARDLOCAL_WINDOWS_PER_CHUNK)
            runner = make_block_shardlocal_chunk_runner(
                *base, win * self.r_sync, self.r_sync,
                ring_exchange=use["ring"], **common)
        elif use["pipe"]:
            runner = make_block_pipelined_chunk_runner(
                *base, bound, ring_exchange=use["ring"], **common)
        elif use["fused"]:
            runner = make_block_fused_chunk_runner(*base, bound, **common)
        else:
            runner = self.plain()
        self.runner = runner
        self.local = use["shardlocal"]
        self.obs = None
        self.obs_run = NULL_OBS
        self.gap_ref = None
        self.demoted_at = None
        self.syncs = 0
        self.stall_rounds = _SHARDLOCAL_WINDOWS_PER_CHUNK * self.r_sync

    def run_chunk(self, args):
        max_iter = int(self.config.max_iter)
        eps = float(self.config.epsilon)

        def run(st):
            if self.local and self.obs is not None:
                it, b_hi, b_lo = self.obs
                gap = b_lo - b_hi
                rounds_now = int(st.rounds[0])
                ref = self.gap_ref
                if ref is None or gap <= 0.5 * ref[0]:
                    self.gap_ref = ref = (gap, rounds_now)  # halved
                stalled = rounds_now - ref[1] >= self.stall_rounds
                if gap <= 10.0 * eps or stalled:
                    self.runner = self.plain()
                    self.local = False
                    self.demoted_at = {"pairs": it, "rounds": rounds_now,
                                       "gap": gap, "stalled": bool(stalled)}
                    self.obs_run.event("shardlocal_demotion", pairs=it,
                                       gap=float(gap),
                                       stalled=bool(stalled),
                                       rounds=int(rounds_now))
            was_local = self.local
            r0 = int(st.rounds[0]) if was_local else 0
            st = self.runner(*args, st, max_iter)
            if was_local:
                self.syncs += (int(st.rounds[0]) - r0) // self.r_sync
            return st

        return run

    def stats(self, state) -> dict:
        use = self.use
        out = {"outer_rounds": int(state.rounds[0]),
               "pipelined": use["pipe"], "fused_fold": use["fused"]}
        if self.m_act:
            out["active_set_size"] = self.m_act
        if use["shardlocal"]:
            out["shardlocal_demoted"] = self.demoted_at is not None
            out["shardlocal_syncs"] = self.syncs
            if self.demoted_at is not None:
                out["shardlocal_demotion"] = self.demoted_at
        if use["ring"]:
            out["ring_exchange"] = True
        return out
