"""The block engine over the data mesh (counterpart of
dpsvm_tpu/parallel/dist_block.py: the global and the shard-local
runners).

A row-sharded array is a list of tensors, one per rank this process
owns (parallel/mesh.py; all P ranks in one process); a replicated value
is one tensor per distinct local device of the mesh, computed once there
and shared by the shards that live on it (the JAX package computes it
identically on every device, so this changes no result). The runners
loop over the local ranks and name rows by global rank; across
processes every collective is one exchange, and each process computes
the same replicated values (kernel B1 runs once a round per process and
local device). The ring exchange (kernels B7 / B8) stays within one
process: across processes it is refused (ROADMAP item 6).

Global runner, per round:
  1. per shard: local top-h of I_up (smallest f) and I_low (largest f),
     h = q/2;
  2. the candidates are gathered and reduced to the replicated global
     top-h per side (the union of the per-shard top-h holds the global
     top-h, so W always holds the globally most-violating pair); the
     stopping extrema ride the gathered values;
  3. the working set's rows and per-row scalars are recovered with two
     masked sums over the shards;
  4. the replicated (q, q) Gram block and subproblem solve
     (ops/subproblem.py, kernel B1);
  5. per shard: the local fold f_loc += coef @ K(W, shard), and the owned
     alpha slots scattered.
With ring_exchange the candidates travel WITH their rows and scalars
through ops/ring.py ring_gather (kernel B7) and step 3 disappears.

Shard-local runner: every shard selects a working set from its OWN rows
and runs its own round (solver/block.py run_local_round), P chains side
by side; every sync_rounds local rounds the shards exchange their
window of touched rows, fold the other shards' windows into their
gradient (ops/ring.py fold_window_peers, or kernel B8 with
ring_exchange) and agree on the exact stopping pair.

Pipelined runner: the next round's selection and working-set recovery
(rows and the static per-row scalars) are issued from the PRE-fold
carry; one (q, 2) masked sum hands the staged set its current alpha and
f, and slots the previous round saturated drop out
(candidate_live_mask). With ring_exchange the selection and recovery
are kernel B7.

Fused-fold runner: each shard's fold and its per-row candidates are one
pass (ops/fold_select.py fold_select, kernel B2) over its (n_loc/128,
128) views (n_loc padded to a multiple of 1024); the exact local top-h
of those candidates and one gather give the next global working set.

Active runner: one distributed selection with q = m picks the m
globally most-violating rows (and the exact extrema); one masked sum
replicates their rows and scalars; up to k_rounds rounds run on those
replicated views with no exchange at all (solver/block.py active_cycle,
computed once per device); one local fold per shard reconciles the
gradient, and each shard scatters back the active rows it owns.

The JAX package's lax.while_loop under shard_map is a host loop here,
with ONE device-to-host read a round (global, pipelined, fused), an
inner round (active) or a sync window (shard-local), as
solver/block.py run_chunk_block reads once a round. Replicated work
(the subproblem, the Gram block, the active rounds) runs once per
distinct device, so logical shards of one card launch kernel B1 once a
round.

Out-of-core mesh programs (ooc_mesh_select, ooc_mesh_fold,
ooc_mesh_scatter, ooc_mesh_norms; driven by solver/ooc.py
solve_ooc_mesh while the host streams every shard its own row tiles):
selection is _select_block_mesh's, and the working set's (q, 5) scalars
[x_sq, k_diag, alpha, y, f_eff] are gathered from their owners with ONE
masked sum (exactly one nonzero float32 term per live slot, so it is
exact); the fold of a stream step touches only each shard's own tile and
exchanges nothing; alpha scatters back to its owners only.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dpsvm_tpu_torch.ops.kernels import (KernelParams, kernel_from_dots,
                                         kernel_rows, mm_f32, squared_norms)
from dpsvm_tpu_torch.ops.ooc import ooc_fold_tile
from dpsvm_tpu_torch.ops.ring import (fold_window_peers, ring_fold_window,
                                      ring_gather)
from dpsvm_tpu_torch.ops.fold_select import LANES, fold_select
from dpsvm_tpu_torch.ops.select import (candidate_live_mask,
                                        nu_stopping_pair, set_masks,
                                        stopping_extrema)
from dpsvm_tpu_torch.ops.subproblem import solve_subproblem
from dpsvm_tpu_torch.parallel.mesh import Mesh
from dpsvm_tpu_torch.solver.block import (_top_h, active_cycle,
                                          combine_halves, run_local_round,
                                          scatter_alpha)
from dpsvm_tpu_torch.solver.smo import maybe_kahan

_NEG_INF = -float("inf")


class MeshBlockState(NamedTuple):
    """The mesh round loop's carry: alpha, f (and f_err) one tensor per
    rank; the extrema and counters one tensor per distinct device."""

    alpha: list
    f: list
    b_hi: list
    b_lo: list
    pairs: list  # int32
    rounds: list  # int32
    f_err: Optional[list] = None


def _global_ids(rank: int, n_loc: int, device) -> torch.Tensor:
    """Global row ids of shard `rank` (contiguous row partitioning)."""
    return rank * n_loc + torch.arange(n_loc, dtype=torch.int64,
                                       device=device)


def _local_top(f, alpha, y, valid, c, h: int, rule: str = "mvp"):
    """One shard's candidate stage: (v (rows, h) scores, i (rows, h)
    local ids), the top-h of -f over I_up and of f over I_low; under the
    nu rule the four per-class rows [up & pos, low & pos, up & neg, low &
    neg]."""
    up, low = set_masks(alpha, y, c, valid)
    if rule == "nu":
        pos = y > 0
        scores = torch.stack([torch.where(up & pos, -f, _NEG_INF),
                              torch.where(low & pos, f, _NEG_INF),
                              torch.where(up & ~pos, -f, _NEG_INF),
                              torch.where(low & ~pos, f, _NEG_INF)])
    else:
        scores = torch.stack([torch.where(up, -f, _NEG_INF),
                              torch.where(low, f, _NEG_INF)])
    return _top_h(scores, h)


def _global_top(mesh: Mesh, vs, gs, h: int):
    """Replicated global top-h per score row from the per-shard top-h
    candidates. vs[i] (rows, h) scores with -inf at inadmissible entries,
    gs[i] (rows, h) global ids, per local rank. Per group: (g_ids (rows,
    h), ok (rows, h), vals (rows, h)); ties go to the lowest position of
    the device-major (rows, P h) candidate axis, as lax.top_k off the
    TPU."""
    out = []
    for av, ag in zip(*mesh.all_gather_many(vs, gs)):
        rows = av.shape[1]
        av = av.movedim(0, 1).reshape(rows, -1)  # (rows, P h), device-major
        ag = ag.movedim(0, 1).reshape(rows, -1)
        gv, gi = _top_h(av, h)
        out.append((torch.gather(ag, 1, gi), torch.isfinite(gv), gv))
    return out


def _select_block_mesh(mesh: Mesh, f, alpha, y, valid, c, q: int,
                       rule: str = "mvp"):
    """Distributed working-set selection. Per group, the replicated
    (w, slot_ok, b_hi, b_lo), with solver/block.py select_block's
    semantics (rule="nu": per-class quarters, q a multiple of 4, the
    extrema the larger-violation class's pair); the extrema are exact
    and globally reduced."""
    h = q // 4 if rule == "nu" else q // 2
    vs, gs = [], []
    for i, r in enumerate(mesh.local_ranks):
        v, loc = _local_top(f[i], alpha[i], y[i], valid[i], c, h, rule)
        vs.append(v)
        gs.append(_global_ids(r, f[i].shape[0], f[i].device)[loc])
    out = []
    for ids, ok, gv in _global_top(mesh, vs, gs, h):
        if rule == "nu":
            w_p, ok_p = combine_halves(ids[0], ok[0], ids[1], ok[1])
            w_n, ok_n = combine_halves(ids[2], ok[2], ids[3], ok[3])
            b_hi, b_lo = nu_stopping_pair(-gv[0].max(), gv[1].max(),
                                          -gv[2].max(), gv[3].max())
            out.append((torch.cat([w_p, w_n]), torch.cat([ok_p, ok_n]),
                        b_hi, b_lo))
        else:
            w, slot_ok = combine_halves(ids[0], ok[0], ids[1], ok[1])
            out.append((w, slot_ok, -gv[0].max(), gv[1].max()))
    return out


def _check_ring(ring_exchange: bool, mesh: Mesh, kp: KernelParams,
                selection: str) -> None:
    """Factory-time guard of the ring-exchange runners: one process,
    feature kernels, the two-sided rules, at least two shards."""
    if not ring_exchange:
        return
    mesh.require_one_process(
        "ring_exchange (kernels B7 / B8 move peer shards within one "
        "process)", "item 6")
    if kp.kind == "precomputed":
        raise ValueError(
            "ring_exchange supports feature kernels only (a precomputed "
            "Gram has no rows for the candidate ring to carry)")
    if selection not in ("mvp", "second_order"):
        raise ValueError(
            "ring_exchange supports selection in {'mvp', 'second_order'}")
    if mesh.size < 2:
        raise ValueError(
            "ring_exchange needs >= 2 devices (a one-device ring has no "
            "hops; use the plain runner)")


def ring_block(f, alpha, y, valid, c, q: int, x_loc, scal_cols, rank: int):
    """One shard's block for the candidate ring: its per-side top-h
    candidates as (2h, d + 5 + 3) float32 rows
    [x row | x_sq, k_diag, alpha, y, f | score | gid >> 12 | gid & 0xFFF].
    The global id rides two value lanes (19 and 12 bits, both exact in
    float32), the JAX package's layout, so the block stays plain float32
    data."""
    h = q // 2
    v, i = _local_top(f, alpha, y, valid, c, h)
    flat = i.reshape(-1)  # side-major (2h,): [up half | low half]
    g = _global_ids(rank, f.shape[0], f.device)[flat]
    return torch.cat(
        [x_loc[flat].float(),
         torch.stack([col[flat] for col in scal_cols], dim=1),
         v.reshape(-1, 1), (g >> 12).float()[:, None],
         (g & 0xFFF).float()[:, None]], dim=1)


def _select_from_ring(ag, q: int, lanes: int):
    """The replicated selection from the gathered ring blocks ag
    (P, 2h, lanes + 3): (w, slot_ok, b_hi, b_lo, wdata (q, lanes)), wdata
    the winners' rows and scalars in combine_halves' [up | low] order."""
    p_dev = ag.shape[0]
    h = q // 2
    cand = ag.reshape(p_dev, 2, h, lanes + 3).movedim(0, 1)
    cand = cand.reshape(2, p_dev * h, lanes + 3)  # device-major
    av = cand[:, :, lanes]
    agid = ((cand[:, :, lanes + 1].to(torch.int64) << 12)
            | cand[:, :, lanes + 2].to(torch.int64))
    gv, gi = _top_h(av, h)
    ids = torch.gather(agid, 1, gi)
    win = torch.gather(cand[:, :, :lanes], 1,
                       gi[:, :, None].expand(2, h, lanes))
    w, slot_ok = combine_halves(ids[0], torch.isfinite(gv[0]),
                                ids[1], torch.isfinite(gv[1]))
    return (w, slot_ok, -gv[0].max(), gv[1].max(),
            torch.cat([win[0], win[1]]))


def _select_block_mesh_ring(mesh: Mesh, f, alpha, y, valid, c, q: int,
                            x, scal_cols):
    """Ring-exchange counterpart of _select_block_mesh + _gather_ws: the
    candidates travel with their rows and per-row scalars (kernel B7), so
    selection and working-set recovery need no other exchange. scal_cols[r]
    is shard r's (x_sq, k_diag, alpha, y, f) columns. Per group:
    (w, slot_ok, b_hi, b_lo, wdata)."""
    blocks = [ring_block(f[r], alpha[r], y[r], valid[r], c, q, x[r],
                         scal_cols[r], r) for r in range(mesh.size)]
    gathered = ring_gather(blocks)  # per rank (P, 2h, L + 3)
    lanes = blocks[0].shape[1] - 3
    return [_select_from_ring(gathered[ranks[0]], q, lanes)
            for _, ranks in mesh.groups]


def _ws_owners(w, slot_ok, rank: int, n_loc: int):
    """Ownership of the replicated working-set ids on shard `rank`:
    (l local slot index, own mask, l_safe clipped index). THE single
    definition of the shard-offset convention."""
    l = w - rank * n_loc
    own = (l >= 0) & (l < n_loc) & slot_ok
    return l, own, l.clamp(0, n_loc - 1)


def _scal_parts(scal_cols, owners) -> list:
    """Per local rank, the owned rows of the working set's per-row
    scalars, zero elsewhere: the terms of one (q, S) masked sum."""
    parts = []
    for cols, (_, own, l_safe) in zip(scal_cols, owners):
        scal = torch.stack([col[l_safe] for col in cols], dim=1)
        parts.append(torch.where(own[:, None], scal, 0.0))
    return parts


def _psum_scal(mesh: Mesh, scal_cols, owners):
    """Replicate the working set's per-row scalars: one (q, S) sum."""
    return mesh.psum(_scal_parts(scal_cols, owners))


def _local_owners(mesh: Mesh, sel, n_loc: int) -> list:
    """Per local rank, the ownership (l, own, l_safe) of its group's
    working set sel[g] = (w, slot_ok)."""
    return [_ws_owners(*sel[mesh.group_of[i]][:2], r, n_loc)
            for i, r in enumerate(mesh.local_ranks)]


def _gather_ws(mesh: Mesh, x, scal_cols, sel):
    """Recover the working set's rows and per-row scalars from the shards
    with one (q, d) and one (q, S) masked sum (one exchange). sel[g] =
    (w, slot_ok) per group. Returns (qx per group (q, d) float32, scal
    per group (q, S), owners per local rank (l, own, l_safe))."""
    owners = _local_owners(mesh, sel, x[0].shape[0])
    parts = [torch.where(own[:, None], x[i][l_safe].float(), 0.0)
             for i, (_, own, l_safe) in enumerate(owners)]
    qx, scal = mesh.psum_many(parts, _scal_parts(scal_cols, owners))
    return qx, scal, owners


def _gather_ws_gram(mesh: Mesh, x, scal_cols, sel):
    """Working-set recovery on a precomputed Gram, whose shard r holds
    its ROWS of the symmetric (n_pad, n_pad) matrix: K(W, W) is the sum
    of each shard's owned W rows at columns W ((q, q) traffic, never a
    (q, n) row sum), and the fold's rows K(W, shard) are the local
    column gather x[r][:, W] (no traffic). Returns (kb per group (q, q),
    scal per group (q, S), owners per rank)."""
    owners = _local_owners(mesh, sel, x[0].shape[0])
    parts = []
    for i, (_, own, l_safe) in enumerate(owners):
        rows_own = torch.where(own[:, None], x[i][l_safe].float(), 0.0)
        parts.append(rows_own[:, sel[mesh.group_of[i]][0]])
    kb, scal = mesh.psum_many(parts, _scal_parts(scal_cols, owners))
    return kb, scal, owners


def _mesh_round_core(qx, scal, slot_ok, gap_open, budget_left,
                     kp: KernelParams, c, eps: float, tau: float,
                     inner_iters: int, selection: str, pair_batch: int = 1,
                     kb_w=None):
    """The replicated part of a mesh round after working-set recovery:
    the (q, q) Gram block (or `kb_w` as recovered from a precomputed
    Gram), the subproblem solve and the fold coefficients. scal is the
    (q, 5) stack [x_sq, k_diag, alpha, y, f_eff]. Returns (alpha_w,
    coef, t)."""
    qsq, kd_w, alpha_w0, y_w, f_w0 = (scal[:, k].contiguous()
                                      for k in range(5))
    if kb_w is None:
        kb_w = kernel_from_dots(mm_f32(qx, qx.t()), qsq, qsq, kp)
    limit = torch.clamp(budget_left, max=inner_iters)
    limit = torch.where(gap_open, limit, 0).to(torch.int32)
    alpha_w, t = solve_subproblem(kb_w, alpha_w0, y_w, f_w0, kd_w,
                                  slot_ok.float(), limit, c, eps, tau,
                                  rule=selection, pair_batch=pair_batch)
    coef = torch.where(slot_ok, (alpha_w - alpha_w0) * y_w, 0.0)
    return alpha_w, coef, t


def _eff(f, f_err, r: int):
    return f[r] if f_err is None else f[r] - f_err[r]


def _loop_open(state: MeshBlockState, max_iter: int, eps: float) -> bool:
    """The loop condition, evaluated on the first device in float32 and
    read on the host."""
    return bool((state.pairs[0] < max_iter)
                & (state.b_lo[0] > state.b_hi[0] + 2.0 * eps))


def make_block_chunk_runner(mesh: Mesh, kp: KernelParams, c, eps: float,
                            tau: float, q: int, inner_iters: int,
                            rounds_per_chunk: Optional[int] = None,
                            selection: str = "mvp",
                            compensated: bool = False, pair_batch: int = 1,
                            ring_exchange: bool = False):
    """The global-working-set chunk runner: run(x, y, x_sq, k_diag, valid,
    state, max_iter) -> state, every array argument a list per rank.
    Runs rounds while pairs < max_iter and the carried gap is open, at
    most rounds_per_chunk of them (None: to the end). ring_exchange routes
    the candidate exchange and the working-set recovery through kernel
    B7, with bit-identical trajectories."""
    _check_ring(ring_exchange, mesh, kp, selection)
    gram = kp.kind == "precomputed"
    p_loc = len(mesh.devices)

    def one_round(x, y, x_sq, k_diag, valid, st: MeshBlockState, max_iter):
        f_cur = [_eff(st.f, st.f_err, i) for i in range(p_loc)]
        scal_cols = [(x_sq[i], k_diag[i], st.alpha[i], y[i], f_cur[i])
                     for i in range(p_loc)]
        d = x[0].shape[1]
        if ring_exchange:
            sel = _select_block_mesh_ring(mesh, f_cur, st.alpha, y, valid, c,
                                          q, x, scal_cols)
            qx = [s[4][:, :d].contiguous() for s in sel]
            scal = [s[4][:, d:] for s in sel]
            owners = _local_owners(mesh, sel, x[0].shape[0])
        else:
            sel = _select_block_mesh(mesh, f_cur, st.alpha, y, valid, c, q,
                                     rule=selection)
            recover = _gather_ws_gram if gram else _gather_ws
            qx, scal, owners = recover(mesh, x, scal_cols,
                                       [s[:2] for s in sel])
        core = []
        for g, (w, slot_ok, b_hi, b_lo, *_) in enumerate(sel):
            gap_open = b_lo > b_hi + 2.0 * eps
            core.append(_mesh_round_core(
                None if gram else qx[g], scal[g], slot_ok, gap_open,
                max_iter - st.pairs[g], kp, c, eps, tau, inner_iters,
                selection, pair_batch, kb_w=qx[g] if gram else None))
        alpha, f, f_err = [], [], ([] if compensated else None)
        for i in range(p_loc):
            g = mesh.group_of[i]
            alpha_w, coef, _ = core[g]
            l, own, _ = owners[i]
            # The fold is LOCAL: the (q, n_loc) kernel rows of this shard
            # (on a precomputed Gram, by symmetry its columns W).
            if gram:
                k_rows = x[i][:, sel[g][0]].float().t()
            else:
                k_rows = kernel_rows(x[i], x_sq[i], qx[g].to(x[i].dtype),
                                     scal[g][:, 0], kp)
            f_r, e_r = maybe_kahan(st.f[i],
                                   st.f_err[i] if compensated else None,
                                   coef @ k_rows)
            # Scatter the owned slots (the inert index is one past the
            # end, never -1, which would wrap to the shard's last row).
            alpha.append(scatter_alpha(st.alpha[i], l, own, alpha_w))
            f.append(f_r)
            if compensated:
                f_err.append(e_r)
        return MeshBlockState(
            alpha, f, [s[2] for s in sel], [s[3] for s in sel],
            [st.pairs[g] + core[g][2] for g in range(len(sel))],
            [rd + 1 for rd in st.rounds], f_err)

    def run(x, y, x_sq, k_diag, valid, state: MeshBlockState, max_iter: int):
        done = 0
        while ((rounds_per_chunk is None or done < rounds_per_chunk)
               and _loop_open(state, max_iter, eps)):
            state = one_round(x, y, x_sq, k_diag, valid, state, max_iter)
            done += 1
        return state

    return run


def make_block_shardlocal_chunk_runner(mesh: Mesh, kp: KernelParams, c,
                                       eps: float, tau: float, q: int,
                                       inner_iters: int,
                                       rounds_per_chunk: int,
                                       sync_rounds: int = 1,
                                       selection: str = "mvp",
                                       compensated: bool = False,
                                       pair_batch: int = 1,
                                       ring_exchange: bool = False):
    """SHARD-PARALLEL working sets (config.local_working_sets >= 2): every
    shard selects a q-sized working set from its OWN rows, builds its
    Gram block locally and runs its own subproblem chain (run_local_round
    on the shard's views, no exchange at all), P chains side by side.

    Every sync_rounds (R) local rounds, one SYNC: the window's
    (R q, d + 3) touched-row blocks [x row | x_sq | coef | pair-count
    lane] are gathered; each shard folds the OTHER shards' blocks into
    its gradient in rotation order, right neighbour first (its own were
    folded round by round); the pair counter rides lane d + 2; the exact
    global stopping pair comes from the corrected gradient by local
    masked extrema and one (2,) maximum over the shards. With
    ring_exchange the gather and the fold are kernel B8.

    Each shard's selection is stale with respect to the other shards'
    concurrent updates, but every executed update is exact on the shard's
    own view, and cross-shard contributions enter f only through the
    sync. Shard-local chains can starve near the optimum (the violating
    pair may span two shards), so final convergence belongs to the
    endgame demotion in solve_mesh. P shards spend the pair budget
    concurrently: `pairs` may overshoot max_iter by up to
    (P - 1) R inner_iters, which is why budget_mode is refused.

    run(x, y, x_sq, k_diag, valid, state, max_iter) -> state runs windows
    while the carried gap is open and pairs < max_iter, up to
    rounds_per_chunk local rounds, reading the condition once a window.
    """
    if kp.kind == "precomputed":
        raise ValueError(
            "shard-local working sets support feature kernels only (a "
            "precomputed Gram's sync fold would need global column ids "
            "for rows the shard does not own; use the plain runner)")
    if selection not in ("mvp", "second_order"):
        raise ValueError(
            "shard-local working sets support selection in {'mvp', "
            "'second_order'} (the nu rule's per-class stopping pair does "
            "not reduce shard-locally)")
    _check_ring(ring_exchange, mesh, kp, selection)
    p_loc = len(mesh.devices)
    r_sync = int(sync_rounds)

    def window(x, y, x_sq, k_diag, valid, st: MeshBlockState, max_iter):
        d = x[0].shape[1]
        alpha, f, pends = [], [], []
        f_err = [] if compensated else None
        for i in range(p_loc):
            a_r, f_r = st.alpha[i], st.f[i]
            e_r = st.f_err[i] if compensated else None
            budget = max_iter - st.pairs[mesh.group_of[i]]
            blks = []
            for _ in range(r_sync):
                # The single-device round body on the shard's views. Its
                # extrema are the shard-LOCAL pair: they gate this shard's
                # budget and are otherwise dropped.
                a_r, f_r, e_r, _, _, t, coef, qx, qsq = run_local_round(
                    x[i], y[i], x_sq[i], k_diag[i], valid[i], a_r, f_r, e_r,
                    budget, kp, c, eps, tau, q, inner_iters, selection,
                    pair_batch)
                budget = budget - t
                # The round's touched block for the sync fold. Dead slots
                # carry coef 0 and real (finite) rows; lane d + 2 carries
                # the round's pair count in slot 0 (an integer well under
                # 2^24, exact in float32).
                tcol = torch.zeros(q, dtype=torch.float32, device=qx.device)
                tcol[0] = t.float()
                blks.append(torch.cat(
                    [qx.float(), qsq[:, None], coef[:, None],
                     tcol[:, None]], dim=1))
            alpha.append(a_r)
            f.append(f_r)
            if compensated:
                f_err.append(e_r)
            pends.append(torch.cat(blks))  # (R q, d + 3)

        if ring_exchange:
            gathered, f, f_err = ring_fold_window(pends, x, x_sq, f, f_err,
                                                  kp)
            ag = [gathered[ranks[0]] for _, ranks in mesh.groups]
        else:
            ag = mesh.all_gather(pends)  # per group (P, R q, d + 3)
            folded = [fold_window_peers(
                ag[mesh.group_of[i]], r, x[i], x_sq[i], f[i],
                f_err[i] if compensated else None, kp)
                for i, r in enumerate(mesh.local_ranks)]
            f = [o[0] for o in folded]
            f_err = [o[1] for o in folded] if compensated else None
        pairs = [st.pairs[g] + a[:, :, d + 2].sum().to(torch.int32)
                 for g, a in enumerate(ag)]

        # The global stopping pair from the CORRECTED gradient.
        ext = []
        for i in range(p_loc):
            bh, bl = stopping_extrema(_eff(f, f_err, i), alpha[i], y[i], c,
                                      valid=valid[i], rule=selection)
            ext.append(torch.stack([-bh, bl]))
        gmax = mesh.pmax(ext)
        return MeshBlockState(alpha, f, [-m[0] for m in gmax],
                              [m[1] for m in gmax], pairs,
                              [rd + r_sync for rd in st.rounds], f_err)

    def run(x, y, x_sq, k_diag, valid, state: MeshBlockState, max_iter: int):
        done = 0
        while done < rounds_per_chunk and _loop_open(state, max_iter, eps):
            state = window(x, y, x_sq, k_diag, valid, state, max_iter)
            done += r_sync
        return state

    return run


def make_block_pipelined_chunk_runner(mesh: Mesh, kp: KernelParams, c,
                                      eps: float, tau: float, q: int,
                                      inner_iters: int,
                                      rounds_per_chunk: Optional[int] = None,
                                      selection: str = "mvp",
                                      compensated: bool = False,
                                      pair_batch: int = 1,
                                      ring_exchange: bool = False):
    """PIPELINED mesh rounds (config.pipeline_rounds; the JAX package's
    make_block_pipelined_chunk_runner, the mesh form of solver/block.py
    run_chunk_block_pipelined). The next round's distributed selection
    and its working-set recovery (rows and the static x_sq, k_diag, y)
    are issued from the PRE-fold carry, so they wait on nothing of the
    in-flight round; rows and static scalars are exact however stale the
    selection. On the critical path stays one (q, 2) masked sum that
    hands the staged set its CURRENT alpha and f, the replicated
    subproblem, the local fold and the owned-slot scatter. Stale
    selection, exact updates: slots the previous round saturated drop
    out (candidate_live_mask), and a round that moves nothing folds a
    zero delta, so the next prefetch reads the exact gradient.

    With ring_exchange the selection and recovery are one kernel B7
    gather of [row | x_sq, k_diag, y | score | id] blocks. Feature
    kernels only. Each chunk call seeds one prefetch; a round makes
    one more."""
    if kp.kind == "precomputed":
        raise ValueError(
            "pipelined mesh rounds support feature kernels only (the "
            "precomputed Gram's symmetric round has no (q, d) exchange to "
            "hide; use make_block_chunk_runner)")
    _check_ring(ring_exchange, mesh, kp, selection)
    p_loc = len(mesh.devices)

    def prefetch(x, y, x_sq, k_diag, valid, f_eff, alpha):
        cols = [(x_sq[i], k_diag[i], y[i]) for i in range(p_loc)]
        if ring_exchange:
            sel = _select_block_mesh_ring(mesh, f_eff, alpha, y, valid, c,
                                          q, x, cols)
        else:
            sel = _select_block_mesh(mesh, f_eff, alpha, y, valid, c, q,
                                     rule=selection)
        # The rows and static columns rode the ring's candidates, or one
        # (q, d) and one (q, 3) masked sum recover them.
        if ring_exchange:
            d = x[0].shape[1]
            qx = [s[4][:, :d].contiguous() for s in sel]
            stat = [s[4][:, d:] for s in sel]
        else:
            qx, stat, _ = _gather_ws(mesh, x, cols, [s[:2] for s in sel])
        return [(s[0], s[1], s[2], s[3], qx[g], stat[g], kernel_from_dots(
            mm_f32(qx[g], qx[g].t()), stat[g][:, 0], stat[g][:, 0], kp))
            for g, s in enumerate(sel)]

    def one_round(x, y, x_sq, k_diag, valid, st: MeshBlockState, cand,
                  max_iter):
        f_cur = [_eff(st.f, st.f_err, i) for i in range(p_loc)]
        owners = _local_owners(mesh, cand, x[0].shape[0])
        dyn = _psum_scal(mesh, [(st.alpha[i], f_cur[i])
                                for i in range(p_loc)], owners)
        core = []
        for g, (w, ok0, _, _, qx, stat, kb) in enumerate(cand):
            a_w0, f_w0 = dyn[g][:, 0].contiguous(), dyn[g][:, 1].contiguous()
            kd_w, y_w = stat[:, 1].contiguous(), stat[:, 2].contiguous()
            slot_ok = ok0 & candidate_live_mask(a_w0, y_w, c)
            # No gap gate: the loop condition holds the carried gap open.
            limit = torch.clamp(max_iter - st.pairs[g],
                                max=inner_iters).to(torch.int32)
            alpha_w, t = solve_subproblem(kb, a_w0, y_w, f_w0, kd_w,
                                          slot_ok.float(), limit, c, eps,
                                          tau, rule=selection,
                                          pair_batch=pair_batch)
            coef = torch.where(slot_ok, (alpha_w - a_w0) * y_w, 0.0)
            core.append((slot_ok, alpha_w, coef, t))
        nxt = prefetch(x, y, x_sq, k_diag, valid, f_cur, st.alpha)
        alpha, f, f_err = [], [], ([] if compensated else None)
        for i in range(p_loc):
            g = mesh.group_of[i]
            slot_ok, alpha_w, coef, _ = core[g]
            qx, stat = cand[g][4], cand[g][5]
            l, own, _ = owners[i]
            k_rows = kernel_rows(x[i], x_sq[i], qx.to(x[i].dtype),
                                 stat[:, 0], kp)
            f_r, e_r = maybe_kahan(st.f[i],
                                   st.f_err[i] if compensated else None,
                                   coef @ k_rows)
            alpha.append(scatter_alpha(st.alpha[i], l, own & slot_ok,
                                      alpha_w))
            f.append(f_r)
            if compensated:
                f_err.append(e_r)
        return MeshBlockState(
            alpha, f, [c_[2] for c_ in nxt], [c_[3] for c_ in nxt],
            [st.pairs[g] + core[g][3] for g in range(len(cand))],
            [rd + 1 for rd in st.rounds], f_err), nxt

    def run(x, y, x_sq, k_diag, valid, state: MeshBlockState, max_iter: int):
        f_eff = [_eff(state.f, state.f_err, i) for i in range(p_loc)]
        cand = prefetch(x, y, x_sq, k_diag, valid, f_eff, state.alpha)
        state = state._replace(b_hi=[c_[2] for c_ in cand],
                               b_lo=[c_[3] for c_ in cand])
        done = 0
        while ((rounds_per_chunk is None or done < rounds_per_chunk)
               and _loop_open(state, max_iter, eps)):
            state, cand = one_round(x, y, x_sq, k_diag, valid, state, cand,
                                    max_iter)
            done += 1
        return state

    return run


def _global_top_from_rows(mesh: Mesh, cands, h: int):
    """The replicated global working set from per-shard PER-ROW
    candidates (kernel B2's outputs, cands[r] = (upv, upi, lov, loi) with
    GLOBAL ids): exact local top-h per side, one gather, exact global
    top-h, the shared cross-half dedup. Per group (w, slot_ok, b_hi,
    b_lo); each shard's true extremum is in the gathered union, so the
    extrema are exact."""
    vs, gs = [], []
    for upv, upi, lov, loi in cands:
        v, i = _top_h(torch.stack([-upv, lov]), h)
        vs.append(v)
        gs.append(torch.gather(torch.stack([upi, loi]), 1, i))
    out = []
    for ids, ok, gv in _global_top(mesh, vs, gs, h):
        w, slot_ok = combine_halves(ids[0], ok[0], ids[1], ok[1])
        out.append((w, slot_ok, -gv[0, 0], gv[1, 0]))
    return out


def make_block_fused_chunk_runner(mesh: Mesh, kp: KernelParams, c,
                                  eps: float, tau: float, q: int,
                                  inner_iters: int,
                                  rounds_per_chunk: Optional[int] = None,
                                  selection: str = "mvp",
                                  compensated: bool = False,
                                  pair_batch: int = 1):
    """Fused-fold mesh rounds (config.fused_fold; the JAX package's
    make_block_fused_chunk_runner, the mesh form of solver/block.py
    run_chunk_block_fused): each shard's fold and per-row candidate
    selection are ONE pass over its f shard (kernel B2 on its (n_loc /
    128, 128) views), then one gather of the local top-h assembles the
    exact global working set. One plain distributed selection seeds each
    chunk; the carried extrema are then the exact post-fold ones.

    Requires n_loc a multiple of 1024 (solve_mesh pads with
    pad_rows(multiple=1024)), q/2 <= n_loc/128, selection in {mvp,
    second_order}, feature kernels. B2 launches once a shard and round."""
    p_loc = len(mesh.devices)
    h = q // 2

    def one_round(x, y, x_sq, k_diag, valid, y2d, valid2d,
                  st: MeshBlockState, sel, max_iter):
        f_cur = [_eff(st.f, st.f_err, i) for i in range(p_loc)]
        cols = [(x_sq[i], k_diag[i], st.alpha[i], y[i], f_cur[i])
                for i in range(p_loc)]
        qx, scal, owners = _gather_ws(mesh, x, cols, sel)
        core = [_mesh_round_core(
            qx[g], scal[g], sel[g][1], st.b_lo[g] > st.b_hi[g] + 2.0 * eps,
            max_iter - st.pairs[g], kp, c, eps, tau, inner_iters, selection,
            pair_batch) for g in range(len(sel))]
        alpha, f, f_err, cands = [], [], ([] if compensated else None), []
        for i, r in enumerate(mesh.local_ranks):
            g = mesh.group_of[i]
            alpha_w, coef, _ = core[g]
            l, own, _ = owners[i]
            n_loc = x[i].shape[0]
            shp = (n_loc // LANES, LANES)
            k_rows = kernel_rows(x[i], x_sq[i], qx[g].to(x[i].dtype),
                                 scal[g][:, 0], kp)
            # The owned slots are scattered BEFORE the fused pass: its
            # masks must see the new box membership.
            a_r = scatter_alpha(st.alpha[i], l, own, alpha_w)
            f2d, err2d, upv, upi, lov, loi = fold_select(
                st.f[i].view(shp),
                st.f_err[i].view(shp) if compensated else None,
                a_r.view(shp), y2d[i], valid2d[i], (coef @ k_rows).view(shp),
                c, compensated=compensated)
            off = r * n_loc
            cands.append((upv, upi.long() + off, lov, loi.long() + off))
            alpha.append(a_r)
            f.append(f2d.view(n_loc))
            if compensated:
                f_err.append(err2d.view(n_loc))
        nxt = _global_top_from_rows(mesh, cands, h)
        return MeshBlockState(
            alpha, f, [s[2] for s in nxt], [s[3] for s in nxt],
            [st.pairs[g] + core[g][2] for g in range(len(sel))],
            [rd + 1 for rd in st.rounds], f_err), [s[:2] for s in nxt]

    def run(x, y, x_sq, k_diag, valid, state: MeshBlockState, max_iter: int):
        shp = (x[0].shape[0] // LANES, LANES)
        y2d = [t.view(shp) for t in y]
        valid2d = [t.float().view(shp) for t in valid]
        f_eff = [_eff(state.f, state.f_err, i) for i in range(p_loc)]
        seed = _select_block_mesh(mesh, f_eff, state.alpha, y, valid, c, q,
                                  rule=selection)
        state = state._replace(b_hi=[s[2] for s in seed],
                               b_lo=[s[3] for s in seed])
        sel = [s[:2] for s in seed]
        done = 0
        while ((rounds_per_chunk is None or done < rounds_per_chunk)
               and _loop_open(state, max_iter, eps)):
            state, sel = one_round(x, y, x_sq, k_diag, valid, y2d, valid2d,
                                   state, sel, max_iter)
            done += 1
        return state

    return run


def make_block_active_chunk_runner(mesh: Mesh, kp: KernelParams, c,
                                   eps: float, tau: float, q: int,
                                   inner_iters: int,
                                   rounds_per_chunk: Optional[int], m: int,
                                   k_rounds: int, selection: str = "mvp",
                                   compensated: bool = False,
                                   pair_batch: int = 1):
    """Active-set ("shrinking") mesh cycles (config.active_set_size; the
    JAX package's make_block_active_chunk_runner, the mesh form of
    solver/block.py run_chunk_block_active). One CYCLE:

      1. ONE distributed selection with q = m: the m globally
         most-violating rows, replicated, and the exact global extrema;
      2. one (m, d) and one (m, 5) masked sum replicate the active rows
         and their [x_sq, k_diag, alpha, y, f];
      3. up to k_rounds block rounds on the REPLICATED views
         (solver/block.py active_cycle), with no exchange at all: every
         device computes the same rounds (once per distinct device);
      4. one LOCAL fold per shard applies the cycle's deltas with a
         (k_rounds q, n_loc) kernel-row pass, the rows read from the
         replicated active views; each shard scatters back the active
         rows it owns (their Kahan residual reset).

    Requires q <= m <= gran n_loc (solve_mesh clamps m). max_rounds is
    checked at cycle granularity."""
    p_loc = len(mesh.devices)

    def cycle(x, y, x_sq, k_diag, valid, st: MeshBlockState, max_iter):
        f_cur = [_eff(st.f, st.f_err, i) for i in range(p_loc)]
        sel = _select_block_mesh(mesh, f_cur, st.alpha, y, valid, c, m,
                                 rule=selection)
        cols = [(x_sq[i], k_diag[i], st.alpha[i], y[i], f_cur[i])
                for i in range(p_loc)]
        x_act, scal, owners = _gather_ws(mesh, x, cols,
                                         [s[:2] for s in sel])
        runs = []
        for g, (act_ids, act_ok, b_hi, b_lo) in enumerate(sel):
            sq_a, kd_a, a_a, y_a, f_a = (scal[g][:, k].contiguous()
                                         for k in range(5))
            xa = x_act[g].to(x[mesh.groups[g][1][0]].dtype)
            views = (xa, y_a, sq_a, kd_a, act_ok, a_a, f_a,
                     b_lo > b_hi + 2.0 * eps)
            runs.append((xa, sq_a) + active_cycle(
                views, st.pairs[g], max_iter, kp, c, eps, tau, q,
                inner_iters, k_rounds, selection, pair_batch))
        alpha, f, f_err = [], [], ([] if compensated else None)
        for i in range(p_loc):
            xa, sq_a, a_act, f_act, pend_w, pend_c, _, _, moved = \
                runs[mesh.group_of[i]]
            l, own, _ = owners[i]
            f_r = st.f[i]
            e_r = st.f_err[i] if compensated else None
            if moved:
                f_r, e_r = maybe_kahan(f_r, e_r, pend_c @ kernel_rows(
                    x[i], x_sq[i], xa[pend_w], sq_a[pend_w], kp))
            f.append(scatter_alpha(f_r, l, own, f_act))
            if compensated:
                f_err.append(scatter_alpha(e_r, l, own,
                                          torch.zeros_like(f_act)))
            alpha.append(scatter_alpha(st.alpha[i], l, own, a_act))
        ks = [run[7] for run in runs]
        return MeshBlockState(
            alpha, f, [s[2] for s in sel], [s[3] for s in sel],
            [st.pairs[g] + runs[g][6] for g in range(len(sel))],
            [rd + ks[0] for rd in st.rounds], f_err), ks[0]

    def run(x, y, x_sq, k_diag, valid, state: MeshBlockState, max_iter: int):
        done = 0
        while ((rounds_per_chunk is None or done < rounds_per_chunk)
               and _loop_open(state, max_iter, eps)):
            state, k = cycle(x, y, x_sq, k_diag, valid, state, max_iter)
            done += k
        return state

    return run


# ---------------------------------------------------------------------
# The out-of-core mesh programs (the JAX package's
# make_ooc_mesh_programs). Shard r owns global rows [r n_loc, (r+1) n_loc)
# with n_loc a whole number of stream tiles; stream step j carries tile j
# of every shard. Pad rows (past n) are masked out of selection by
# `valid`, and a tile's fold runs on its real rows only, so a shard's
# tile is exactly the one-device stream's tile r * tiles_loc + j. The
# lists (tiles, f, x_sq, owners) hold this process's ranks by local
# position; the owners carry the global rank offsets (_local_owners).


def ooc_mesh_select(mesh: Mesh, f, f_err, alpha, y, x_sq, k_diag, valid, c,
                    q: int, selection: str = "mvp"):
    """The round's selection and working-set scalars. Per group:
    (w, slot_ok, b_hi, b_lo, scal (q, 5)) with scal's columns [x_sq,
    k_diag, alpha, y, f_eff] at W (zero at dead slots), gathered from the
    owners with one masked sum; and per rank the owners (l, own,
    l_safe)."""
    f_cur = [_eff(f, f_err, i) for i in range(len(mesh.devices))]
    sel = _select_block_mesh(mesh, f_cur, alpha, y, valid, c, q,
                             rule=selection)
    owners = _local_owners(mesh, sel, f[0].shape[0])
    scal = _psum_scal(mesh, [(x_sq[i], k_diag[i], alpha[i], y[i], f_cur[i])
                             for i in range(len(mesh.devices))], owners)
    return [(*s[:4], sc) for s, sc in zip(sel, scal)], owners


def ooc_mesh_fold(mesh: Mesh, tiles, j: int, tile: int, x_sq, f, f_err, qx,
                  qsq, coef, kp: KernelParams) -> None:
    """Stream step j's fold, in place: shard r folds its own tile
    `tiles[r]` = (x_tile, rows) into f[r] (and f_err[r]) at local rows
    [j tile, j tile + rows). qx, qsq, coef are per group. No exchange."""
    s = j * tile
    for r, (xt, rows) in enumerate(tiles):
        if not rows:
            continue
        g = mesh.group_of[r]
        ft, et, _ = ooc_fold_tile(
            xt, x_sq[r][s:s + rows], f[r][s:s + rows],
            None if f_err is None else f_err[r][s:s + rows], qx[g], qsq[g],
            coef[g], kp, compensated=f_err is not None)
        f[r][s:s + rows] = ft
        if et is not None:
            f_err[r][s:s + rows] = et


def ooc_mesh_scatter(mesh: Mesh, alpha, owners, a_w) -> list:
    """alpha with each shard's OWNED working-set slots set to the
    subproblem's new values (a_w per group)."""
    return [scatter_alpha(alpha[r], l, own, a_w[mesh.group_of[r]])
            for r, (l, own, _) in enumerate(owners)]


def ooc_mesh_norms(tiles, j: int, tile: int, x_sq) -> None:
    """The setup stream's step j, in place: each shard's tile's squared
    norms (the one-device stream's reduction per row, so the same
    bits)."""
    s = j * tile
    for r, (xt, rows) in enumerate(tiles):
        if rows:
            x_sq[r][s:s + rows] = squared_norms(xt)
