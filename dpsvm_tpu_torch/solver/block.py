"""Blockwise working-set (decomposition) SMO engine (counterpart of the
plain round of dpsvm_tpu/solver/block.py).

Each outer round:
  1. selects a working set W of the q most-violating points (q/2 from
     I_up by smallest f, q/2 from I_low by largest f); the same pass gives
     the stopping extrema (b_hi, b_lo) of the gradient it saw;
  2. gathers W's rows and builds the (q, q) Gram block K(W, W);
  3. solves the q-variable subproblem (ops/subproblem.py: the Hopper
     kernel on CUDA; on the CPU its plain version _solve_subproblem, the
     counterpart of the JAX package's block._solve_subproblem);
  4. folds the alpha deltas into the global gradient with one (q, n)
     kernel-row pass, f += (dalpha * y)_W @ K(W, :), and scatters alpha_W.

run_local_round is the JAX package's _round_core and run_local_round in
one, built from the four stage functions so each stage can also be timed
alone; each stage is a span (``block/select``, ``block/gather``,
``block/subproblem``, ``block/fold``; obs/trace.py), timed on the device
where it runs there, and the loop condition's host read is the span
``block/read``.

The active-set engine (run_chunk_block_active, the JAX package's
_run_chunk_block_active) runs CYCLES: one select_block with q = m picks
the m most-violating rows (and the exact extrema of the full gradient);
up to k_rounds rounds then select, gather and fold on those (m,)-sized
views only (active_round); one batched fold reconciles the full
gradient with the cycle's deltas and the active rows are scattered
back. The mesh's active runner (parallel/dist_block.py) replicates the
same views and runs the same active_round.

The fused engines (counterparts of _run_chunk_block_fused,
_run_chunk_block_fusedround and _run_chunk_block_pipelined) pad n to a
multiple of 1024 with `valid` marking real rows (solver/solve.py) and
carry the NEXT round's working set in the loop:

  run_chunk_block_fused       the fold and the next selection are one pass
                              over f (ops/fold_select.py fold_select, B2);
  run_chunk_block_fusedround  that, with gather, Gram, kernel rows and the
                              fold contraction in two passes
                              (ops/round.py fused_round, B4 + B5);
  run_chunk_block_pipelined   the next working set is selected, gathered
                              and its Gram block built from the PRE-fold
                              carry (prefetch_working_set; with
                              pallas_select, ops/fold_select.py
                              select_rows, B3).

Each engine seeds its carry once per call and reads its loop condition
on the host once per round, as run_chunk_block does. Every runner takes
`max_rounds`, the rounds one chunk may run (None: to the end; the
observed chunk loop of solver/chunks.py passes a bound), as the JAX
package's runners take rounds_per_chunk. A chunked fused or pipelined
solve therefore re-seeds at every chunk, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dpsvm_tpu_torch.obs.trace import span
from dpsvm_tpu_torch.ops.fold_select import (LANES, assemble_working_set,
                                             fold_select, select_rows)
from dpsvm_tpu_torch.ops.kernels import (KernelParams, kernel_from_dots,
                                         kernel_rows, mm_f32)
from dpsvm_tpu_torch.ops.round import fused_round
from dpsvm_tpu_torch.ops.select import (candidate_live_mask,
                                        nu_stopping_pair, order_key,
                                        set_masks)
from dpsvm_tpu_torch.ops.subproblem import solve_subproblem
from dpsvm_tpu_torch.solver.smo import eff_f, maybe_kahan, read_obs


class BlockState(NamedTuple):
    """The round loop's carry; every field lives on the solve's device."""

    alpha: torch.Tensor  # (n,) float32
    f: torch.Tensor  # (n,) float32
    b_hi: torch.Tensor  # float32, from the last round's selection
    b_lo: torch.Tensor  # float32
    pairs: torch.Tensor  # int32: pair updates so far
    rounds: torch.Tensor  # int32: outer rounds, the terminal one included
    f_err: Optional[torch.Tensor] = None  # Kahan residual (compensated)


def _top_h(scores: torch.Tensor, h: int):
    """Exact top-h per row, ties to the LOWEST index, with the JAX
    package's float order (lax.top_k on the CPU: a total order, so +0.0
    ranks above -0.0, and the -inf fillers of a short side come lowest
    index first). torch.topk promises no order among ties, so each score
    is made unique: its total-order int32 key in the high 32 bits, the
    complement of its index in the low 32 bits."""
    okey = order_key(scores)
    n = scores.shape[-1]
    low = (2 ** 32 - 1) - torch.arange(n, dtype=torch.int64,
                                       device=scores.device)
    key = okey.to(torch.int64) * (2 ** 32) + low
    idx = torch.topk(key, h, dim=-1).indices
    return torch.gather(scores, -1, idx), idx


def combine_halves(up_idx, up_ok, low_idx, low_ok):
    """Assemble (w, slot_ok) from the two candidate halves, masking low
    slots that duplicate a LIVE up slot (filler up indices are arbitrary
    row ids and must not hide real low-half violators)."""
    dup = ((low_idx[:, None] == up_idx[None, :]) & up_ok[None, :]).any(dim=1)
    low_ok = low_ok & ~dup
    return torch.cat([up_idx, low_idx]), torch.cat([up_ok, low_ok])


def select_block(f, alpha, y, c, q: int, valid=None, rule: str = "mvp"):
    """Pick the q most-violating points: q/2 from I_up (smallest f) and
    q/2 from I_low (largest f). Returns (w, slot_ok, b_hi, b_lo): w (q,)
    int64 row ids (filler where a side ran short), slot_ok (q,) bool, and
    the exact float32 extrema of f over I_up / I_low. `valid` (bool, n)
    masks padded rows out of both sets.

    rule="nu" takes per-class quarters instead (q/4 from each of I_up
    and I_low within each class, q a multiple of 4): the nu duals carry
    one equality constraint per class, so W must let the subproblem pair
    within both classes. Duplicates are masked within a class (the
    classes are disjoint), and (b_hi, b_lo) are the larger-violation
    class's pair (nu_stopping_pair)."""
    up, low = set_masks(alpha, y, c, valid)
    neg_inf = -float("inf")
    if rule == "nu":
        pos = y > 0
        scores = torch.stack([torch.where(up & pos, -f, neg_inf),
                              torch.where(low & pos, f, neg_inf),
                              torch.where(up & ~pos, -f, neg_inf),
                              torch.where(low & ~pos, f, neg_inf)])
        vals, idx = _top_h(scores, q // 4)
        fin = torch.isfinite(vals)
        w_p, ok_p = combine_halves(idx[0], fin[0], idx[1], fin[1])
        w_n, ok_n = combine_halves(idx[2], fin[2], idx[3], fin[3])
        # Row 0 of each side is its maximum in the float total order,
        # which is the IEEE maximum (a +-0 tie gives +0.0).
        b_hi, b_lo = nu_stopping_pair(-vals[0, 0], vals[1, 0],
                                      -vals[2, 0], vals[3, 0])
        return (torch.cat([w_p, w_n]), torch.cat([ok_p, ok_n]), b_hi, b_lo)
    scores = torch.stack([torch.where(up, -f, neg_inf),
                          torch.where(low, f, neg_inf)])
    vals, idx = _top_h(scores, q // 2)
    w, slot_ok = combine_halves(idx[0], torch.isfinite(vals[0]),
                                idx[1], torch.isfinite(vals[1]))
    return w, slot_ok, -vals[0].max(), vals[1].max()


def gather_block(x, y, x_sq, k_diag, f, alpha, w, kp: KernelParams):
    """Gather W's rows and per-slot state and build K(W, W) (float32
    accumulation whatever X's storage dtype). Returns
    (qx, qsq, kb_w, kd_w, a_w0, y_w, f_w0)."""
    qx = x[w]
    qsq = x_sq[w]
    return (qx, qsq, gram_block(qx, qsq, w, kp), k_diag[w], alpha[w], y[w],
            f[w])


def gram_block(qx, qsq, w, kp: KernelParams):
    """K(W, W) from W's gathered rows: their dot products through the
    kernel, or, where x IS the Gram (kernel "precomputed", the resident
    Gram), a column gather of the gathered rows (kernel_rows likewise
    returns them verbatim for the fold)."""
    if kp.kind == "precomputed":
        return qx.float()[:, w]
    return kernel_from_dots(mm_f32(qx, qx.t()), qsq, qsq, kp)


def dispatch_subproblem(kb_w, kd_w, slot_ok, a_w0, y_w, f_w0, c,
                        eps: float, tau: float, limit, selection: str,
                        pair_batch: int = 1):
    """The subproblem stage of a round. Returns (a_w, coef, t): the new
    subproblem alphas, the fold coefficients (dalpha * y, dead slots
    zeroed) and the executed pair count (int32 0-d tensor)."""
    a_w, t = solve_subproblem(kb_w, a_w0, y_w, f_w0, kd_w, slot_ok.float(),
                              limit, c, eps, tau, rule=selection,
                              pair_batch=pair_batch)
    coef = torch.where(slot_ok, (a_w - a_w0) * y_w, 0.0)
    return a_w, coef, t


def fold_block(x, x_sq, qx, qsq, kp: KernelParams, f, f_err, coef,
               alpha, w, slot_ok, a_w):
    """f += coef @ K(W, :) (Kahan when f_err is carried) and scatter the
    live slots of a_w into alpha. Returns (alpha, f, f_err)."""
    k_rows = kernel_rows(x, x_sq, qx, qsq, kp)  # (q, n) float32
    f, f_err = maybe_kahan(f, f_err, coef @ k_rows)
    return scatter_alpha(alpha, w, slot_ok, a_w), f, f_err


#: The safe configuration of the graceful-degradation path, the JAX
#: package's: float32 storage and the plain round. A non-finite carried
#: gradient on a configuration with any of these knobs on demotes once
#: to it (solver/smo.py _solve_with_degradation).
_SAFE_KNOBS = (
    ("dtype", "float32"),
    ("bf16_gram", False),
    ("fused_round", False),
    ("fused_fold", False),
    ("pipeline_rounds", False),
)


def resolve_auto_gate(knob: str, default: bool,
                      device_kind: str = "") -> tuple:
    """Resolve one ``None``-valued (auto) accelerator knob: the
    installed DeviceProfile's measured verdict for this device kind
    (dpsvm_tpu_torch/autotune) when one exists, else `default` (False
    for every profile-gated knob in the port).

    Returns ``(decision, provenance)``, provenance being the JSON-able
    record the solvers embed in ``SolveResult.stats['autotune']`` and
    the run-log manifest: ``{"source": "profile", profile file, probe
    ratio, threshold, ...}`` or ``{"source": "default", "decision":
    ...}``. A profile can only carry a True verdict from an
    AUTHORITATIVE (CUDA) probe, so the committed CPU profile never
    changes what a CPU solve runs."""
    from dpsvm_tpu_torch.autotune.profile import gate_decision

    hit = gate_decision(knob, device_kind=device_kind or None)
    if hit is None:
        return bool(default), {"source": "default",
                               "decision": bool(default)}
    return bool(hit["decision"]), {"source": "profile", **hit}


def autotune_gate_resolver(device) -> tuple:
    """The solvers' shared gate-resolution scaffold: ``(gate, embed)``
    where ``gate(knob, default)`` resolves one auto knob through
    :func:`resolve_auto_gate` (accumulating provenance) and ``embed()``
    renders the accumulated records as the ``{"autotune": {...}}``
    fragment solve, solve_ooc and solve_mesh splat into
    ``SolveResult.stats`` AND the run-log manifest (empty when no gate
    was consulted): one definition of the record the obs report's
    profile column reads."""
    from dpsvm_tpu_torch.autotune.profile import device_kind_of

    dev_kind = device_kind_of(device)
    prov: dict = {}

    def gate(knob: str, default: bool) -> bool:
        dec, rec = resolve_auto_gate(knob, default, device_kind=dev_kind)
        prov[knob] = rec
        return dec

    def embed() -> dict:
        return ({"autotune": {"device_kind": dev_kind, "gates": prov}}
                if prov else {})

    return gate, embed


def demote_to_safe(config):
    """(safe_config, dropped_knobs): the same config with every knob of
    _SAFE_KNOBS at its safe value, or (None, ()) when the config is
    already safe (a non-finite trajectory there is a real numerics fault
    to propagate, not to retry). A knob counts as dropped only when it
    was truthy; None (auto) is pinned to False without making a config
    unsafe by itself."""
    changes = {}
    dropped = []
    for knob, safe in _SAFE_KNOBS:
        cur = getattr(config, knob)
        if knob == "dtype":
            if cur != safe:
                changes[knob] = safe
                dropped.append(f"dtype={cur}")
        else:
            if cur is not safe:
                changes[knob] = safe
            if cur:
                dropped.append(knob)
    if not dropped:
        return None, ()
    return config.replace(**changes), tuple(dropped)


def scatter_alpha(alpha, w, slot_ok, a_w):
    """alpha (or any row vector) with the live slots of a_w written at w.
    Only live slots may write: a dead slot's id is a real row (possibly
    the same row as a live slot). Dead slots are sent to a scratch
    element past the end, so the scatter needs no host sync."""
    n = alpha.shape[0]
    safe_w = torch.where(slot_ok, w, n)
    buf = torch.cat([alpha, alpha.new_zeros(1)])
    buf[safe_w] = a_w
    return buf[:n]


def run_local_round(x, y, x_sq, k_diag, valid, alpha, f, f_err,
                    budget_left, kp: KernelParams, c, eps: float, tau: float,
                    q: int, inner_iters: int, selection: str,
                    pair_batch: int = 1):
    """ONE complete block round on whatever row view the caller holds
    (`valid`, bool or None, masks padded rows out of the selection).
    Returns (alpha, f, f_err, b_hi, b_lo, t, coef, qx, qsq): the updated
    state, the extrema of the gradient this round SAW (one fold behind,
    as in the JAX package), the executed pair count, and the fold's
    (coef, rows, norms), so a caller can replay the fold against other
    row sets (the mesh's shard-local sync)."""
    dev = x.device
    with span("block/select", device=dev):
        f_cur = f if f_err is None else f - f_err
        w, slot_ok, b_hi, b_lo = select_block(f_cur, alpha, y, c, q,
                                              valid=valid, rule=selection)
        gap_open = b_lo > b_hi + 2.0 * eps
    with span("block/gather", device=dev):
        qx, qsq, kb_w, kd_w, a_w0, y_w, f_w0 = gather_block(
            x, y, x_sq, k_diag, f_cur, alpha, w, kp)
    with span("block/subproblem", device=dev):
        # Per-round pair budget, clamped to what the solve has left and
        # gated to 0 on the terminal round (which still counts as a
        # round).
        limit = torch.clamp(budget_left, max=inner_iters)
        limit = torch.where(gap_open, limit, 0).to(torch.int32)
        a_w, coef, t = dispatch_subproblem(kb_w, kd_w, slot_ok, a_w0, y_w,
                                           f_w0, c, eps, tau, limit,
                                           selection, pair_batch)
    with span("block/fold", device=dev):
        alpha, f, f_err = fold_block(x, x_sq, qx, qsq, kp, f, f_err, coef,
                                     alpha, w, slot_ok, a_w)
    return alpha, f, f_err, b_hi, b_lo, t, coef, qx, qsq


def _more(state: BlockState, done: int, max_rounds: Optional[int],
          max_iter: int, eps: float) -> bool:
    """The round loop's condition: rounds left in the chunk, then (one
    host read, the span ``block/read``) pairs < max_iter and the CARRIED
    gap open, evaluated on the device in float32."""
    if max_rounds is not None and done >= max_rounds:
        return False
    with span("block/read"):
        return bool((state.pairs < max_iter)
                    & (state.b_lo > state.b_hi + 2.0 * eps))


def run_chunk_block(x, y, x_sq, k_diag, state: BlockState, max_iter: int,
                    kp: KernelParams, c, eps: float, tau: float, q: int,
                    inner_iters: int, selection: str = "mvp",
                    pair_batch: int = 1,
                    max_rounds: Optional[int] = None) -> BlockState:
    """Run rounds while pairs < max_iter and the CARRIED gap is open, at
    most max_rounds of them (the JAX package's _run_chunk_block)."""
    done = 0
    while _more(state, done, max_rounds, max_iter, eps):
        done += 1
        alpha, f, f_err, b_hi, b_lo, t, _, _, _ = run_local_round(
            x, y, x_sq, k_diag, None, state.alpha, state.f, state.f_err,
            max_iter - state.pairs, kp, c, eps, tau, q, inner_iters,
            selection, pair_batch)
        state = BlockState(alpha, f, b_hi, b_lo, state.pairs + t,
                           state.rounds + 1, f_err)
    return state


def run_chunk_block_fused(x, y, x_sq, k_diag, valid, state: BlockState,
                          max_iter: int, kp: KernelParams, c, eps: float,
                          tau: float, q: int, inner_iters: int,
                          selection: str = "mvp", pair_batch: int = 1,
                          max_rounds: Optional[int] = None) -> BlockState:
    """Fused-fold rounds: each round's fold and the NEXT round's
    selection are one pass over f (fold_select). One plain select_block
    seeds the carried working set; the carried (b_hi, b_lo) are then the
    exact post-fold extrema, not one fold behind.

    Needs n padded to a multiple of 1024 with `valid` (bool) marking real
    rows, selection in {"mvp", "second_order"} and q/2 <= n_pad/128."""
    n_pad = y.shape[0]
    shp = (n_pad // LANES, LANES)
    y2d = y.view(shp)
    valid2d = valid.float().view(shp)
    compensated = state.f_err is not None
    w, slot_ok, b_hi, b_lo = select_block(eff_f(state), state.alpha, y, c,
                                          q, valid=valid, rule=selection)
    w = w.to(torch.int32)
    state = state._replace(b_hi=b_hi, b_lo=b_lo)
    done = 0
    while _more(state, done, max_rounds, max_iter, eps):
        done += 1
        gap_open = state.b_lo > state.b_hi + 2.0 * eps
        qx, qsq, kb_w, kd_w, a_w0, y_w, f_w0 = gather_block(
            x, y, x_sq, k_diag, eff_f(state), state.alpha, w, kp)
        limit = torch.clamp(max_iter - state.pairs, max=inner_iters)
        limit = torch.where(gap_open, limit, 0).to(torch.int32)
        a_w, coef, t = dispatch_subproblem(kb_w, kd_w, slot_ok, a_w0, y_w,
                                           f_w0, c, eps, tau, limit,
                                           selection, pair_batch)
        delta2d = (coef @ kernel_rows(x, x_sq, qx, qsq, kp)).view(shp)
        # Scatter alpha BEFORE the fused pass: its masks must see the new
        # box membership.
        alpha = scatter_alpha(state.alpha, w, slot_ok, a_w)
        f2d, err2d, upv, upi, lov, loi = fold_select(
            state.f.view(shp),
            state.f_err.view(shp) if compensated else None,
            alpha.view(shp), y2d, valid2d, delta2d, c,
            compensated=compensated)
        w, slot_ok, b_hi, b_lo = assemble_working_set(upv, upi, lov, loi,
                                                      q // 2)
        state = BlockState(alpha, f2d.view(n_pad), b_hi, b_lo,
                           state.pairs + t, state.rounds + 1,
                           err2d.view(n_pad) if compensated else None)
    return state


def run_chunk_block_fusedround(x, y, x_sq, k_diag, valid, state: BlockState,
                               max_iter: int, kp: KernelParams, c,
                               eps: float, tau: float, q: int,
                               inner_iters: int, selection: str = "mvp",
                               pair_batch: int = 1,
                               max_rounds: Optional[int] = None
                               ) -> BlockState:
    """One-pass fused rounds (ops/round.py fused_round): the fused-fold
    engine's loop, seed and carry with each round's gather, Gram, kernel
    rows and fold contraction in the two passes gather_gram and
    fold_rows_select. Same padding contract as run_chunk_block_fused,
    feature kernels only."""
    n_pad = y.shape[0]
    shp = (n_pad // LANES, LANES)
    y2d = y.view(shp)
    valid2d = valid.float().view(shp)
    w, slot_ok, b_hi, b_lo = select_block(eff_f(state), state.alpha, y, c,
                                          q, valid=valid, rule=selection)
    w = w.to(torch.int32)
    state = state._replace(b_hi=b_hi, b_lo=b_lo)
    done = 0
    while _more(state, done, max_rounds, max_iter, eps):
        done += 1
        alpha, f, f_err, b_hi, b_lo, w, slot_ok, t = fused_round(
            x, y, x_sq, k_diag, y2d, valid2d, state.alpha, state.f,
            state.f_err, w, slot_ok, state.b_hi, state.b_lo,
            max_iter - state.pairs, kp, c, eps, tau, q, inner_iters,
            selection, pair_batch)
        state = BlockState(alpha, f, b_hi, b_lo, state.pairs + t,
                           state.rounds + 1, f_err)
    return state


class PipelinedCand(NamedTuple):
    """The pipelined engine's carried prefetch: the NEXT round's working
    set and what about it does not depend on the in-flight round (rows,
    norms, Gram block, kernel diagonal: functions of X and the ids only,
    so exact however stale the selection). Per-slot alpha and f are
    gathered fresh at the handoff."""

    w: torch.Tensor  # (q,) int row ids
    ok: torch.Tensor  # (q,) bool live slots of the selection
    b_hi: torch.Tensor  # float32 extrema of the f the selection saw
    b_lo: torch.Tensor
    qx: torch.Tensor  # (q, d) rows, X's dtype
    qsq: torch.Tensor  # (q,) squared norms
    kb: torch.Tensor  # (q, q) float32 K(W, W)
    kd: torch.Tensor  # (q,) float32 kernel diagonal at W


def prefetch_working_set(x, y, x_sq, k_diag, f, alpha, valid, kp, c,
                         q: int, selection: str,
                         pallas_select: bool = False,
                         valid2d=None) -> PipelinedCand:
    """Select the NEXT round's working set from (f, alpha) and stage its
    rows and Gram block: a function of the pre-fold carry only.
    pallas_select=True selects with the one-pass candidate kernel
    (select_rows + assemble_working_set), which needs the fused path's
    padding contract (n % 1024 == 0 with `valid`, q/2 <= n/128) and reads
    `valid` from `valid2d`: float32 (n/128, 128) views that the caller
    makes once and passes to every prefetch."""
    if pallas_select:
        if valid2d is None:
            raise ValueError("pallas_select=True needs valid2d: `valid` "
                             "as float32 (n/128, 128) views")
        shp = valid2d.shape
        upv, upi, lov, loi = select_rows(
            f.view(shp), alpha.view(shp), y.view(shp), valid2d, c)
        w, ok, b_hi, b_lo = assemble_working_set(upv, upi, lov, loi, q // 2)
    else:
        w, ok, b_hi, b_lo = select_block(f, alpha, y, c, q, valid=valid,
                                         rule=selection)
    qx = x[w]
    qsq = x_sq[w]
    return PipelinedCand(w, ok, b_hi, b_lo, qx, qsq,
                         gram_block(qx, qsq, w, kp), k_diag[w])


def run_chunk_block_pipelined(x, y, x_sq, k_diag, valid, state: BlockState,
                              max_iter: int, kp: KernelParams, c,
                              eps: float, tau: float, q: int,
                              inner_iters: int, selection: str = "mvp",
                              pair_batch: int = 1,
                              pallas_select: bool = False,
                              max_rounds: Optional[int] = None
                              ) -> BlockState:
    """Pipelined rounds: round t+1's working set is selected, gathered
    and its Gram block built from round t's PRE-fold carry, so nothing in
    that stage waits on round t's subproblem.

    Selection may be stale; every executed update is exact: the handoff
    gathers each slot's CURRENT alpha and f and drops slots the previous
    round saturated out of both sets (candidate_live_mask). A round whose
    stale set absorbs no pair folds a zero delta, so the next prefetch
    sees the exact gradient: staleness can waste a round but never
    cycle, and the loop exits only on extrema of a gradient the exiting
    round did not change."""
    valid2d = (valid.float().view(-1, LANES) if pallas_select else None)

    def prefetch(f, alpha):
        return prefetch_working_set(x, y, x_sq, k_diag, f, alpha, valid,
                                    kp, c, q, selection,
                                    pallas_select=pallas_select,
                                    valid2d=valid2d)

    cand = prefetch(eff_f(state), state.alpha)
    state = state._replace(b_hi=cand.b_hi, b_lo=cand.b_lo)
    done = 0
    while _more(state, done, max_rounds, max_iter, eps):
        done += 1
        f_cur = eff_f(state)
        a_w0 = state.alpha[cand.w]
        y_w = y[cand.w]
        f_w0 = f_cur[cand.w]
        slot_ok = cand.ok & candidate_live_mask(a_w0, y_w, c)
        # No gap gate on `limit`: the loop condition already holds the
        # carried gap open, and this body's extrema ARE the carry.
        limit = torch.clamp(max_iter - state.pairs,
                            max=inner_iters).to(torch.int32)
        a_w, coef, t = dispatch_subproblem(cand.kb, cand.kd, slot_ok, a_w0,
                                           y_w, f_w0, c, eps, tau, limit,
                                           selection, pair_batch)
        nxt = prefetch(f_cur, state.alpha)
        k_rows = kernel_rows(x, x_sq, cand.qx, cand.qsq, kp)
        f, f_err = maybe_kahan(state.f, state.f_err, coef @ k_rows)
        alpha = scatter_alpha(state.alpha, cand.w, slot_ok, a_w)
        state = BlockState(alpha, f, nxt.b_hi, nxt.b_lo, state.pairs + t,
                           state.rounds + 1, f_err)
        cand = nxt
    return state


def active_round(x_act, y_act, sq_act, kd_act, act_ok, a_act, f_act,
                 budget_left, kp: KernelParams, c, eps: float, tau: float,
                 q: int, inner_iters: int, selection: str,
                 pair_batch: int = 1):
    """One block round on an active set's (m,)-sized views (the JAX
    package's _round_core on them, then the active fold): `act_ok` masks
    the dead filler slots out of the selection. The fold is a plain add
    (the views carry no Kahan residual). Returns (a_act, f_act, w, coef,
    t, open_a): w the working set as ACTIVE-slot ids, coef its fold
    coefficients, t the pairs executed, open_a the gap of the active
    views this round saw."""
    w, slot_ok, b_hi, b_lo = select_block(f_act, a_act, y_act, c, q,
                                          valid=act_ok, rule=selection)
    open_a = b_lo > b_hi + 2.0 * eps
    qx, qsq, kb_w, kd_w, a_w0, y_w, f_w0 = gather_block(
        x_act, y_act, sq_act, kd_act, f_act, a_act, w, kp)
    limit = torch.clamp(budget_left, max=inner_iters)
    limit = torch.where(open_a, limit, 0).to(torch.int32)
    a_w, coef, t = dispatch_subproblem(kb_w, kd_w, slot_ok, a_w0, y_w, f_w0,
                                       c, eps, tau, limit, selection,
                                       pair_batch)
    f_act = f_act + coef @ kernel_rows(x_act, sq_act, qx, qsq, kp)
    return (scatter_alpha(a_act, w, slot_ok, a_w), f_act, w, coef, t,
            open_a)


def active_cycle(views, pairs, max_iter: int, kp: KernelParams, c,
                 eps: float, tau: float, q: int, inner_iters: int,
                 k_rounds: int, selection: str, pair_batch: int = 1):
    """The inner rounds of one cycle on the active views (x_act, y_act,
    sq_act, kd_act, act_ok, a_act, f_act, open): rounds run while fewer
    than k_rounds ran, the active gap is open and pairs + t < max_iter,
    the condition read on the host once a round. Returns (a_act, f_act,
    pend_w (k_rounds q,) active-slot ids, pend_c (k_rounds q,) coefs,
    t, k_done, moved): rounds that did not run pend id 0 with coef 0,
    the JAX package's (k_rounds, q) buffers; `moved` says t > 0."""
    x_act, y_act, sq_act, kd_act, act_ok, a_act, f_act, open_a = views
    dev = f_act.device
    t_tot = torch.zeros((), dtype=torch.int32, device=dev)
    pend_w, pend_c = [], []
    k = 0
    while True:
        go = open_a & (pairs + t_tot < max_iter)
        (go_h, moved), _ = read_obs((go, t_tot > 0))
        if k >= k_rounds or not go_h:
            break
        a_act, f_act, w, coef, t, open_a = active_round(
            x_act, y_act, sq_act, kd_act, act_ok, a_act, f_act,
            max_iter - pairs - t_tot, kp, c, eps, tau, q, inner_iters,
            selection, pair_batch)
        pend_w.append(w)
        pend_c.append(coef)
        t_tot = t_tot + t
        k += 1
    for _ in range(k_rounds - k):
        pend_w.append(torch.zeros(q, dtype=torch.int64, device=dev))
        pend_c.append(torch.zeros(q, dtype=torch.float32, device=dev))
    return (a_act, f_act, torch.cat(pend_w), torch.cat(pend_c), t_tot, k,
            bool(moved))


def run_chunk_block_active(x, y, x_sq, k_diag, valid, state: BlockState,
                           max_iter: int, kp: KernelParams, c, eps: float,
                           tau: float, q: int, inner_iters: int,
                           selection: str = "mvp", pair_batch: int = 1,
                           m: int = 0, k_rounds: int = 8,
                           max_rounds: Optional[int] = None) -> BlockState:
    """Active-set ("shrinking") cycles (the JAX package's
    _run_chunk_block_active). One CYCLE:

      1. select_block with q = m: the m most-violating rows A and the
         EXACT extrema of the full gradient (convergence is only ever
         declared from these);
      2. up to k_rounds rounds on A's views (active_cycle): the
         per-round fold is a (q, m) pass instead of (q, n);
      3. one batched fold applies the cycle's (W, coef) deltas to the
         full gradient with one (k_rounds q, n) kernel-row pass (none
         on a cycle that moved nothing), then A's rows are scattered
         back: the incrementally kept values overwrite the fold's
         regrouped ones (their Kahan residual is reset).

    f is linear in the round coefs, so deferring the non-active rows'
    fold changes the float grouping only. Requires q <= m <= n;
    max_rounds is checked at cycle granularity, so a chunk may overshoot
    it by k_rounds - 1 rounds."""
    n = y.shape[0]
    done = 0
    while _more(state, done, max_rounds, max_iter, eps):
        f_cur = eff_f(state)
        act_ids, act_ok, b_hi, b_lo = select_block(
            f_cur, state.alpha, y, c, m, valid=valid, rule=selection)
        views = (x[act_ids], y[act_ids], x_sq[act_ids], k_diag[act_ids],
                 act_ok, state.alpha[act_ids], f_cur[act_ids],
                 b_lo > b_hi + 2.0 * eps)
        a_act, f_act, pend_w, pend_c, t, k, moved = active_cycle(
            views, state.pairs, max_iter, kp, c, eps, tau, q, inner_iters,
            k_rounds, selection, pair_batch)
        f, f_err = state.f, state.f_err
        if moved:
            wf = act_ids[pend_w]
            f, f_err = maybe_kahan(f, f_err, pend_c @ kernel_rows(
                x, x_sq, x[wf], x_sq[wf], kp))
        f = scatter_alpha(f, act_ids, act_ok, f_act)
        if f_err is not None:
            f_err = scatter_alpha(f_err, act_ids, act_ok,
                                 torch.zeros_like(f_act))
        alpha = scatter_alpha(state.alpha, act_ids, act_ok, a_act)
        state = BlockState(alpha, f, b_hi, b_lo, state.pairs + t,
                           state.rounds + k, f_err)
        done += k
    return state
