"""SMO algebra shared by the port's engines, and the per-pair engines
(counterpart of dpsvm_tpu/solver/smo.py: init_state, eff_f, kahan_add,
maybe_kahan, pair_alpha_update, _apply_pair_update, _smo_iteration,
_smo_iteration_wss2, _run_chunk, _run_chunk_micro, _run_chunk_pallas).

The operation order of every expression is the JAX package's, so the
elementwise steps agree bit for bit on identical float32 inputs. Where
XLA contracts a multiply and an add into one fused multiply-add (the
rank-2 gradient update under jit), the port does too (fma32).

The per-pair loop. JAX runs it as one lax.while_loop on the device; here
the host drives it, one trip per pair update (pair_batch pairs on the
micro path), and reads each trip's observations -- the pair ids and the
extrema the loop condition tests -- in ONE small device-to-host copy
(read_obs). With the ids on the host, a kernel row is a view (x[i], a
row of the resident Gram), the row cache decides hits on the host, and
the condition ``it < max_iter and b_lo > b_hi + 2 eps`` is evaluated
there in float32, so the loop makes as many trips as JAX's cond. The
second-order rule needs its second id before it can fetch the second row,
so its trip reads twice.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import torch

from dpsvm_tpu_torch.ops.kernels import (KernelParams, kernel_from_dots,
                                         kernel_rows, row_dots)
from dpsvm_tpu_torch.ops.select import (c_of, ieee_max, select_working_set,
                                        select_working_set_nu, set_masks,
                                        split_c, take)
from dpsvm_tpu_torch.solver.cache import (CacheState, init_cache,
                                          lookup_one, lookup_pair)

_INF = float("inf")


def init_state(y: torch.Tensor) -> tuple:
    """The C-SVC start point (alpha, f, b_hi, b_lo): alpha = 0, f = -y,
    and extrema that read as an open gap so the first round always
    runs."""
    dev = y.device
    return (torch.zeros_like(y, dtype=torch.float32),
            (-y).float(),
            torch.tensor(-float("inf"), dtype=torch.float32, device=dev),
            torch.tensor(float("inf"), dtype=torch.float32, device=dev))


def eff_f(state):
    """The best estimate of the true gradient: f minus the Kahan residual
    when compensation is on."""
    return state.f if state.f_err is None else state.f - state.f_err


def kahan_add(f, err, delta):
    """One compensated (Kahan) accumulation step: returns the new (f, err)
    with true_sum ~= f - err."""
    y_v = delta - err
    t = f + y_v
    return t, (t - f) - y_v


def maybe_kahan(f, err, delta):
    """Plain add when compensation is off (err is None), Kahan otherwise."""
    if err is None:
        return f + delta, None
    return kahan_add(f, err, delta)


def fma32(a, b, c):
    """a * b + c rounded once to float32, as XLA on the CPU computes the
    JAX package's gradient updates f + (da * y) * row (it contracts both
    adds into fused multiply-adds). The float64 product of two float32
    values is exact; the float64 sum then rounds twice (to float64, then
    float32), which differs from one rounding only at exact float32
    midpoints of the float64 result."""
    return (a.double() * b.double() + c.double()).float()


def pair_alpha_update(a_hi_old, a_lo_old, y_hi, y_lo, b_hi_pair, b_lo_pair,
                      eta, c_hi, c_lo=None, gate=None):
    """The alpha-pair algebra: returns (a_hi_new, a_lo_new).

    a_lo is clipped to the joint feasible segment [L, H] (box intersected
    with the equality-constraint line), snapped to the box bounds within
    1e-6 * C, and a_hi is derived from it so sum(alpha * y) is conserved.
    `c_hi`/`c_lo` are Python floats (equal class weights: the snap
    constants are then computed in double and rounded once, as the JAX
    package does) or float32 tensors. `gate` (bool tensor) forces a
    no-op when False; non-finite pair values are always gated out."""
    if c_lo is None:
        c_lo = c_hi
    ok = torch.isfinite(b_hi_pair) & torch.isfinite(b_lo_pair)
    if gate is not None:
        ok = ok & gate
    s = y_hi * y_lo
    w = a_hi_old + s * a_lo_old
    lo_bound = torch.where(s > 0, torch.clamp(w - c_hi, min=0.0),
                           torch.clamp(-w, min=0.0))
    hi_bound = torch.where(s > 0, torch.clamp(w, max=c_lo),
                           torch.clamp(c_hi - w, max=c_lo))
    a_lo_new = torch.clamp(a_lo_old + y_lo * (b_hi_pair - b_lo_pair) / eta,
                           min=lo_bound, max=hi_bound)
    snap_lo = 1e-6 * c_lo
    snap_hi = 1e-6 * c_hi
    a_lo_new = torch.where(a_lo_new < snap_lo, 0.0,
                           torch.where(a_lo_new > c_lo - snap_lo, c_lo,
                                       a_lo_new))
    a_hi_new = torch.clamp(a_hi_old + s * (a_lo_old - a_lo_new),
                           min=0.0).clamp(max=c_hi)
    a_hi_new = torch.where(a_hi_new < snap_hi, 0.0,
                           torch.where(a_hi_new > c_hi - snap_hi, c_hi,
                                       a_hi_new))
    a_lo_new = torch.where(ok, a_lo_new, a_lo_old)
    a_hi_new = torch.where(ok, a_hi_new, a_hi_old)
    return a_hi_new, a_lo_new


# ---------------------------------------------------------------------
# The per-pair engines.

class SMOState(NamedTuple):
    """The per-pair loop's carry. alpha and f live on the solve's device
    (alpha is updated in place by the loop); the extrema of the last
    selection, the counters and the cache's bookkeeping live on the
    host."""

    alpha: torch.Tensor  # (n,) float32
    f: torch.Tensor  # (n,) float32
    b_hi: float  # float32 values; (-inf, inf) before the first trip
    b_lo: float
    it: int  # pair updates (attempted slots on the micro path)
    cache: Optional[CacheState]
    hits: int  # cache hits
    f_err: Optional[torch.Tensor] = None  # Kahan residual (compensated)


def init_pair_state(y: torch.Tensor, cache_lines: int = 0,
                    compensated: bool = False) -> SMOState:
    """The per-pair start point: alpha = 0, f = -y, an open gap, and an
    empty row cache of `cache_lines` lines (none when 0)."""
    alpha, f, _, _ = init_state(y)
    cache = (init_cache(cache_lines, y.shape[0], y.device)
             if cache_lines else None)
    return SMOState(alpha, f, -_INF, _INF, 0, cache, 0,
                    torch.zeros_like(f) if compensated else None)


def read_obs(ids=(), vals=()) -> tuple:
    """ONE device-to-host copy of a trip's observations: `ids` 0-d
    integer tensors, `vals` 0-d float32 tensors. Returns (ints, floats)
    as Python lists; the floats are the float32 values exactly."""
    parts = ([t.reshape(1).to(torch.int32) for t in ids]
             + [t.reshape(1).float().view(torch.int32) for t in vals])
    arr = torch.cat(parts).cpu().numpy()
    k = len(ids)
    return ([int(v) for v in arr[:k]],
            [float(v) for v in arr[k:].view(np.float32)])


def gap_open(b_hi: float, b_lo: float, eps: float) -> bool:
    """The loop's stopping test b_lo > b_hi + 2 eps in float32, as the
    JAX package compiles it (2 eps rounded to float32, one float32 add)."""
    return bool(np.float32(b_lo) > np.float32(b_hi) + np.float32(2.0 * eps))


def pair_dots(x, cache, i_hi: int, i_lo: int, it: int) -> tuple:
    """(d_hi, d_lo, n_hits): the pair's dot rows, through the cache when
    there is one, else one (2, d) x (d, n) product."""
    if cache is not None:
        return lookup_pair(cache, x, i_hi, i_lo, it)
    d2 = row_dots(x, torch.stack([x[i_hi], x[i_lo]]))
    return d2[0], d2[1], 0


def _pair_step(alpha, y, i_hi: int, i_lo: int, b_hi_pair, b_lo_pair, eta,
               c, gate=None) -> tuple:
    """The pair algebra and the alpha scatter (in place; lo first, then
    hi, so hi wins when i_hi == i_lo). Returns the rank-2 update's
    coefficients (coef_hi, coef_lo) = (delta alpha * y) of the pair."""
    cp, cn = split_c(c)
    y_hi, y_lo = y[i_hi], y[i_lo]
    a_hi_old, a_lo_old = alpha[i_hi], alpha[i_lo]
    a_hi_new, a_lo_new = pair_alpha_update(
        a_hi_old, a_lo_old, y_hi, y_lo, b_hi_pair, b_lo_pair, eta,
        c_of(y_hi, cp, cn), c_of(y_lo, cp, cn), gate)
    coef_hi = (a_hi_new - a_hi_old) * y_hi
    coef_lo = (a_lo_new - a_lo_old) * y_lo
    # Every read of the old values is queued before these writes.
    alpha[i_lo] = a_lo_new
    alpha[i_hi] = a_hi_new
    return coef_hi, coef_lo


def apply_pair_update(state: SMOState, y, i_hi: int, i_lo: int, b_hi_pair,
                      b_lo_pair, k_hi, k_lo, eta, c, gate=None) -> tuple:
    """The shared tail of a per-pair iteration: the pair step and the
    rank-2 gradient update, in two fused multiply-adds as XLA computes
    it (Kahan-compensated when the state carries f_err). Returns
    (alpha, f, f_err)."""
    coef_hi, coef_lo = _pair_step(state.alpha, y, i_hi, i_lo, b_hi_pair,
                                  b_lo_pair, eta, c, gate)
    if state.f_err is None:
        return state.alpha, fma32(coef_lo, k_lo,
                                  fma32(coef_hi, k_hi, state.f)), None
    f, err = maybe_kahan(state.f, state.f_err,
                         fma32(coef_lo, k_lo, coef_hi * k_hi))
    return state.alpha, f, err


def smo_iteration(x, y, x_sq, k_diag, valid, state: SMOState,
                  kp: KernelParams, c, tau: float,
                  select_fn=select_working_set) -> SMOState:
    """One maximal-violating-pair iteration (JAX _smo_iteration). With
    kp.kind == "precomputed" x is the resident Gram and the pair's kernel
    rows are its rows. `select_fn` swaps the pairing rule:
    select_working_set_nu keeps the pair within one class (the nu
    duals); everything after the selection is the same."""
    i_hi, b_hi, i_lo, b_lo = select_fn(eff_f(state), state.alpha, y, c,
                                       valid)
    (ih, il), (bh, bl) = read_obs((i_hi, i_lo), (b_hi, b_lo))
    if kp.kind == "precomputed":
        k_hi, k_lo, n_hits = x[ih], x[il], 0
    else:
        d_hi, d_lo, n_hits = pair_dots(x, state.cache, ih, il, state.it)
        k_hi = kernel_from_dots(d_hi, x_sq, x_sq[ih], kp)
        k_lo = kernel_from_dots(d_lo, x_sq, x_sq[il], kp)
    # eta = K(hi,hi) + K(lo,lo) - 2 K(hi,lo), clamped below at tau.
    eta = torch.clamp(k_hi[ih] + k_lo[il] - 2.0 * k_hi[il], min=tau)
    alpha, f, f_err = apply_pair_update(state, y, ih, il, b_hi, b_lo, k_hi,
                                        k_lo, eta, c)
    return SMOState(alpha, f, bh, bl, state.it + 1, state.cache,
                    state.hits + n_hits, f_err)


def _wss2_row(x, x_sq, kp, cache, i: int, stamp: int) -> tuple:
    """(kernel row of row i, hit) for the second-order rule."""
    if kp.kind == "precomputed":
        return x[i], False
    if cache is not None:
        d, hit = lookup_one(cache, x, i, stamp)
    else:
        d, hit = row_dots(x, x[i]), False
    return kernel_from_dots(d, x_sq, x_sq[i], kp), hit


def smo_iteration_wss2(x, y, x_sq, k_diag, valid, state: SMOState,
                       kp: KernelParams, c, tau: float) -> SMOState:
    """One second-order (WSS2) iteration (JAX _smo_iteration_wss2): i by
    maximal violation, j by the largest gain (f_j - f_i)^2 / eta_ij over
    the eligible I_low; with no eligible j the update degenerates to a
    no-op on (i, i)."""
    f_cur = eff_f(state)
    up, low = set_masks(state.alpha, y, c, valid)
    f_up = torch.where(up, f_cur, _INF)
    i_hi = torch.argmin(f_up)
    b_hi = take(f_up, i_hi)
    b_lo = ieee_max(torch.where(low, f_cur, -_INF))
    (ih,), (bh, bl) = read_obs((i_hi,), (b_hi, b_lo))
    stamp = 2 * state.it
    k_hi, hit_hi = _wss2_row(x, x_sq, kp, state.cache, ih, stamp + 1)
    if state.cache is not None and k_hi.untyped_storage().data_ptr() == \
            state.cache.data.untyped_storage().data_ptr():
        k_hi = k_hi.clone()  # the lo lookup may rewrite the line it views
    diff = f_cur - b_hi
    eta_j = torch.clamp(k_diag[ih] + k_diag - 2.0 * k_hi, min=tau)
    gain = torch.where(low & (diff > 0), diff * diff / eta_j, -_INF)
    any_elig = (gain > -_INF).any()
    (j, elig), _ = read_obs((torch.argmax(gain), any_elig))
    il = j if elig else ih
    k_lo, hit_lo = _wss2_row(x, x_sq, kp, state.cache, il, stamp + 2)
    eta = torch.clamp(k_diag[ih] + k_diag[il] - 2.0 * k_hi[il], min=tau)
    alpha, f, f_err = apply_pair_update(state, y, ih, il, b_hi, f_cur[il],
                                        k_hi, k_lo, eta, c, gate=any_elig)
    return SMOState(alpha, f, bh, bl, state.it + 1, state.cache,
                    state.hits + int(hit_hi) + int(hit_lo), f_err)


_ITERATION_FNS = {
    "mvp": smo_iteration,
    "second_order": smo_iteration_wss2,
    # Per-class pairs for the nu duals (set by models/nusvm.py).
    "nu": partial(smo_iteration, select_fn=select_working_set_nu),
}


def run_chunk(x, y, x_sq, k_diag, valid, state: SMOState, max_iter: int,
              kp: KernelParams, c, eps: float, tau: float,
              selection: str = "mvp") -> SMOState:
    """Per-pair iterations while it < max_iter and the gap of the last
    selection is open (JAX _run_chunk, run unobserved). The last trip is
    the one whose selection shows the closed gap: its update still runs
    (the reference's final degenerate update) and counts."""
    step = _ITERATION_FNS[selection]
    state = state._replace(alpha=state.alpha.clone())
    while state.it < max_iter and gap_open(state.b_hi, state.b_lo, eps):
        state = step(x, y, x_sq, k_diag, valid, state, kp, c, tau)
    return state


def _micro_trip(x, y, x_sq, k_diag, valid, state: SMOState, end: int,
                kp: KernelParams, c, eps: float, tau: float,
                k: int) -> SMOState:
    """One trip of the micro-batched executor (JAX _run_chunk_micro's
    body): the k most-violating disjoint pairs from ONE selection, their
    2k kernel rows in one pass, k corrected-gradient pair updates against
    the (2k, 2k) cross block, one rank-2k fold."""
    from dpsvm_tpu_torch.solver.block import _top_h

    cp, cn = split_c(c)
    n = y.shape[0]
    f_cur = eff_f(state)
    up, low = set_masks(state.alpha, y, c, valid)
    scores = torch.stack([torch.where(up, -f_cur, -_INF),
                          torch.where(low, f_cur, -_INF)])
    vals, ids = _top_h(scores, k)  # sorted, ties lowest index first
    up_v, up_i = vals[0], ids[0]  # ascending f: rank 0 = b_hi
    low_v, low_i = vals[1], ids[1]  # descending f: rank 0 = b_lo
    up_ok = torch.isfinite(up_v)
    low_ok = torch.isfinite(low_v)
    # A free point can top both lists: collisions are resolved by rank
    # order below, so the rank-0 maximal pair always executes.
    collide = low_i[:, None] == up_i[None, :]  # [low rank, up rank]
    idx = torch.cat([up_i, low_i])
    rows = kernel_rows(x, x_sq, x[idx], x_sq[idx], kp)  # (2k, n)
    m = rows[:, idx]  # (2k, 2k)
    kd, a, fv, yv = k_diag[idx], state.alpha[idx], f_cur[idx], y[idx]
    coef = torch.zeros(2 * k, dtype=torch.float32, device=y.device)
    # Pair j is attempted while it + j < end; attempted slots count even
    # when gated to a no-op, and the rest never run.
    tried = min(k, end - state.it)
    no = torch.zeros((), dtype=torch.bool, device=y.device)
    applied = []
    for j in range(tried):
        i_s, l_s = j, k + j
        bad = collide[j, j]
        for p in range(j):
            bad = bad | ((collide[p, j] | collide[j, p]) & applied[p])
        ok = up_ok[j] & low_ok[j] & ~bad
        fe_i = fv[i_s] + coef @ m[:, i_s]  # corrected gradient
        fe_l = fv[l_s] + coef @ m[:, l_s]
        gate = ok if j == 0 else ok & (fe_l > fe_i + 2.0 * eps)
        eta = torch.clamp(kd[i_s] + kd[l_s] - 2.0 * m[i_s, l_s], min=tau)
        na_i, na_l = pair_alpha_update(
            a[i_s], a[l_s], yv[i_s], yv[l_s], fe_i, fe_l, eta,
            c_of(yv[i_s], cp, cn), c_of(yv[l_s], cp, cn), gate=gate)
        coef[i_s] += (na_i - a[i_s]) * yv[i_s]
        coef[l_s] += (na_l - a[l_s]) * yv[l_s]
        a[i_s] = na_i
        a[l_s] = na_l
        applied.append(gate)
    applied += [no] * (k - tried)
    f, f_err = maybe_kahan(state.f, state.f_err, coef @ rows)
    # Scatter: dead filler never writes; of two pairs sharing a
    # coordinate at most one applied, and the other's stale slots are
    # dropped.
    applied_v = torch.stack(applied)
    share = collide | collide.T
    conflict = ~applied_v & (share & applied_v[None, :]).any(dim=1)
    slot_ok = torch.cat([up_ok, low_ok]) & (~conflict).repeat(2)
    buf = torch.cat([state.alpha, state.alpha.new_zeros(1)])
    buf[torch.where(slot_ok, idx, n)] = torch.where(slot_ok, a, 0.0)
    _, (bh, bl) = read_obs((), (-up_v[0], low_v[0]))
    return SMOState(buf[:n], f, bh, bl, state.it + tried, state.cache,
                    state.hits, f_err)


def run_chunk_micro(x, y, x_sq, k_diag, valid, state: SMOState,
                    max_iter: int, kp: KernelParams, c, eps: float,
                    tau: float, k: int) -> SMOState:
    """Micro-batched per-pair trips (pair_batch = k > 1 on
    engine="xla", mvp selection; JAX _run_chunk_micro): stale rank-j
    pairs with every update's extrema corrected to the post-previous-
    updates gradient. Pairs j >= 1 also gate on the stopping margin;
    the top-k is clamped to n."""
    k = min(k, int(y.shape[0]))
    while state.it < max_iter and gap_open(state.b_hi, state.b_lo, eps):
        state = _micro_trip(x, y, x_sq, k_diag, valid, state, max_iter, kp,
                            c, eps, tau, k)
    return state


def pallas_pair_update(x, y, x_sq, kp: KernelParams, c, tau: float,
                       cache, alpha, i_hi: int, i_lo: int, b_hi, b_lo,
                       it: int) -> tuple:
    """The part of a pipelined trip before kernel B6: the pair's dot
    rows (through the cache), eta from the three kernel values, the pair
    algebra and the alpha scatter (in place, lo first, then hi). Returns
    (d_hi, d_lo, scalars, n_hits), scalars = (coef_hi, coef_lo, qsq_hi,
    qsq_lo) as B6 takes them."""
    d_hi, d_lo, n_hits = pair_dots(x, cache, i_hi, i_lo, it)
    qsq_hi, qsq_lo = x_sq[i_hi], x_sq[i_lo]
    k_hh = kernel_from_dots(d_hi[i_hi], qsq_hi, qsq_hi, kp)
    k_ll = kernel_from_dots(d_lo[i_lo], qsq_lo, qsq_lo, kp)
    k_hl = kernel_from_dots(d_hi[i_lo], qsq_lo, qsq_hi, kp)
    eta = torch.clamp(k_hh + k_ll - 2.0 * k_hl, min=tau)
    coef_hi, coef_lo = _pair_step(alpha, y, i_hi, i_lo, b_hi, b_lo, eta, c)
    return (d_hi, d_lo, torch.stack([coef_hi, coef_lo, qsq_hi, qsq_lo]),
            n_hits)


def run_chunk_pallas(x, y, x_sq, valid, state: SMOState, max_iter: int,
                     kp: KernelParams, c, eps: float, tau: float) -> SMOState:
    """The software-pipelined per-pair loop on kernel B6 (JAX
    _run_chunk_pallas): each trip applies pair t's rank-2 update AND
    selects pair t+1 in one pass over f (ops/fused_update.py
    fused_update_select). One select_working_set seeds the carried pair.

    Needs n padded to a multiple of 128 with `valid` marking real rows.
    The loop stops as soon as a post-update selection shows convergence,
    skipping the reference's final degenerate update, so its iteration
    count may differ from engine="xla" by one."""
    from dpsvm_tpu_torch.ops.fused_update import LANES, fused_update_select

    n_pad = y.shape[0]
    shp = (n_pad // LANES, LANES)
    y2d = y.view(shp)
    valid2d = valid.float().view(shp)
    x_sq2d = x_sq.view(shp)
    alpha = state.alpha.clone()
    f = state.f
    i_hi, b_hi, i_lo, b_lo = select_working_set(f, alpha, y, c, valid)
    (ih, il), (bh, bl) = read_obs((i_hi, i_lo), (b_hi, b_lo))
    it, hits = state.it, state.hits
    while it < max_iter and gap_open(bh, bl, eps):
        d_hi, d_lo, scalars, n_hits = pallas_pair_update(
            x, y, x_sq, kp, c, tau, state.cache, alpha, ih, il, b_hi, b_lo,
            it)
        f2d, b_hi, i_hi, b_lo, i_lo = fused_update_select(
            f.view(shp), alpha.view(shp), y2d, valid2d, d_hi.view(shp),
            d_lo.view(shp), x_sq2d, scalars, kp, c)
        f = f2d.view(n_pad)
        it += 1
        hits += n_hits
        (ih, il), (bh, bl) = read_obs((i_hi, i_lo), (b_hi, b_lo))
    return SMOState(alpha, f, bh, bl, it, state.cache, hits)
