"""SMO algebra shared by the port's engines, and the per-pair engines
(counterpart of dpsvm_tpu/solver/smo.py: init_state, eff_f, kahan_add,
maybe_kahan, pair_alpha_update, _apply_pair_update, _smo_iteration,
_smo_iteration_wss2, _run_chunk, _run_chunk_micro, _run_chunk_pallas).

The operation order of every expression is the JAX package's, so the
elementwise steps agree bit for bit on identical float32 inputs. Where
XLA contracts a multiply and an add into one fused multiply-add (the
rank-2 gradient update under jit), the port does too (fma32).

The per-pair loop. JAX runs a chunk as one lax.while_loop on the
device, and so does the port, as far as eager torch can: every trip
(one pair update; pair_batch pairs on the micro path) is queued on the
solve's device with no host read inside it. The pair ids, the carried
extrema, the pair and hit counters, the row cache's keys and ticks
(solver/cache.py) and the loop's condition ``it < end and b_lo > b_hi +
2 eps`` (float32, trip_active) all stay there; kernel rows are taken
with index_select. The host queues TRIPS trips, reads (it, b_hi, b_lo,
the stop flag) once, and repeats until the chunk's end or a closed gap
(queue_trips). A trip queued after the stop is masked: every write it
makes is gated with torch.where (as solver/fleet.py masks its frozen
problems), so it leaves alpha, f, f_err, the extrema, the counters and
the cache bit for bit as they were, and the loop's result does not
depend on TRIPS.
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

#: Trips a per-pair runner queues between two host reads. A trip queued
#: after the loop's stop is masked and changes nothing, so the value
#: moves no result, only how many trips the host enqueues blind (up to
#: TRIPS - 1 a stop) against how often it waits for the device. 8 was
#: the fastest or within the spread of the fastest of 1, 8, 32 and 256
#: on an H100 for the headline, the reconstruction leg and the
#: multiclass twins (tools/perpair_trips.py): at 256 the many short
#: solves of a multiclass job pay the masked trips.
TRIPS = 8


class SMOState(NamedTuple):
    """The per-pair loop's carry, all of it on the solve's device (alpha
    is updated in place by the loop, the cache's lines, keys and ticks
    too)."""

    alpha: torch.Tensor  # (n,) float32
    f: torch.Tensor  # (n,) float32
    b_hi: torch.Tensor  # 0-d float32; (-inf, inf) before the first trip
    b_lo: torch.Tensor
    it: torch.Tensor  # 0-d int64 pair updates (attempted micro slots)
    cache: Optional[CacheState]
    hits: torch.Tensor  # 0-d int64 cache hits
    f_err: Optional[torch.Tensor] = None  # Kahan residual (compensated)


def init_pair_state(y: torch.Tensor, cache_lines: int = 0,
                    compensated: bool = False) -> SMOState:
    """The per-pair start point: alpha = 0, f = -y, an open gap, and an
    empty row cache of `cache_lines` lines (none when 0)."""
    alpha, f, b_hi, b_lo = init_state(y)
    cache = (init_cache(cache_lines, y.shape[0], y.device)
             if cache_lines else None)
    zero = torch.zeros((), dtype=torch.int64, device=y.device)
    return SMOState(alpha, f, b_hi, b_lo, zero, cache, zero.clone(),
                    torch.zeros_like(f) if compensated else None)


def read_obs(ids=(), vals=()) -> tuple:
    """ONE device-to-host copy of observations: `ids` 0-d integer (or
    bool) tensors, `vals` 0-d float32 tensors. Returns (ints, floats) as
    Python lists; the floats are the float32 values exactly."""
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


def trip_active(state: SMOState, end: int,
                eps2: torch.Tensor) -> torch.Tensor:
    """The loop's condition for the next trip, on the device (0-d bool):
    pairs left (it < end) and the carried gap open, b_lo > b_hi + eps2
    with eps2 = 2 eps rounded to float32 (two_eps), so the decision is
    gap_open's and the JAX package's bit for bit."""
    return (state.it < end) & (state.b_lo > state.b_hi + eps2)


def two_eps(eps: float, device) -> torch.Tensor:
    """2 eps rounded to float32, as a 0-d tensor on `device` (filled
    there: no host-to-device copy, which would synchronize)."""
    return torch.full((), float(np.float32(2.0 * eps)), dtype=torch.float32,
                      device=device)


def queue_trips(trip, carry, end: int, eps: float, *, state_of=None,
                it_host: Optional[int] = None, pairs_a_trip: int = 1,
                tally: Optional[dict] = None):
    """The per-pair loop of one chunk, on the device: ``trip(carry,
    active)`` is queued TRIPS times (the module's value at the call),
    then the host reads (it, the stop
    flag, b_hi, b_lo) in ONE read_obs, and again until the chunk's end
    (`end` pairs) or a closed gap. A trip queued after the stop gets
    active False and leaves the carry bit for bit as it was. With the
    carry's pair count known on the host (`it_host`), a batch is cut to
    the trips the pairs left can take (`pairs_a_trip` pairs a trip), so
    a budget exit queues no masked trip. `state_of(carry)` is the
    carry's SMOState (the carry itself by default); `tally` gains the
    trips queued ("trips") and host reads ("reads")."""
    state_of = state_of or (lambda cr: cr)
    eps2 = two_eps(eps, state_of(carry).alpha.device)
    left = None if it_host is None else end - it_host
    trips = TRIPS
    while left is None or left > 0:
        batch = trips if left is None else min(trips,
                                               -(-left // pairs_a_trip))
        for _ in range(batch):
            carry = trip(carry, trip_active(state_of(carry), end, eps2))
        st = state_of(carry)
        (it, go), _ = read_obs((st.it, trip_active(st, end, eps2)),
                               (st.b_hi, st.b_lo))
        if tally is not None:
            tally["trips"] = tally.get("trips", 0) + batch
            tally["reads"] = tally.get("reads", 0) + 1
        if not go:
            break
        left = end - it
    return carry


def _advance(state: SMOState, alpha, f, f_err, b_hi, b_lo, pairs, n_hits,
             active) -> SMOState:
    """The carry after a trip: f, f_err, the extrema and the pair count
    move only where the trip is active (torch.where, never a zero
    coefficient: a -0.0 gradient does not survive a +0.0 term); alpha,
    the cache and the hits (`n_hits`, 0 on a masked trip) were written
    under the same gate."""
    keep = (lambda new, old: old if new is None
            else torch.where(active, new, old))
    hits = state.hits if n_hits is None else state.hits + n_hits
    step = active if isinstance(pairs, int) and pairs == 1 \
        else torch.where(active, pairs, 0)
    return SMOState(alpha, keep(f, state.f), keep(b_hi, state.b_hi),
                    keep(b_lo, state.b_lo), state.it + step, state.cache,
                    hits, keep(f_err, state.f_err))


def pair_dots(x, cache, pair, it, active) -> tuple:
    """(dot rows (2, n), n_hits or None): the pair's dot rows, through
    the cache when there is one, else one (2, d) x (d, n) product.
    `pair` is the (2,) device tensor (i_hi, i_lo), `it` a 0-d one."""
    if cache is not None:
        return lookup_pair(cache, x, pair[0], pair[1], it, active)
    return row_dots(x, x.index_select(0, pair)), None


def pair_kernel_rows(x, x_sq, kp: KernelParams, cache, pair, it,
                     active) -> tuple:
    """(k_hi, k_lo, n_hits or None): the pair's kernel rows. With
    kp.kind == "precomputed" x is the resident Gram and they are its
    rows."""
    if kp.kind == "precomputed":
        k2 = x.index_select(0, pair)
        return k2[0], k2[1], None
    d2, n_hits = pair_dots(x, cache, pair, it, active)
    qsq = x_sq.index_select(0, pair)
    return (kernel_from_dots(d2[0], x_sq, qsq[0], kp),
            kernel_from_dots(d2[1], x_sq, qsq[1], kp), n_hits)


def _pair_step(alpha, y, pair, b_hi_pair, b_lo_pair, eta, c,
               gate) -> tuple:
    """The pair algebra and the alpha scatter (in place; lo first, then
    hi, so hi wins when i_hi == i_lo; a closed `gate` writes the old
    values back). `pair` is the (2,) device tensor (i_hi, i_lo).
    Returns the rank-2 update's coefficients (coef_hi, coef_lo) =
    (delta alpha * y) of the pair."""
    cp, cn = split_c(c)
    y2, a2 = y.index_select(0, pair), alpha.index_select(0, pair)
    y_hi, y_lo, a_hi_old, a_lo_old = y2[0], y2[1], a2[0], a2[1]
    a_hi_new, a_lo_new = pair_alpha_update(
        a_hi_old, a_lo_old, y_hi, y_lo, b_hi_pair, b_lo_pair, eta,
        c_of(y_hi, cp, cn), c_of(y_lo, cp, cn), gate)
    coef_hi = (a_hi_new - a_hi_old) * y_hi
    coef_lo = (a_lo_new - a_lo_old) * y_lo
    # Every read of the old values is queued before these writes.
    alpha.index_copy_(0, pair[1:], a_lo_new.reshape(1))
    alpha.index_copy_(0, pair[:1], a_hi_new.reshape(1))
    return coef_hi, coef_lo


def apply_pair_update(state: SMOState, y, pair, b_hi_pair, b_lo_pair,
                      k_hi, k_lo, eta, c, active, gate=None) -> tuple:
    """The shared tail of a per-pair iteration: the pair step and the
    rank-2 gradient update, in two fused multiply-adds as XLA computes
    it (Kahan-compensated when the state carries f_err). `gate` closes
    the pair algebra only (the update still runs, with zero deltas, as
    in JAX); an inactive trip changes nothing. Returns (alpha, f,
    f_err), f and f_err before the trip's gate (_advance applies it)."""
    coef_hi, coef_lo = _pair_step(state.alpha, y, pair, b_hi_pair,
                                  b_lo_pair, eta, c,
                                  active if gate is None else active & gate)
    if state.f_err is None:
        return state.alpha, fma32(coef_lo, k_lo,
                                  fma32(coef_hi, k_hi, state.f)), None
    f, err = maybe_kahan(state.f, state.f_err,
                         fma32(coef_lo, k_lo, coef_hi * k_hi))
    return state.alpha, f, err


def smo_iteration(x, y, x_sq, k_diag, valid, state: SMOState,
                  kp: KernelParams, c, tau: float, active,
                  select_fn=select_working_set) -> SMOState:
    """One maximal-violating-pair iteration (JAX _smo_iteration), gated
    by `active`. `select_fn` swaps the pairing rule:
    select_working_set_nu keeps the pair within one class (the nu
    duals); everything after the selection is the same."""
    i_hi, b_hi, i_lo, b_lo = select_fn(eff_f(state), state.alpha, y, c,
                                       valid)
    pair = torch.stack([i_hi, i_lo])
    k_hi, k_lo, n_hits = pair_kernel_rows(x, x_sq, kp, state.cache, pair,
                                          state.it, active)
    # eta = K(hi,hi) + K(lo,lo) - 2 K(hi,lo), clamped below at tau.
    eta = torch.clamp(take(k_hi, i_hi) + take(k_lo, i_lo)
                      - 2.0 * take(k_hi, i_lo), min=tau)
    alpha, f, f_err = apply_pair_update(state, y, pair, b_hi, b_lo, k_hi,
                                        k_lo, eta, c, active)
    return _advance(state, alpha, f, f_err, b_hi, b_lo, 1, n_hits, active)


def _wss2_row(x, x_sq, kp, cache, i, stamp, active) -> tuple:
    """(kernel row of row i, hit or None) for the second-order rule."""
    if kp.kind == "precomputed":
        return x.index_select(0, i.reshape(1))[0], None
    if cache is not None:
        d, hit = lookup_one(cache, x, i, stamp, active)
    else:
        d, hit = row_dots(x, x.index_select(0, i.reshape(1)))[0], None
    return kernel_from_dots(d, x_sq, take(x_sq, i), kp), hit


def smo_iteration_wss2(x, y, x_sq, k_diag, valid, state: SMOState,
                       kp: KernelParams, c, tau: float,
                       active) -> SMOState:
    """One second-order (WSS2) iteration (JAX _smo_iteration_wss2), gated
    by `active`: i by maximal violation, j by the largest gain
    (f_j - f_i)^2 / eta_ij over the eligible I_low; with no eligible j
    the update degenerates to a no-op on (i, i). The two rows are
    looked up in turn, both on the device."""
    f_cur = eff_f(state)
    up, low = set_masks(state.alpha, y, c, valid)
    f_up = torch.where(up, f_cur, _INF)
    i_hi = torch.argmin(f_up)
    b_hi = take(f_up, i_hi)
    b_lo = ieee_max(torch.where(low, f_cur, -_INF))
    stamp = 2 * state.it
    k_hi, hit_hi = _wss2_row(x, x_sq, kp, state.cache, i_hi, stamp + 1,
                             active)
    kd_hi = take(k_diag, i_hi)
    diff = f_cur - b_hi
    eta_j = torch.clamp(kd_hi + k_diag - 2.0 * k_hi, min=tau)
    gain = torch.where(low & (diff > 0), diff * diff / eta_j, -_INF)
    any_elig = (gain > -_INF).any()
    i_lo = torch.where(any_elig, torch.argmax(gain), i_hi)
    k_lo, hit_lo = _wss2_row(x, x_sq, kp, state.cache, i_lo, stamp + 2,
                             active)
    eta = torch.clamp(kd_hi + take(k_diag, i_lo) - 2.0 * take(k_hi, i_lo),
                      min=tau)
    alpha, f, f_err = apply_pair_update(
        state, y, torch.stack([i_hi, i_lo]), b_hi, take(f_cur, i_lo), k_hi,
        k_lo, eta, c, active, gate=any_elig)
    n_hits = None if hit_hi is None else hit_hi.long() + hit_lo.long()
    return _advance(state, alpha, f, f_err, b_hi, b_lo, 1, n_hits, active)


_ITERATION_FNS = {
    "mvp": smo_iteration,
    "second_order": smo_iteration_wss2,
    # Per-class pairs for the nu duals (set by models/nusvm.py).
    "nu": partial(smo_iteration, select_fn=select_working_set_nu),
}


def run_chunk(x, y, x_sq, k_diag, valid, state: SMOState, max_iter: int,
              kp: KernelParams, c, eps: float, tau: float,
              selection: str = "mvp", *,
              it_host: Optional[int] = None,
              tally: Optional[dict] = None) -> SMOState:
    """Per-pair iterations while it < max_iter and the gap of the last
    selection is open (JAX _run_chunk), queued TRIPS at a time with one
    host read between batches (queue_trips). The last trip is the one
    whose selection shows the closed gap: its update still runs (the
    reference's final degenerate update) and counts."""
    step = _ITERATION_FNS[selection]
    state = state._replace(alpha=state.alpha.clone())
    return queue_trips(
        lambda st, active: step(x, y, x_sq, k_diag, valid, st, kp, c, tau,
                                active),
        state, max_iter, eps, it_host=it_host, tally=tally)


def _micro_trip(x, y, x_sq, k_diag, valid, state: SMOState, end: int,
                kp: KernelParams, c, eps: float, tau: float, k: int,
                active) -> SMOState:
    """One trip of the micro-batched executor (JAX _run_chunk_micro's
    body), gated by `active`: the k most-violating disjoint pairs from
    ONE selection, their 2k kernel rows in one pass, k corrected-gradient
    pair updates against the (2k, 2k) cross block, one rank-2k fold."""
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
    applied = []
    for j in range(k):
        i_s, l_s = j, k + j
        bad = collide[j, j]
        for p in range(j):
            bad = bad | ((collide[p, j] | collide[j, p]) & applied[p])
        ok = up_ok[j] & low_ok[j] & ~bad
        fe_i = fv[i_s] + coef @ m[:, i_s]  # corrected gradient
        fe_l = fv[l_s] + coef @ m[:, l_s]
        # Pair j is attempted while it + j < end (pair 0 always, on an
        # active trip); attempted slots count even when gated to a
        # no-op, and the rest never apply.
        gate = ok if j == 0 else (ok & (state.it + j < end)
                                  & (fe_l > fe_i + 2.0 * eps))
        eta = torch.clamp(kd[i_s] + kd[l_s] - 2.0 * m[i_s, l_s], min=tau)
        na_i, na_l = pair_alpha_update(
            a[i_s], a[l_s], yv[i_s], yv[l_s], fe_i, fe_l, eta,
            c_of(yv[i_s], cp, cn), c_of(yv[l_s], cp, cn), gate=gate)
        coef[i_s] += (na_i - a[i_s]) * yv[i_s]
        coef[l_s] += (na_l - a[l_s]) * yv[l_s]
        a[i_s] = na_i
        a[l_s] = na_l
        applied.append(gate)
    f, f_err = maybe_kahan(state.f, state.f_err, coef @ rows)
    # Scatter: dead filler never writes; of two pairs sharing a
    # coordinate at most one applied, and the other's stale slots are
    # dropped; a masked trip writes nothing.
    applied_v = torch.stack(applied)
    share = collide | collide.T
    conflict = ~applied_v & (share & applied_v[None, :]).any(dim=1)
    slot_ok = (torch.cat([up_ok, low_ok]) & (~conflict).repeat(2)
               & active)
    buf = torch.cat([state.alpha, state.alpha.new_zeros(1)])
    buf[torch.where(slot_ok, idx, n)] = torch.where(slot_ok, a, 0.0)
    tried = torch.clamp(end - state.it, max=k)
    return _advance(state, buf[:n], f, f_err, -up_v[0], low_v[0], tried,
                    None, active)


def run_chunk_micro(x, y, x_sq, k_diag, valid, state: SMOState,
                    max_iter: int, kp: KernelParams, c, eps: float,
                    tau: float, k: int, *,
                    it_host: Optional[int] = None,
                    tally: Optional[dict] = None) -> SMOState:
    """Micro-batched per-pair trips (pair_batch = k > 1 on
    engine="xla", mvp selection; JAX _run_chunk_micro): stale rank-j
    pairs with every update's extrema corrected to the post-previous-
    updates gradient. Pairs j >= 1 also gate on the stopping margin;
    the top-k is clamped to n. Queued as run_chunk's trips are."""
    k = min(k, int(y.shape[0]))
    return queue_trips(
        lambda st, active: _micro_trip(x, y, x_sq, k_diag, valid, st,
                                       max_iter, kp, c, eps, tau, k,
                                       active),
        state, max_iter, eps, it_host=it_host, pairs_a_trip=k, tally=tally)


def pallas_pair_update(x, y, x_sq, kp: KernelParams, c, tau: float,
                       cache, alpha, i_hi, i_lo, b_hi, b_lo, it,
                       active) -> tuple:
    """The part of a pipelined trip before kernel B6, gated by `active`:
    the pair's dot rows (through the cache), eta from the three kernel
    values, the pair algebra and the alpha scatter (in place, lo first,
    then hi). The ids and `it` are 0-d device tensors. Returns (dot rows
    (2, n), scalars, n_hits or None), scalars = (coef_hi, coef_lo,
    qsq_hi, qsq_lo) as B6 takes them."""
    pair = torch.stack([i_hi, i_lo])
    d2, n_hits = pair_dots(x, cache, pair, it, active)
    qsq = x_sq.index_select(0, pair)
    qsq_hi, qsq_lo = qsq[0], qsq[1]
    k_hh = kernel_from_dots(take(d2[0], i_hi), qsq_hi, qsq_hi, kp)
    k_ll = kernel_from_dots(take(d2[1], i_lo), qsq_lo, qsq_lo, kp)
    k_hl = kernel_from_dots(take(d2[0], i_lo), qsq_lo, qsq_hi, kp)
    eta = torch.clamp(k_hh + k_ll - 2.0 * k_hl, min=tau)
    coef_hi, coef_lo = _pair_step(alpha, y, pair, b_hi, b_lo, eta, c,
                                  active)
    return d2, torch.stack([coef_hi, coef_lo, qsq_hi, qsq_lo]), n_hits


def run_chunk_pallas(x, y, x_sq, valid, state: SMOState, max_iter: int,
                     kp: KernelParams, c, eps: float, tau: float, *,
                     it_host: Optional[int] = None,
                     tally: Optional[dict] = None) -> SMOState:
    """The software-pipelined per-pair loop on kernel B6 (JAX
    _run_chunk_pallas): each trip applies pair t's rank-2 update AND
    selects pair t+1 in one pass over f (ops/fused_update.py
    fused_update_select), launched once a queued trip; its outputs are
    kept only where the trip is active. One select_working_set seeds the
    carried pair, which stays on the device.

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
    i_hi, b_hi, i_lo, b_lo = select_working_set(state.f, alpha, y, c, valid)

    def trip(carry, active):
        st, i_hi, i_lo = carry
        d2, scalars, n_hits = pallas_pair_update(
            x, y, x_sq, kp, c, tau, st.cache, st.alpha, i_hi, i_lo, st.b_hi,
            st.b_lo, st.it, active)
        f2d, b_hi, i_hi_n, b_lo, i_lo_n = fused_update_select(
            st.f.view(shp), st.alpha.view(shp), y2d, valid2d,
            d2[0].view(shp), d2[1].view(shp), x_sq2d, scalars, kp, c)
        st = _advance(st, st.alpha, f2d.view(n_pad), None, b_hi, b_lo, 1,
                      n_hits, active)
        return (st, torch.where(active, i_hi_n, i_hi),
                torch.where(active, i_lo_n, i_lo))

    carry = (state._replace(alpha=alpha, b_hi=b_hi, b_lo=b_lo), i_hi, i_lo)
    return queue_trips(trip, carry, max_iter, eps, state_of=lambda cr: cr[0],
                       it_host=it_host, tally=tally)[0]


# ---------------------------------------------------------------------
# Fault recovery (the JAX package's run_with_fault_retry and
# _solve_with_degradation, around every solve entry point).

# Markers of a TRANSIENT device-runtime fault worth retrying, the JAX
# package's: gRPC status codes (matched as the status word "CODE:", so
# torch's "INTERNAL ASSERT FAILED" is not one) and prose markers
# (lowercase). The injected ``UNAVAILABLE:`` fault carries the first.
_GRPC_TRANSIENT = ("UNAVAILABLE", "DEADLINE_EXCEEDED", "ABORTED",
                   "CANCELLED", "INTERNAL")
_PROSE_TRANSIENT = ("connection", "socket")
# What a CUDA device-side fault says. Such a fault is sticky for the
# process's CUDA context: nothing in this process can launch again, so
# it is never retried in-process.
_CUDA_FAULT = ("CUDA error", "CUDA kernel errors", "device-side assert",
               "cudaError")

# Seconds to wait before re-dispatching after a fault (indexed by retry
# number, clamped to the last entry), the JAX package's table; tests
# patch it to ().
_RETRY_BACKOFF_S = (5.0, 30.0, 90.0)


def _is_cuda_fault(e: BaseException) -> bool:
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(e, accel):
        return True
    s = str(e)
    return any(m in s for m in _CUDA_FAULT)


def _is_transient_fault(e: BaseException) -> bool:
    if _is_cuda_fault(e):
        return False
    s = str(e)
    sl = s.lower()
    return (any(f"{m}:" in s for m in _GRPC_TRANSIENT)
            or any(m in sl for m in _PROSE_TRANSIENT))


def _clear_caches() -> None:
    """What a faulted attempt may leave stale for the next one (the JAX
    package clears its compiled programs): the cross-solve memos of X on
    the device and of the resident Gram (solver/solve.py). The fleet's
    CUDA graphs are built per solve and the loaded kernel libraries
    hold no device state, so nothing else is cached across attempts."""
    from dpsvm_tpu_torch.solver import solve as solve_mod

    solve_mod._XDEV_MEMO.clear()
    solve_mod._GRAM_MEMO.clear()


def run_with_fault_retry(config, checkpoint_path, resume, attempt_fn):
    """Bounded automatic recovery around a whole solve attempt.
    ``attempt_fn(cfg, resume, k)`` runs attempt k and returns a
    SolveResult. On a transient fault (_is_transient_fault) with retries
    left (config.retry_faults), the cross-attempt caches are cleared, the
    retry waits _RETRY_BACKOFF_S, and attempt k runs with chunk_iters + k
    and tau (1 + k 1e-6), the JAX package's perturbation, so a retried
    trajectory is the same computation in both packages; it resumes from
    the checkpoint only when THIS run wrote one (its mtime moved since
    attempt 0), else restarts from the caller's start. A CUDA
    device-side fault propagates at once with the relaunch advice; any
    other error propagates unchanged."""
    import os
    import sys
    import time

    attempts = max(1, int(config.retry_faults) + 1)

    def _mtime():
        try:
            return (os.path.getmtime(checkpoint_path) if checkpoint_path
                    else None)
        except OSError:
            return None

    baseline_mtime = _mtime()

    def _resume_now():
        return resume or (bool(checkpoint_path) and _mtime() is not None
                          and _mtime() != baseline_mtime)

    for k in range(attempts):
        cfg_k = config if k == 0 else config.replace(
            chunk_iters=config.chunk_iters + k,
            tau=config.tau * (1.0 + k * 1e-6))
        res_k = resume if k == 0 else _resume_now()
        try:
            return attempt_fn(cfg_k, res_k, k)
        except RuntimeError as e:
            if _is_cuda_fault(e):
                clear_pending_obs_events()
                raise RuntimeError(
                    f"{e}\nA CUDA device-side fault is sticky for this "
                    "process and is not retried in it: relaunch with "
                    "--resume --checkpoint PATH (solve(..., resume=True, "
                    "checkpoint_path=PATH)) to continue from the last "
                    "checkpoint") from e
            if k == attempts - 1 or not _is_transient_fault(e):
                clear_pending_obs_events()
                raise
            nxt = "from checkpoint" if _resume_now() else "from scratch"
            print(f"[fault-retry] transient device fault ({str(e)[:160]!r}); "
                  f"retry {k + 1}/{attempts - 1} {nxt}", file=sys.stderr,
                  flush=True)
            # The faulted attempt's run log closed aborted with the
            # exception; the next attempt's run drains these.
            queue_pending_obs_event("fault", error=str(e)[:200], attempt=k,
                                    transient=True)
            queue_pending_obs_event("retry", attempt=k + 1,
                                    resume=bool(_resume_now()))
            _clear_caches()
            if _RETRY_BACKOFF_S:
                time.sleep(_RETRY_BACKOFF_S[min(k,
                                                len(_RETRY_BACKOFF_S) - 1)])
        except BaseException:
            clear_pending_obs_events()
            raise
    raise AssertionError("unreachable")


def _noop_callback(it, b_hi, b_lo, state):
    """The observer a retry attempt runs with when nothing else observes
    (chunked dispatches instead of one long one). Never aborts."""
    return None


def _retry_callback(callback, cfg_k, checkpoint_path, k):
    """The callback of retry attempt k: unchanged on attempt 0 or when
    anything already observes chunk boundaries, else the no-op observer,
    as in the JAX package."""
    if k > 0 and callback is None and not cfg_k.verbose \
            and not cfg_k.check_numerics \
            and not (cfg_k.checkpoint_every and checkpoint_path):
        return _noop_callback
    return callback


# Cross-attempt obs handoff: a faulted or demoted attempt's run log is
# closed when the decision to retry or demote is made, so the wrapper
# queues the event here and the next attempt drains it into its own run
# log right after run_obs(). Thread-local: concurrent solves must not
# take each other's events.
import threading as _threading  # noqa: E402

_PENDING_OBS = _threading.local()


def queue_pending_obs_event(name: str, **fields) -> None:
    lst = getattr(_PENDING_OBS, "events", None)
    if lst is None:
        lst = _PENDING_OBS.events = []
    lst.append((name, fields))


def clear_pending_obs_events() -> None:
    _PENDING_OBS.events = []


def drain_pending_obs_events(obs) -> None:
    """Emit (and clear) the queued cross-attempt events into a run's log.
    Clears even when obs is off."""
    lst = getattr(_PENDING_OBS, "events", None)
    if not lst:
        return
    _PENDING_OBS.events = []
    for name, fields in lst:
        obs.event(name, **fields)


def _solve_with_degradation(config, checkpoint_path, resume, run):
    """Graceful degradation around a whole solve: on a
    NonFiniteTrajectory (the chunk-boundary sentinel), resume the last
    checkpoint this run wrote (or restart) and demote ONCE to the safe
    configuration (solver/block.py demote_to_safe), with a warning,
    stats["demoted_faults"] and a ``demotion`` run-log event. A config
    that is already safe propagates the error: that is a real numerics
    fault. ``run(cfg, resume)`` runs the retry-wrapped solve."""
    import os
    import warnings

    from dpsvm_tpu_torch.solver.block import demote_to_safe
    from dpsvm_tpu_torch.solver.chunks import NonFiniteTrajectory

    def _mtime():
        try:
            return (os.path.getmtime(checkpoint_path) if checkpoint_path
                    else None)
        except OSError:
            return None

    baseline_mtime = _mtime()
    try:
        return run(config, resume)
    except NonFiniteTrajectory as e:
        safe_cfg, dropped = demote_to_safe(config)
        if safe_cfg is None:
            raise
        res_now = resume or (bool(checkpoint_path) and _mtime() is not None
                             and _mtime() != baseline_mtime)
        warnings.warn(
            f"non-finite solver trajectory ({e}); DEMOTING to the safe "
            f"configuration (dropped: {', '.join(dropped)}) and "
            + ("resuming from the last checkpoint" if res_now
               else "restarting from scratch")
            + " — results will be exact but slower; investigate the input "
            "scaling / C / gamma that produced the blow-up", stacklevel=3)
        queue_pending_obs_event("demotion", reason=str(e)[:200],
                                dropped=list(dropped), resumed=bool(res_now))
        try:
            res = run(safe_cfg, res_now)
        except BaseException:
            clear_pending_obs_events()
            raise
        res.stats["demoted_faults"] = \
            int(res.stats.get("demoted_faults", 0)) + 1
        res.stats["demotion"] = {"dropped": list(dropped),
                                 "resumed": bool(res_now),
                                 "reason": str(e)[:200]}
        return res
