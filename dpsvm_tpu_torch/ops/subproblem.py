"""The block engine's q-variable subproblem solve (counterpart of
dpsvm_tpu/ops/pallas_subproblem.py solve_subproblem_pallas, kernel B1).

``solve_subproblem`` launches the Hopper kernel csrc/subproblem.cu for
CUDA tensors and runs the plain PyTorch version ``_solve_subproblem``
(the counterpart of dpsvm_tpu/solver/block.py _solve_subproblem) for CPU
tensors. There is no other route: a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from dpsvm_tpu_torch.ops.select import (c_of, low_mask,
                                        select_working_set_nu, split_c,
                                        up_mask)
from dpsvm_tpu_torch.solver.smo import fma32, pair_alpha_update

_RULES = {"mvp": 0, "second_order": 1, "nu": 2}
_MAX_Q = 4096  # csrc/subproblem.cu: up to four slots for each of 1024 threads
SMEM_LIMIT = 232_448  # shared memory one CTA may have on sm_90
# csrc/subproblem.cu kHeadBytes: an mbarrier, then the reductions' records
# [parity 2][side 5][warp 32] of 16 bytes.
_HEAD_BYTES = 16 + 2 * 5 * 32 * 16


class SubproblemPlan(NamedTuple):
    """Kernel B1's launch: one CTA of `threads`, `slots` slots a thread
    (slot tid + s threads). The first `nchip` rows of K(W, W) are copied
    into shared memory, the rest read through L2. `smem`: the CTA's
    dynamic shared-memory bytes."""
    threads: int
    slots: int
    nchip: int
    smem: int


def subproblem_plan(q: int, aligned: bool = True) -> SubproblemPlan:
    """The launch for a q-slot subproblem: one slot a thread up to q = 256
    (8 warps), then 2 slots a thread up to q = 2048 and 4 beyond (past 8
    warps, fewer warps to reduce over pay for the second slot: measured
    by tools/b1_trip_clocks.py), and as many leading rows of K(W, W) on
    chip as the CTA's shared memory holds, a multiple of 4 so that they
    are one 16-byte bulk copy. `aligned`: K(W, W) starts 16-byte aligned;
    else no rows go on chip."""
    if not 1 <= q <= _MAX_Q:
        raise ValueError(f"the subproblem kernel takes 1 <= q <= {_MAX_Q}, "
                         f"got {q}")
    slots = 1 if q <= 256 else 2 if q <= 2048 else 4
    threads = -(-q // (32 * slots)) * 32
    fit = (SMEM_LIMIT - _HEAD_BYTES - 8 * q) // (4 * q)
    nchip = min(q, fit) // 4 * 4 if aligned else 0
    return SubproblemPlan(threads, slots, nchip,
                          _HEAD_BYTES + 4 * nchip * q + 8 * q)


def _check_rule(rule: str, pair_batch: int) -> None:
    if rule not in _RULES:
        raise ValueError(f"unknown subproblem rule {rule!r}")
    if pair_batch not in (1, 2, 4):
        raise ValueError("pair_batch must be 1, 2 or 4")
    if pair_batch > 1 and rule != "mvp":
        raise ValueError("pair_batch>1 is implemented for rule='mvp' only")


def _solve_subproblem(kb_w, kd_w, slot_ok, alpha_w, y_w, f_w, c,
                      eps: float, tau: float, limit, rule: str = "mvp",
                      pair_batch: int = 1, rows_read: set | None = None):
    """Exact SMO on the q-variable subproblem, plain PyTorch.

    kb_w: (q, q) Gram block; kd_w its diagonal; slot_ok (q,) bool.
    `limit` caps the pair updates. Returns (alpha_w, f_w, n_pairs) with
    n_pairs a 0-d int32 tensor. rule "mvp" pairs the maximal violators;
    "second_order" keeps i and picks j by the largest second-order gain
    (f_j - b_hi)^2 / eta_ij over row i of K(W, W); "nu" pairs the maximal
    violators within one class, the class with the larger violation
    (select_working_set_nu; the nu duals' per-class constraints). One host read of the
    gap per trip ends the loop. A `rows_read` set, when given, collects
    the slots whose Gram rows the solve reads (for a bytes count).

    pair_batch 2 or 4 (rule "mvp"): each trip goes on to pair_batch - 1
    further coordinate-disjoint pairs, SELECTED by rank from the trip's
    pre-update f over I_up / I_low with the earlier pairs' slots excluded
    (stale) and UPDATED exactly from the current f_w. An attempted slot
    counts while the budget lasts even when its update is gated to a
    no-op: an empty stale set (whose argmin aliases slot 0), or a
    corrected pair that no longer violates (the margin-free b_lo > b_hi
    gate; the first slot of a trip gates on the 2 eps margin)."""
    _check_rule(rule, pair_batch)
    cp, cn = split_c(c)
    limit = int(limit)
    lanes = torch.arange(alpha_w.shape[0], device=alpha_w.device)
    t = 0
    while t < limit:
        if rule == "nu":
            # Per-class maximal violators; slot_ok plays the valid mask.
            i, b_hi, j, b_lo = select_working_set_nu(f_w, alpha_w, y_w, c,
                                                     valid=slot_ok)
            row_i = kb_w[i]
            gap_open = b_lo > b_hi + 2.0 * eps
            upd_ok = gap_open
        else:
            up = up_mask(alpha_w, y_w, cp, cn) & slot_ok
            low = low_mask(alpha_w, y_w, cp, cn) & slot_ok
            f_up = torch.where(up, f_w, float("inf"))
            f_low = torch.where(low, f_w, -float("inf"))
            i = torch.argmin(f_up)
            b_hi = f_up[i]
            row_i = kb_w[i]
        if rule == "second_order":
            gap_open = f_low.max() > b_hi + 2.0 * eps
            diff = f_w - b_hi
            eta_j = torch.clamp(kd_w[i] + kd_w - 2.0 * row_i, min=tau)
            gain = torch.where(low & (diff > 0), diff * diff / eta_j,
                               -float("inf"))
            # In budget mode (eps = -1e30) the gap stays open after the
            # eligible set empties; the trip is then a counted no-op.
            upd_ok = gap_open & (gain.max() > -float("inf"))
            j = torch.where(upd_ok, torch.argmax(gain), i)
            b_lo = f_w[j]
        elif rule == "mvp":
            j = torch.argmax(f_low)
            b_lo = f_low[j]
            gap_open = b_lo > b_hi + 2.0 * eps
            upd_ok = gap_open
        if not bool(gap_open):
            break
        if rows_read is not None:
            rows_read.update((int(i), int(j)))
        row_j = kb_w[j]
        eta = torch.clamp(kd_w[i] + kd_w[j] - 2.0 * row_i[j], min=tau)
        y_i = y_w[i]
        y_j = y_w[j]
        a_i_old = alpha_w[i]
        a_j_old = alpha_w[j]
        a_i_new, a_j_new = pair_alpha_update(
            a_i_old, a_j_old, y_i, y_j, b_hi, b_lo, eta,
            c_of(y_i, cp, cn), c_of(y_j, cp, cn), gate=upd_ok)
        alpha_w = torch.where(lanes == i, a_i_new, alpha_w)
        alpha_w = torch.where(lanes == j, a_j_new, alpha_w)
        f_w = fma32((a_j_new - a_j_old) * y_j, row_j,
                    fma32((a_i_new - a_i_old) * y_i, row_i, f_w))
        t += 1
        excl = (lanes == i) | (lanes == j)
        for _ in range(pair_batch - 1):
            f_up = torch.where(excl, float("inf"), f_up)
            f_low = torch.where(excl, -float("inf"), f_low)
            i2 = torch.argmin(f_up)
            j2 = torch.argmax(f_low)
            if rows_read is not None:
                rows_read.update((int(i2), int(j2)))
            row_i2 = kb_w[i2]
            row_j2 = kb_w[j2]
            b_hi2 = f_w[i2]  # corrected: the current gradient
            b_lo2 = f_w[j2]
            y_i2 = y_w[i2]
            y_j2 = y_w[j2]
            eta2 = torch.clamp(kd_w[i2] + kd_w[j2] - 2.0 * row_i2[j2],
                               min=tau)
            cnt2 = t < limit
            upd2 = ((f_up[i2] < float("inf")) & (f_low[j2] > -float("inf"))
                    & (b_lo2 > b_hi2) & cnt2)
            a_i2_old = alpha_w[i2]
            a_j2_old = alpha_w[j2]
            a_i2_new, a_j2_new = pair_alpha_update(
                a_i2_old, a_j2_old, y_i2, y_j2, b_hi2, b_lo2, eta2,
                c_of(y_i2, cp, cn), c_of(y_j2, cp, cn), gate=upd2)
            alpha_w = torch.where(lanes == i2, a_i2_new, alpha_w)
            alpha_w = torch.where(lanes == j2, a_j2_new, alpha_w)
            f_w = fma32((a_j2_new - a_j2_old) * y_j2, row_j2,
                        fma32((a_i2_new - a_i2_old) * y_i2, row_i2, f_w))
            t += int(cnt2)
            excl = excl | (lanes == i2) | (lanes == j2)
    return alpha_w, f_w, torch.tensor(t, dtype=torch.int32,
                                      device=alpha_w.device)


def _box_consts(c) -> tuple:
    """(c_pos, c_neg, snap_pos, snap_neg, cms_pos, cms_neg) in float32,
    rounded as pair_alpha_update rounds them: with equal class weights C
    is a Python float, so 1e-6 * C and C - 1e-6 * C are computed in double
    and rounded once; with unequal weights they are float32 arithmetic on
    the per-row bound."""
    cp, cn = split_c(c)
    if cp == cn:
        snap = np.float32(1e-6 * cp)
        cms = np.float32(cp - 1e-6 * cp)
        return (np.float32(cp), np.float32(cp), snap, snap, cms, cms)
    out = []
    for cv in (np.float32(cp), np.float32(cn)):
        snap = np.float32(np.float32(1e-6) * cv)
        out.append((cv, snap, np.float32(cv - snap)))
    (c1, s1, m1), (c2, s2, m2) = out
    return (c1, c2, s1, s2, m1, m2)


def _lib():
    from dpsvm_tpu_torch.ops import _build

    fn = _build.load("subproblem").dpsvm_subproblem
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                       + [ctypes.c_float] * 8 + [ctypes.c_void_p])
    return fn


def solve_subproblem(kb_w, alpha_w, y_w, f_w, kd_w, slot_ok, limit, c,
                     eps: float, tau: float, rule: str = "mvp",
                     pair_batch: int = 1):
    """Solve the q-variable subproblem; same contract as the JAX
    package's solve_subproblem_pallas.

    kb_w (q, q) float32; alpha_w, y_w, f_w, kd_w, slot_ok (q,) float32
    (slot_ok as 1.0/0.0); `limit` the pair budget (an int32 tensor of
    one element on the same device, or an int). Returns
    (alpha_w_new (q,), n_pairs int32 0-d tensor). CUDA tensors go to the
    Hopper kernel, launched as ``subproblem_plan(q)`` says; CPU tensors
    to the plain version."""
    _check_rule(rule, pair_batch)
    q = kb_w.shape[0]
    vecs = (alpha_w, y_w, f_w, kd_w, slot_ok)
    dev = kb_w.device
    if kb_w.shape != (q, q) or kb_w.dtype != torch.float32:
        raise ValueError(f"kb_w must be ({q}, {q}) float32, got "
                         f"{tuple(kb_w.shape)} {kb_w.dtype}")
    for v in vecs:
        if v.shape != (q,) or v.dtype != torch.float32 or v.device != dev:
            raise ValueError(
                f"subproblem vectors must be ({q},) float32 on {dev}, got "
                f"{tuple(v.shape)} {v.dtype} on {v.device}")
    if not all(v.is_contiguous() for v in (kb_w, *vecs)):
        raise ValueError("subproblem inputs must be contiguous")
    if dev.type == "cpu":
        a_w, _, t = _solve_subproblem(kb_w, kd_w, slot_ok > 0, alpha_w,
                                      y_w, f_w, c, eps, tau, limit, rule,
                                      pair_batch)
        return a_w, t
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    plan = subproblem_plan(q, aligned=kb_w.data_ptr() % 16 == 0)
    if not torch.is_tensor(limit):
        limit = torch.tensor(int(limit), dtype=torch.int32, device=dev)
    if limit.dtype != torch.int32 or limit.numel() != 1 \
            or limit.device != dev:
        raise ValueError("limit must be one int32 element on the "
                         "subproblem's device")
    alpha_out = torch.empty_like(alpha_w)
    t_out = torch.empty((), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # float32 constants travel as exact Python floats.
    consts = [float(v) for v in (*_box_consts(c), np.float32(2.0 * eps),
                                 np.float32(tau))]
    err = _lib()(kb_w.data_ptr(), *(v.data_ptr() for v in vecs),
                 limit.data_ptr(), alpha_out.data_ptr(), t_out.data_ptr(),
                 q, _RULES[rule], pair_batch, plan.threads, plan.slots,
                 plan.nchip, plan.smem, *consts, stream)
    if err != 0:
        raise RuntimeError(f"subproblem kernel launch failed: CUDA error {err}")
    solve_subproblem.launches += 1
    return alpha_out, t_out


#: Launches of the Hopper kernel (CPU calls never count). Callers that
#: prove a path ran through the kernel set this to 0 and read it after.
solve_subproblem.launches = 0
