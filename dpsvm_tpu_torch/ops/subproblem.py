"""The block engine's q-variable subproblem solve (counterpart of
dpsvm_tpu/ops/pallas_subproblem.py solve_subproblem_pallas, kernel B1).

``solve_subproblem`` launches the Hopper kernel csrc/subproblem.cu for
CUDA tensors and runs the plain PyTorch version ``_solve_subproblem``
(the counterpart of dpsvm_tpu/solver/block.py _solve_subproblem) for CPU
tensors. There is no other route: a failed build or launch raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dpsvm_tpu_torch.ops.select import c_of, low_mask, split_c, up_mask
from dpsvm_tpu_torch.solver.smo import fma32, pair_alpha_update

_RULES = {"mvp": 0, "second_order": 1}
_MAX_Q = 4096  # csrc/subproblem.cu: up to four slots for each of 1024 threads


def _check_rule(rule: str, pair_batch: int) -> None:
    if pair_batch != 1:
        raise NotImplementedError(
            "pair_batch>1 in the block subproblem is not ported "
            "(ROADMAP queue A item 5b)")
    if rule not in _RULES:
        raise NotImplementedError(
            f"subproblem rule {rule!r} is not ported (the nu rule: ROADMAP "
            "queue A item 7)")


def _solve_subproblem(kb_w, kd_w, slot_ok, alpha_w, y_w, f_w, c,
                      eps: float, tau: float, limit, rule: str = "mvp",
                      pair_batch: int = 1, rows_read: set | None = None):
    """Exact SMO on the q-variable subproblem, plain PyTorch.

    kb_w: (q, q) Gram block; kd_w its diagonal; slot_ok (q,) bool.
    `limit` caps the pair updates. Returns (alpha_w, f_w, n_pairs) with
    n_pairs a 0-d int32 tensor. rule "mvp" pairs the maximal violators;
    "second_order" keeps i and picks j by the largest second-order gain
    (f_j - b_hi)^2 / eta_ij over row i of K(W, W). One host read of the
    gap per pair ends the loop. A `rows_read` set, when given, collects
    the slots whose Gram rows the solve reads (for a bytes count)."""
    _check_rule(rule, pair_batch)
    cp, cn = split_c(c)
    limit = int(limit)
    lanes = torch.arange(alpha_w.shape[0], device=alpha_w.device)
    t = 0
    while t < limit:
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
        else:
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
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 2
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
    Hopper kernel, CPU tensors to the plain version."""
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
                                      y_w, f_w, c, eps, tau, limit, rule)
        return a_w, t
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not 1 <= q <= _MAX_Q:
        raise ValueError(f"the subproblem kernel takes 1 <= q <= {_MAX_Q}, "
                         f"got {q}")
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
                 q, _RULES[rule], *consts, stream)
    if err != 0:
        raise RuntimeError(f"subproblem kernel launch failed: CUDA error {err}")
    solve_subproblem.launches += 1
    return alpha_out, t_out


#: Launches of the Hopper kernel (CPU calls never count). Callers that
#: prove a path ran through the kernel set this to 0 and read it after.
solve_subproblem.launches = 0
