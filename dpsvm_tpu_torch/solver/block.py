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
one (the JAX split serves engines the port does not have yet), built
from the four stage functions so each stage can also be timed alone.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dpsvm_tpu_torch.ops.kernels import (KernelParams, kernel_from_dots,
                                         kernel_rows, mm_f32)
from dpsvm_tpu_torch.ops.select import low_mask, split_c, up_mask
from dpsvm_tpu_torch.ops.subproblem import solve_subproblem
from dpsvm_tpu_torch.solver.smo import maybe_kahan


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
    bits = scores.contiguous().view(torch.int32)
    okey = bits ^ ((bits >> 31) & 0x7FFFFFFF)  # signed order == total order
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


def select_block(f, alpha, y, c, q: int, rule: str = "mvp"):
    """Pick the q most-violating points: q/2 from I_up (smallest f) and
    q/2 from I_low (largest f). Returns (w, slot_ok, b_hi, b_lo): w (q,)
    int64 row ids (filler where a side ran short), slot_ok (q,) bool, and
    the exact float32 extrema of f over I_up / I_low."""
    if rule not in ("mvp", "second_order"):
        raise NotImplementedError(
            f"selection={rule!r} is not ported (nu duals: ROADMAP queue A "
            "item 7)")
    cp, cn = split_c(c)
    up = up_mask(alpha, y, cp, cn)
    low = low_mask(alpha, y, cp, cn)
    neg_inf = -float("inf")
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
    kb_w = kernel_from_dots(mm_f32(qx, qx.t()), qsq, qsq, kp)
    return qx, qsq, kb_w, k_diag[w], alpha[w], y[w], f[w]


def dispatch_subproblem(kb_w, kd_w, slot_ok, a_w0, y_w, f_w0, c,
                        eps: float, tau: float, limit, selection: str):
    """The subproblem stage of a round. Returns (a_w, coef, t): the new
    subproblem alphas, the fold coefficients (dalpha * y, dead slots
    zeroed) and the executed pair count (int32 0-d tensor)."""
    a_w, t = solve_subproblem(kb_w, a_w0, y_w, f_w0, kd_w, slot_ok.float(),
                              limit, c, eps, tau, rule=selection)
    coef = torch.where(slot_ok, (a_w - a_w0) * y_w, 0.0)
    return a_w, coef, t


def fold_block(x, x_sq, qx, qsq, kp: KernelParams, f, f_err, coef,
               alpha, w, slot_ok, a_w):
    """f += coef @ K(W, :) (Kahan when f_err is carried) and scatter the
    live slots of a_w into alpha. Returns (alpha, f, f_err)."""
    k_rows = kernel_rows(x, x_sq, qx, qsq, kp)  # (q, n) float32
    f, f_err = maybe_kahan(f, f_err, coef @ k_rows)
    # Only live slots may write: a dead slot's id is a real row (possibly
    # the same row as a live slot). Dead slots are sent to a scratch
    # element past the end, so the scatter needs no host sync.
    n = alpha.shape[0]
    safe_w = torch.where(slot_ok, w, n)
    buf = torch.cat([alpha, alpha.new_zeros(1)])
    buf[safe_w] = a_w
    return buf[:n], f, f_err


def run_local_round(x, y, x_sq, k_diag, alpha, f, f_err, budget_left,
                    kp: KernelParams, c, eps: float, tau: float, q: int,
                    inner_iters: int, selection: str):
    """ONE complete block round. Returns (alpha, f, f_err, b_hi, b_lo, t):
    the updated state, the extrema of the gradient this round SAW (one
    fold behind, as in the JAX package) and the executed pair count."""
    f_cur = f if f_err is None else f - f_err
    w, slot_ok, b_hi, b_lo = select_block(f_cur, alpha, y, c, q,
                                          rule=selection)
    gap_open = b_lo > b_hi + 2.0 * eps
    qx, qsq, kb_w, kd_w, a_w0, y_w, f_w0 = gather_block(
        x, y, x_sq, k_diag, f_cur, alpha, w, kp)
    # Per-round pair budget, clamped to what the solve has left and gated
    # to 0 on the terminal round (which still counts as a round).
    limit = torch.clamp(budget_left, max=inner_iters)
    limit = torch.where(gap_open, limit, 0).to(torch.int32)
    a_w, coef, t = dispatch_subproblem(kb_w, kd_w, slot_ok, a_w0, y_w, f_w0,
                                       c, eps, tau, limit, selection)
    alpha, f, f_err = fold_block(x, x_sq, qx, qsq, kp, f, f_err, coef,
                                 alpha, w, slot_ok, a_w)
    return alpha, f, f_err, b_hi, b_lo, t


def run_chunk_block(x, y, x_sq, k_diag, state: BlockState, max_iter: int,
                    kp: KernelParams, c, eps: float, tau: float, q: int,
                    inner_iters: int, selection: str = "mvp") -> BlockState:
    """Run rounds while pairs < max_iter and the CARRIED gap is open (the
    semantics of the JAX package's _run_chunk_block run unobserved). The
    loop condition is evaluated on the device in float32 and read once
    per round."""
    while bool((state.pairs < max_iter)
               & (state.b_lo > state.b_hi + 2.0 * eps)):
        alpha, f, f_err, b_hi, b_lo, t = run_local_round(
            x, y, x_sq, k_diag, state.alpha, state.f, state.f_err,
            max_iter - state.pairs, kp, c, eps, tau, q, inner_iters,
            selection)
        state = BlockState(alpha, f, b_hi, b_lo, state.pairs + t,
                           state.rounds + 1, f_err)
    return state
