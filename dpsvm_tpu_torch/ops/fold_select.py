"""Fused fold + next working-set candidate selection (counterpart of
dpsvm_tpu/ops/pallas_fold_select.py, kernels B2 and B3).

The block engine's fold writes f, and the next round's selection reads it
straight back. Here both happen in one pass over the (R, 128) float32
views of the O(n) vectors (R = n_pad / 128):

    f'  = f + delta            (compensated: the Kahan step with err)
    up/low masks from the ALREADY-SCATTERED alpha (and `valid`)
    per 128-element row: min f' over I_up, max f' over I_low, each with
    the lowest flat id among equal values

so each side emits one candidate per row. ``assemble_working_set`` takes
the exact top-h over those R candidates and dedups the halves. Every row
keeps its true extremum, so the globally most-violating pair is always in
W and the emitted extrema are exact; only mid-rank recall differs from
``select_block`` (at most one candidate per row and side).

``fold_select`` (B2) and ``select_rows`` (B3, the pre-fold variant with
no delta and no write-back) launch the Hopper kernels of
csrc/fold_select.cu for CUDA tensors and run their plain PyTorch versions
``_fold_select`` / ``_select_rows`` for CPU tensors; any other device
raises. Each counts its kernel launches in ``.launches``.

Empty rows and signed zeros: a row with no member of a set reports
+inf (up) / -inf (low) with the row's FIRST flat id, as the JAX package's
``min(where(f_up == upv, ids, IMAX))`` gives; ``assemble_working_set``'s
filler ids depend on it. Values that compare equal (+0.0 and -0.0
included) go to the lowest flat id. The reported value is the IEEE
minimum / maximum, as XLA reduces: a +-0 tie reports -0.0 for the up
side and +0.0 for the low side whenever a member has that sign (plain and
kernel alike). NaN in f is not supported.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dpsvm_tpu_torch.ops.select import (from_order_key, order_key,
                                        split_c)
from dpsvm_tpu_torch.solver.smo import kahan_add

LANES = 128
_INF = float("inf")
_IMAX = 2 ** 31 - 1


def fold_delta(f, err, delta):
    """The fold's elementwise step: plain add when ``err`` is None, else
    the Kahan step (solver/smo.py kahan_add). Returns (f_new, err_new or
    None, f_sel), f_sel being the gradient the selection sees (f - err)."""
    if err is not None:
        f_new, err_new = kahan_add(f, err, delta)
        return f_new, err_new, f_new - err_new
    f_new = f + delta
    return f_new, None, f_new


def emit_row_candidates(f_sel, alpha, y, valid_f, c):
    """Masks and per-128-row candidates of (R, 128) float32 views.
    Returns (up_vals, up_ids, low_vals, low_ids), each (R,), ids int32
    flat over the (R, 128) layout. The masks are the up_mask / low_mask
    algebra of ops/select.py written as the JAX kernel writes it."""
    valid = valid_f > 0.0
    cp, cn = split_c(c)
    pos = y > 0
    neg = ~pos
    lt_cp = alpha < cp
    lt_cn = lt_cp if cp == cn else alpha < cn
    gt_0 = alpha > 0
    up = ((pos & lt_cp) | (neg & gt_0)) & valid
    low = ((pos & gt_0) | (neg & lt_cn)) & valid
    rows = f_sel.shape[0]
    ids = torch.arange(rows * LANES, dtype=torch.int32,
                       device=f_sel.device).view(rows, LANES)
    f_up = torch.where(up, f_sel, _INF)
    f_low = torch.where(low, f_sel, -_INF)
    # Extrema in the float total order (-0.0 below +0.0), as XLA's
    # reductions give them; torch.amin / amax leave a +-0 tie's sign to
    # the order they meet the values in.
    upv = from_order_key(order_key(f_up).amin(dim=1))
    lov = from_order_key(order_key(f_low).amax(dim=1))
    upi = torch.where(f_up == upv[:, None], ids, _IMAX).amin(dim=1)
    loi = torch.where(f_low == lov[:, None], ids, _IMAX).amin(dim=1)
    return upv, upi, lov, loi


def _fold_select(f2d, err2d, alpha2d, y2d, valid2d, delta2d, c,
                 compensated: bool = False):
    """Plain PyTorch version of kernel B2: same contract as fold_select."""
    f_new, err_new, f_sel = fold_delta(
        f2d, err2d if compensated else None, delta2d)
    return (f_new, err_new,
            *emit_row_candidates(f_sel, alpha2d, y2d, valid2d, c))


def _select_rows(f2d, alpha2d, y2d, valid2d, c):
    """Plain PyTorch version of kernel B3: same contract as select_rows."""
    return emit_row_candidates(f2d, alpha2d, y2d, valid2d, c)


def check_views(*views) -> torch.device:
    """Every (R, 128) view: float32, contiguous, one device, and (for the
    kernels' 16-byte loads) 16-byte aligned. Returns the device."""
    shape = views[0].shape
    dev = views[0].device
    if len(shape) != 2 or shape[1] != LANES or shape[0] < 1:
        raise ValueError(f"views must be (R, {LANES}), got {tuple(shape)}")
    for v in views:
        if (v.shape != shape or v.dtype != torch.float32 or v.device != dev
                or not v.is_contiguous()):
            raise ValueError(
                f"views must all be contiguous {tuple(shape)} float32 on "
                f"{dev}, got {tuple(v.shape)} {v.dtype} on {v.device}")
        if dev.type == "cuda" and v.data_ptr() % 16:
            raise ValueError("views must be 16-byte aligned")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def c_consts(c) -> list:
    """(c_pos, c_neg) as the float32 values the masks compare against."""
    return [float(np.float32(v)) for v in split_c(c)]


def cand_outputs(rows: int, dev) -> tuple:
    """Empty (upv, upi, lov, loi) buffers for a kernel to fill."""
    fv = torch.empty(rows, dtype=torch.float32, device=dev)
    iv = torch.empty(rows, dtype=torch.int32, device=dev)
    return fv, iv, torch.empty_like(fv), torch.empty_like(iv)


def lib() -> ctypes.CDLL:
    """csrc/fold_select.cu, built at first use, with typed entry points."""
    from dpsvm_tpu_torch.ops import _build

    so = _build.load("fold_select")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sigs = {
        # f, err, alpha, y, valid, delta, f_out, err_out, 4 cands
        "dpsvm_fold_select": [ptr] * 12 + [i32, i32, f32, f32, ptr],
        # f, alpha, y, valid, 4 cands
        "dpsvm_select_rows": [ptr] * 8 + [i32, f32, f32, ptr],
        # k_rows, coef, f, err, alpha, y, valid, f_out, err_out, 4 cands;
        # q, rows, compensated, the plan (warps, chunk, stages, smem)
        "dpsvm_fold_rows_select": [ptr] * 13 + [i32] * 7 + [f32, f32, ptr],
    }
    for name, argtypes in sigs.items():
        fn = getattr(so, name)
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
    return so


def raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def fold_select(f2d, err2d, alpha2d, y2d, valid2d, delta2d, c,
                compensated: bool = False):
    """Fold delta into f (Kahan when compensated) and emit per-row
    working-set candidates (kernel B2).

    All arrays are (R, 128) float32 views; err2d is None unless
    compensated. Returns (f_new2d, err_new2d or None, up_vals, up_ids,
    low_vals, low_ids), one candidate per 128-element row."""
    ins = (f2d, alpha2d, y2d, valid2d, delta2d)
    dev = check_views(*ins, *((err2d,) if compensated else ()))
    if dev.type == "cpu":
        return _fold_select(f2d, err2d, alpha2d, y2d, valid2d, delta2d, c,
                            compensated)
    rows = f2d.shape[0]
    f_out = torch.empty_like(f2d)
    err_out = torch.empty_like(f2d) if compensated else None
    cands = cand_outputs(rows, dev)
    raise_on(lib().dpsvm_fold_select(
        f2d.data_ptr(), _ptr(err2d if compensated else None),
        alpha2d.data_ptr(), y2d.data_ptr(), valid2d.data_ptr(),
        delta2d.data_ptr(), f_out.data_ptr(), _ptr(err_out),
        *(t.data_ptr() for t in cands), rows, int(compensated),
        *c_consts(c), torch.cuda.current_stream(dev).cuda_stream),
        "fold_select")
    fold_select.launches += 1
    return (f_out, err_out, *cands)


def select_rows(f2d, alpha2d, y2d, valid2d, c):
    """Per-row working-set candidates from f AS IT STANDS (kernel B3: no
    delta, no write-back). A compensated caller passes the effective f
    (f - err). Returns (up_vals, up_ids, low_vals, low_ids)."""
    dev = check_views(f2d, alpha2d, y2d, valid2d)
    if dev.type == "cpu":
        return _select_rows(f2d, alpha2d, y2d, valid2d, c)
    cands = cand_outputs(f2d.shape[0], dev)
    raise_on(lib().dpsvm_select_rows(
        f2d.data_ptr(), alpha2d.data_ptr(), y2d.data_ptr(),
        valid2d.data_ptr(), *(t.data_ptr() for t in cands), f2d.shape[0],
        *c_consts(c), torch.cuda.current_stream(dev).cuda_stream),
        "select_rows")
    select_rows.launches += 1
    return cands


#: Kernel launches (CPU calls never count). A caller that proves a path
#: ran through the kernels sets these to 0 and reads them after.
fold_select.launches = 0
select_rows.launches = 0


def assemble_working_set(upv, upi, lov, loi, h: int):
    """The next round's (w, slot_ok, b_hi, b_lo) from per-row candidates:
    exact top-h over the R candidates of each side (ties to the lowest
    candidate index, as lax.top_k), then the shared cross-half dedup.
    w is int32."""
    from dpsvm_tpu_torch.solver.block import _top_h, combine_halves

    vals, idx = _top_h(torch.stack([-upv, lov]), h)
    ids = torch.gather(torch.stack([upi, loi]), 1, idx)
    w, slot_ok = combine_halves(ids[0], torch.isfinite(vals[0]),
                                ids[1], torch.isfinite(vals[1]))
    return w, slot_ok, -vals[0, 0], vals[1, 0]
