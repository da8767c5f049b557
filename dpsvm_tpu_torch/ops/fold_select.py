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
csrc/fold_select.cu for CUDA tensors, split by ``fold_select_plan``, and
run their plain PyTorch versions ``_fold_select`` / ``_select_rows`` for
CPU tensors; any other device raises. Each counts its kernel launches in
``.launches``. The kernels write the four candidate arrays into one
(4, R) buffer of 32-bit words; the wrappers return its rows as float32
values and int32 ids.

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
import functools
from typing import NamedTuple

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
    first = views[0]
    shape = first.shape
    dev = first.device
    if len(shape) != 2 or shape[1] != LANES or shape[0] < 1:
        raise ValueError(f"views must be (R, {LANES}), got {tuple(shape)}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    for v in views:
        if (v.shape != shape or v.dtype is not torch.float32
                or (v is not first and v.device != dev)
                or not v.is_contiguous()):
            raise ValueError(
                f"views must all be contiguous {tuple(shape)} float32 on "
                f"{dev}, got {tuple(v.shape)} {v.dtype} on {v.device}")
    if dev.type == "cuda" and any(v.data_ptr() % 16 for v in views):
        raise ValueError("views must be 16-byte aligned")
    return dev


@functools.lru_cache(maxsize=64)
def c_consts(c) -> tuple:
    """(c_pos, c_neg) as the float32 values the masks compare against."""
    return tuple(float(np.float32(v)) for v in split_c(c))


def cand_outputs(rows: int, dev) -> tuple:
    """(upv, upi, lov, loi) for a kernel to fill: the rows of one (4, R)
    buffer of 32-bit words, values viewed as float32 and ids as int32.
    Returns (buffer, (upv, upi, lov, loi))."""
    buf = torch.empty((4, rows), dtype=torch.int32, device=dev)
    upv, upi, lov, loi = buf.unbind(0)
    return buf, (upv.view(torch.float32), upi, lov.view(torch.float32), loi)


class FoldSelectPlan(NamedTuple):
    """Kernels B2 and B3's launch: `blocks` blocks of `warps` warps, warp w
    of block b taking the 128-element row b warps + w (one row a warp,
    four elements a lane)."""
    warps: int
    blocks: int


def fold_select_plan(rows: int) -> FoldSelectPlan:
    """B2 and B3's launch for `rows` 128-element rows: blocks of one warp,
    one row each (472 blocks at the 60000-row headline, 3912 at covtype
    scale, all resident at once on the 132 SMs: up to 32 a SM). Larger
    blocks time the same (PERF.md section 6). csrc/fold_select.cu checks
    the plan it is given (1-8 warps a block, ceil(rows / warps)
    blocks)."""
    if rows < 1:
        raise ValueError(f"fold_select takes at least one row, got {rows}")
    return FoldSelectPlan(1, rows)


class _Lib(NamedTuple):
    """csrc/fold_select.cu's typed entry points (stamps: the timing
    build's reader, else None)."""
    fold_select: object
    select_rows: object
    fold_rows_select: object
    stamps: object


def bind(so: ctypes.CDLL) -> _Lib:
    """Type the entry points of a build of csrc/fold_select.cu."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sigs = {
        # f, err, alpha, y, valid, delta, f_out, err_out, cand; rows,
        # compensated, the plan (warps, blocks)
        "dpsvm_fold_select": [ptr] * 9 + [i32] * 4 + [f32, f32, ptr],
        # f, alpha, y, valid, cand; rows, the plan
        "dpsvm_select_rows": [ptr] * 5 + [i32] * 3 + [f32, f32, ptr],
        # k_rows, coef, f, err, alpha, y, valid, f_out, err_out, cand;
        # q, rows, compensated, the plan (warps, chunk, stages, smem)
        "dpsvm_fold_rows_select": [ptr] * 10 + [i32] * 7 + [f32, f32, ptr],
        "dpsvm_fold_select_stamps": [ptr],
    }
    fns = []
    for name, argtypes in sigs.items():
        fn = getattr(so, name, None)
        if fn is not None:
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
        fns.append(fn)
    return _Lib(*fns)


_lib = None


def lib() -> _Lib:
    """csrc/fold_select.cu, built at first use and bound once."""
    global _lib
    if _lib is None:
        from dpsvm_tpu_torch.ops import _build

        _lib = bind(_build.load("fold_select"))
    return _lib


def raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _fold_launch(f2d, err2d, alpha2d, y2d, valid2d, delta2d, c,
                 compensated: bool, plan: FoldSelectPlan, so: _Lib):
    """Kernel B2 on checked CUDA views with the launch plan `plan`."""
    rows = f2d.shape[0]
    f_out = torch.empty_like(f2d)
    err_out = torch.empty_like(f2d) if compensated else None
    buf, cands = cand_outputs(rows, f2d.device)
    raise_on(so.fold_select(
        f2d.data_ptr(), err2d.data_ptr() if compensated else None,
        alpha2d.data_ptr(), y2d.data_ptr(), valid2d.data_ptr(),
        delta2d.data_ptr(), f_out.data_ptr(),
        err_out.data_ptr() if compensated else None, buf.data_ptr(), rows,
        compensated, *plan, *c_consts(c),
        torch.cuda.current_stream(f2d.device).cuda_stream), "fold_select")
    return (f_out, err_out, *cands)


def _select_launch(f2d, alpha2d, y2d, valid2d, c, plan: FoldSelectPlan,
                   so: _Lib):
    """Kernel B3 on checked CUDA views with the launch plan `plan`."""
    rows = f2d.shape[0]
    buf, cands = cand_outputs(rows, f2d.device)
    raise_on(so.select_rows(
        f2d.data_ptr(), alpha2d.data_ptr(), y2d.data_ptr(),
        valid2d.data_ptr(), buf.data_ptr(), rows, *plan, *c_consts(c),
        torch.cuda.current_stream(f2d.device).cuda_stream), "select_rows")
    return cands


def fold_select(f2d, err2d, alpha2d, y2d, valid2d, delta2d, c,
                compensated: bool = False):
    """Fold delta into f (Kahan when compensated) and emit per-row
    working-set candidates (kernel B2).

    All arrays are (R, 128) float32 views; err2d is None unless
    compensated. Returns (f_new2d, err_new2d or None, up_vals, up_ids,
    low_vals, low_ids), one candidate per 128-element row."""
    if compensated:
        dev = check_views(f2d, alpha2d, y2d, valid2d, delta2d, err2d)
    else:
        dev = check_views(f2d, alpha2d, y2d, valid2d, delta2d)
    if dev.type == "cpu":
        return _fold_select(f2d, err2d, alpha2d, y2d, valid2d, delta2d, c,
                            compensated)
    out = _fold_launch(f2d, err2d, alpha2d, y2d, valid2d, delta2d, c,
                       compensated, fold_select_plan(f2d.shape[0]), lib())
    fold_select.launches += 1
    return out


def select_rows(f2d, alpha2d, y2d, valid2d, c):
    """Per-row working-set candidates from f AS IT STANDS (kernel B3: no
    delta, no write-back). A compensated caller passes the effective f
    (f - err). Returns (up_vals, up_ids, low_vals, low_ids)."""
    dev = check_views(f2d, alpha2d, y2d, valid2d)
    if dev.type == "cpu":
        return _select_rows(f2d, alpha2d, y2d, valid2d, c)
    out = _select_launch(f2d, alpha2d, y2d, valid2d, c,
                         fold_select_plan(f2d.shape[0]), lib())
    select_rows.launches += 1
    return out


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
