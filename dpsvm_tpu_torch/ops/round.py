"""The one-pass block round (counterpart of dpsvm_tpu/ops/pallas_round.py,
kernels B4 and B5).

A round of the fused-round engine is two passes with the subproblem
between them:

``gather_gram`` (B4)
    one pass over X: gather the q working-set rows, emit the (q, n_pad)
    kernel rows K(W, :) and the (q, q) Gram block K(W, W) from the same
    rows.

``fold_rows_select`` (B5)
    one pass over the kernel rows and the (R, 128) views: the fold delta
    coef @ K(W, :) is contracted inside the pass, folded into f (Kahan
    when compensated) and the next round's per-row candidates are
    emitted, exactly as ops/fold_select.py fold_select does with a delta
    read from memory.

``fused_round`` composes them: gather_gram -> dispatch_subproblem ->
alpha scatter -> fold_rows_select -> assemble_working_set.

Each kernel function launches its Hopper kernel (csrc/gather_gram.cu,
csrc/fold_select.cu; B5 split by ``fold_rows_plan``) for CUDA tensors
and runs its plain PyTorch version
(``_gather_gram``, ``_fold_rows_select``) for CPU tensors; any other
device raises. The plain versions are stage for stage what the fused-fold
engine computes (``x[w]``, ``kernel_rows``, ``coef @ k_rows``,
``fold_select``), so on the CPU the fused-round trajectory equals the
fused-fold one bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dpsvm_tpu_torch.ops import fold_select as fs
from dpsvm_tpu_torch.ops.fold_select import (LANES, assemble_working_set,
                                             check_views)
from dpsvm_tpu_torch.ops.kernels import (KernelParams, kernel_from_dots,
                                         kernel_rows, mm_f32)
from dpsvm_tpu_torch.ops.subproblem import SMEM_LIMIT

_KINDS = {"rbf": 0, "linear": 1, "poly": 2, "sigmoid": 3}
_MAX_Q = 8192
_SEG = 4 * LANES  # bytes of one kernel row's 128 columns
# B5's plan: warps a block, kernel rows a ring stage, stages a warp.
_WARPS, _CHUNK, _STAGES = 4, 8, 3


class FoldRowsPlan(NamedTuple):
    """Kernel B5's launch: one block of `warps` warps per 128-column row
    (`blocks` of them), warp w folding the kernel rows k_range(q, warps,
    w); each warp streams them into shared memory on a ring of `stages`
    stages of `chunk` rows. `smem`: the block's dynamic shared-memory
    bytes."""
    warps: int
    chunk: int
    stages: int
    smem: int
    blocks: int


def k_range(q: int, warps: int, w: int) -> range:
    """The kernel rows warp w of a B5 block folds (csrc/fold_select.cu
    fold_rows_kernel): contiguous, as even as q allows."""
    return range(w * q // warps, (w + 1) * q // warps)


def fold_rows_smem(q: int, warps: int, chunk: int, stages: int) -> int:
    """B5's shared memory (csrc/fold_select.cu rows_smem): the rings, the
    warps' partial deltas, the q coefficients (to 16 bytes) and an
    8-byte mbarrier per stage."""
    return (warps * stages * chunk * _SEG + warps * _SEG
            + -(-q // 4) * 16 + 8 * warps * stages)


def fold_rows_plan(q: int, rows: int) -> FoldRowsPlan:
    """B5's launch: up to 4 warps a block (never more than q), 8 rows a
    stage and 3 stages a warp, fewer stages where a warp's range is
    shorter (the fastest of the plans that chip_smoke.py --turns times on
    the H100). At the headline (q 256, 472 rows) a block has
    48 KB in flight and 52 KB of shared memory, so four fit an SM and all
    472 blocks run at once on the 132 SMs. csrc/fold_select.cu checks the
    plan it is given."""
    if not 1 <= q <= _MAX_Q:
        raise ValueError(f"fold_rows_select takes 1 <= q <= {_MAX_Q}, "
                         f"got {q}")
    warps = min(_WARPS, q)
    longest = -(-q // warps)  # the rows of the longest warp range
    stages = min(_STAGES, -(-longest // _CHUNK))
    return FoldRowsPlan(warps, _CHUNK, stages,
                        fold_rows_smem(q, warps, _CHUNK, stages), rows)


def _gather_gram(x, w, x_sq, qsq, kp: KernelParams):
    """Plain PyTorch version of kernel B4: same contract as gather_gram."""
    qx = x[w]
    k_rows = kernel_rows(x, x_sq, qx, qsq, kp)
    kb = kernel_from_dots(mm_f32(qx, qx.t()), qsq, qsq, kp)
    return k_rows, kb


def _dot_slope(x_sq, kp: KernelParams) -> float:
    """The kernel family's largest slope in the dot, for dots of rows
    whose squared norms are `x_sq` (rbf's: 2 gamma, as K <= 1)."""
    vmax = kp.gamma * float(x_sq.max()) + kp.coef0
    return {"rbf": 2 * kp.gamma, "linear": 1.0, "sigmoid": kp.gamma,
            "poly": kp.degree * vmax ** (kp.degree - 1) * kp.gamma}[kp.kind]


def gram_tolerance(x_sq, d: int, kp: KernelParams, k_abs):
    """How far two float32 evaluations of the same kernel values, each
    summing the d products of every dot in its own order, may lie apart:
    the dots differ by at most 2 d 2^-24 max|x|^2 (each sum is within
    d 2^-24 sum |x_i y_i| of the exact dot, and sum |x_i y_i| <= max|x|^2),
    carried through the kernel family's slope in the dot, plus 4 ulps
    (2^-23 each) of `k_abs`, the magnitude of K (a tensor of |K| for an
    elementwise bound, or a scalar bound of |K|), for exp / tanh / pow.

    x_sq: the rows' squared norms (max |x|^2 is their maximum). The bound
    kernel B4 (csrc/gather_gram.cu) is held to against its plain version,
    on the card and in the CPU tests of what the rule catches."""
    e = 2.0 * d * 2.0 ** -24 * float(x_sq.max())
    return _dot_slope(x_sq, kp) * e + 4 * 2.0 ** -23 * k_abs


def gram_f64(x, w, x_sq, qsq, kp: KernelParams):
    """K(W, :) and K(W, W) carried in float64 from the stored rows of x
    and the given float32 norms: the yardstick that a float32
    evaluation's own rounding is measured against."""
    x64 = x.double()
    q64 = x64[w]
    return (kernel_from_dots(q64 @ x64.t(), x_sq.double(), qsq.double(), kp),
            kernel_from_dots(q64 @ q64.t(), qsq.double(), qsq.double(), kp))


def tf32x3_check(got, plain, ref, x_sq, kp: KernelParams):
    """Whether B4's float32 path is 3xTF32 (csrc/mma_tile.cuh) and not a
    cheaper product: `got` (the kernel's K), `plain` (the plain version's)
    and `ref` (gram_f64) are tuples of matching tensors. The kernel's
    largest error against the float64 Gram may be 4 times the plain
    version's own (the sums' rounding, in another order and through the
    MMA's truncating adds) plus 3 . 2^-22 max|x|^2 (the split's product
    error, at most 3 . 2^-22 |a b| a product, summed over a dot: sum
    |a_k b_k| <= max|x|^2) carried through the family's slope, plus 4 ulps
    of max |K|. One-pass TF32 (2^-10 |a b| a product) lands about 100
    times the plain version's error off on headline-shaped data
    (tests/test_torch_round.py). Returns (kernel's error, plain's
    error, limit)."""
    err = max(float((g.double() - r).abs().max()) for g, r in zip(got, ref))
    err_p = max(float((p.double() - r).abs().max())
                for p, r in zip(plain, ref))
    k_max = max(float(r.abs().max()) for r in ref)
    limit = (4.0 * err_p
             + _dot_slope(x_sq, kp) * 3 * 2.0 ** -22 * float(x_sq.max())
             + 4 * 2.0 ** -23 * k_max)
    return err, err_p, limit


def _gather_lib():
    import ctypes

    from dpsvm_tpu_torch.ops import _build

    fn = _build.load("gather_gram").dpsvm_gather_gram
    if fn.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.restype = ctypes.c_int
        fn.argtypes = ([ptr, i32] + [ptr] * 5 + [i32] * 4 + [f32, f32, i32,
                                                           ptr])
    return fn


def gather_gram(x, w, x_sq, qsq, kp: KernelParams):
    """The round's pass over X (kernel B4): the (q, n_pad) float32 kernel
    rows K(W, :) and the (q, q) Gram block K(W, W) of the working set.

    x (n_pad, d) float32 or bfloat16; w (q,) int32 row ids (dead slots
    carry in-range filler); x_sq (n_pad,) and qsq (q,) = x_sq[w] float32
    squared norms. Returns (k_rows, kb)."""
    dev = x.device
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be 2-D float32 or bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    n, d = x.shape
    q = w.shape[0]
    if (w.dim() != 1 or w.dtype != torch.int32 or x_sq.shape != (n,)
            or qsq.shape != (q,) or x_sq.dtype != torch.float32
            or qsq.dtype != torch.float32):
        raise ValueError("gather_gram takes w (q,) int32 and float32 x_sq "
                         "(n,), qsq (q,)")
    if any(t.device != dev or not t.is_contiguous()
           for t in (x, w, x_sq, qsq)):
        raise ValueError(f"gather_gram inputs must be contiguous on {dev}")
    if kp.kind not in _KINDS:
        raise ValueError(f"gather_gram takes feature kernels only, got "
                         f"{kp.kind!r}")
    if dev.type == "cpu":
        return _gather_gram(x, w, x_sq, qsq, kp)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    k_rows = torch.empty((q, n), dtype=torch.float32, device=dev)
    kb = torch.empty((q, q), dtype=torch.float32, device=dev)
    err = _gather_lib()(
        x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(),
        x_sq.data_ptr(), qsq.data_ptr(), k_rows.data_ptr(), kb.data_ptr(),
        n, d, q, _KINDS[kp.kind], float(kp.gamma), float(kp.coef0),
        int(kp.degree), torch.cuda.current_stream(dev).cuda_stream)
    fs.raise_on(err, "gather_gram")
    gather_gram.launches += 1
    return k_rows, kb


def _fold_rows_select(k_rows, coef, f2d, err2d, alpha2d, y2d, valid2d, c,
                      compensated: bool = False):
    """Plain PyTorch version of kernel B5: same contract as
    fold_rows_select."""
    delta2d = (coef @ k_rows).view(f2d.shape)
    return fs._fold_select(f2d, err2d, alpha2d, y2d, valid2d, delta2d, c,
                           compensated)


def fold_rows_select(k_rows, coef, f2d, err2d, alpha2d, y2d, valid2d, c,
                     compensated: bool = False):
    """Fold coef @ K(W, :) into f (Kahan when compensated) and emit the
    next round's per-row candidates, the delta contracted inside the pass
    (kernel B5).

    k_rows (q, n_pad) float32; coef (q,) float32 fold coefficients (dead
    slots zeroed); the rest are the (n_pad / 128, 128) views fold_select
    takes. Returns fold_select's (f_new2d, err_new2d or None, up_vals,
    up_ids, low_vals, low_ids)."""
    dev = check_views(f2d, alpha2d, y2d, valid2d,
                      *((err2d,) if compensated else ()))
    rows = f2d.shape[0]
    q = coef.shape[0]
    if (k_rows.shape != (q, rows * LANES) or coef.dim() != 1
            or k_rows.dtype != torch.float32 or coef.dtype != torch.float32
            or k_rows.device != dev or coef.device != dev
            or not k_rows.is_contiguous() or not coef.is_contiguous()):
        raise ValueError(f"fold_rows_select takes float32 k_rows "
                         f"({q}, {rows * LANES}) and coef ({q},) on {dev}")
    if dev.type == "cpu":
        return _fold_rows_select(k_rows, coef, f2d, err2d, alpha2d, y2d,
                                 valid2d, c, compensated)
    out = _fold_rows_launch(k_rows, coef, f2d, err2d, alpha2d, y2d,
                            valid2d, c, compensated, fold_rows_plan(q, rows))
    fold_rows_select.launches += 1
    return out


def _fold_rows_launch(k_rows, coef, f2d, err2d, alpha2d, y2d, valid2d, c,
                      compensated: bool, plan: FoldRowsPlan):
    """Kernel B5 on checked CUDA inputs with the launch plan `plan`."""
    dev = f2d.device
    if k_rows.data_ptr() % 16:
        raise ValueError("k_rows must be 16-byte aligned")
    rows = f2d.shape[0]
    f_out = torch.empty_like(f2d)
    err_out = torch.empty_like(f2d) if compensated else None
    buf, cands = fs.cand_outputs(rows, dev)
    fs.raise_on(fs.lib().fold_rows_select(
        k_rows.data_ptr(), coef.data_ptr(), f2d.data_ptr(),
        err2d.data_ptr() if compensated else None, alpha2d.data_ptr(),
        y2d.data_ptr(), valid2d.data_ptr(), f_out.data_ptr(),
        None if err_out is None else err_out.data_ptr(),
        buf.data_ptr(), coef.shape[0], rows,
        int(compensated), *plan[:4], *fs.c_consts(c),
        torch.cuda.current_stream(dev).cuda_stream), "fold_rows_select")
    return (f_out, err_out, *cands)


#: Kernel launches (CPU calls never count).
gather_gram.launches = 0
fold_rows_select.launches = 0


def fused_round(x, y, x_sq, k_diag, y2d, valid2d, alpha, f, f_err, w,
                slot_ok, b_hi, b_lo, budget_left, kp: KernelParams, c,
                eps: float, tau: float, q: int, inner_iters: int,
                selection: str, pair_batch: int = 1):
    """ONE block round as gather_gram -> dispatch_subproblem -> scatter ->
    fold_rows_select -> assemble_working_set: the fused-fold round with
    its gather, Gram, kernel-row and contraction stages in the two
    passes.

    (w, slot_ok, b_hi, b_lo) is the working set the previous round's
    pass selected, with its exact post-fold extrema. Returns (alpha, f,
    f_err, b_hi_n, b_lo_n, w_n, ok_n, t): the updated state, the next
    round's working set and the executed pair count."""
    from dpsvm_tpu_torch.solver.block import dispatch_subproblem, scatter_alpha

    n_pad = y.shape[0]
    shp = (n_pad // LANES, LANES)
    compensated = f_err is not None
    gap_open = b_lo > b_hi + 2.0 * eps
    qsq = x_sq[w]
    kd_w = k_diag[w]
    a_w0 = alpha[w]
    y_w = y[w]
    f_w0 = f[w] if f_err is None else f[w] - f_err[w]  # eff_f at W
    k_rows, kb_w = gather_gram(x, w, x_sq, qsq, kp)
    # Per-round pair budget, clamped to what the solve has left and gated
    # to 0 on the terminal round.
    limit = torch.clamp(budget_left, max=inner_iters)
    limit = torch.where(gap_open, limit, 0).to(torch.int32)
    a_w, coef, t = dispatch_subproblem(kb_w, kd_w, slot_ok, a_w0, y_w, f_w0,
                                       c, eps, tau, limit, selection,
                                       pair_batch)
    # Scatter alpha BEFORE the pass: its masks must see the new box
    # membership.
    alpha = scatter_alpha(alpha, w, slot_ok, a_w)
    f2d, err2d, upv, upi, lov, loi = fold_rows_select(
        k_rows, coef, f.view(shp), f_err.view(shp) if compensated else None,
        alpha.view(shp), y2d, valid2d, c, compensated=compensated)
    w_n, ok_n, b_hi_n, b_lo_n = assemble_working_set(upv, upi, lov, loi,
                                                     q // 2)
    return (alpha, f2d.view(n_pad),
            err2d.view(n_pad) if compensated else None,
            b_hi_n, b_lo_n, w_n, ok_n, t)
