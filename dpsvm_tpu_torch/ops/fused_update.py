"""Fused rank-2 gradient update + next pair selection (counterpart of
dpsvm_tpu/ops/pallas_fused.py fused_update_select, kernel B6).

One pass over the (R, 128) float32 views of the per-pair engine's O(n)
vectors (R = n_pad / 128):

    k_hi = kernel_from_dots(d_hi, x_sq, qsq_hi)    (and k_lo alike)
    f'   = f + coef_hi * k_hi + coef_lo * k_lo      (two fused multiply-
                                                    adds, as XLA does)
    b_hi = min f' over I_up, b_lo = max f' over I_low (masks from the
           ALREADY-SCATTERED alpha and `valid`), each with the lowest
           flat id whose value equals it

``fused_update_select`` launches the Hopper kernel of
csrc/fused_update.cu for CUDA tensors, split by ``fused_update_plan``,
and runs its plain PyTorch version ``_fused_update_select`` for CPU
tensors; any other device raises. It counts its kernel launches in
``.launches``.

The values are the IEEE minimum / maximum, as XLA reduces: a +-0 tie
gives -0.0 for b_hi and +0.0 for b_lo whenever a member has that sign.
An empty set reports +inf (up) / -inf (low) with id 0. NaN in f is not
supported.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from dpsvm_tpu_torch.ops.fold_select import (LANES, c_consts, check_views,
                                             emit_row_candidates, raise_on)
from dpsvm_tpu_torch.ops.kernels import KernelParams, kernel_from_dots
from dpsvm_tpu_torch.ops.select import from_order_key, order_key
from dpsvm_tpu_torch.solver.smo import fma32

__all__ = ["LANES", "fused_update_plan", "fused_update_select"]

_KINDS = {"rbf": 0, "linear": 1, "poly": 2, "sigmoid": 3}
_IMAX = 2 ** 31 - 1
_THREADS = 128


class FusedUpdatePlan(NamedTuple):
    """Kernel B6's launch: `blocks` blocks of `threads`, thread t of block
    b taking the group of four elements b threads + t. `smem`: the block's
    dynamic shared-memory bytes (one 20-byte record a warp)."""
    threads: int
    blocks: int
    smem: int


def fused_update_plan(n: int) -> FusedUpdatePlan:
    """B6's launch for n elements (a multiple of 4): 128-thread blocks,
    one group of four a thread (128 blocks at n = 65536). Of the block
    sizes chip_smoke.py --turns times on the H100 (32 to 256 threads) this
    is the fastest; 64, whose 256 blocks reach all 132 SMs, is slower by
    the tail's twice as many atomics. csrc/fused_update.cu checks the plan
    it is given."""
    if n < 4 or n % 4:
        raise ValueError(f"B6 takes a multiple of 4 elements, got {n}")
    return FusedUpdatePlan(_THREADS, -(-(n // 4) // _THREADS),
                           20 * (_THREADS // 32))


def reduce_candidates(upv, upi, lov, loi) -> tuple:
    """(b_hi, i_hi, b_lo, i_lo) from per-row candidates: the IEEE
    extrema and the lowest id among the rows that reach them (the JAX
    kernel's epilogue over its per-block partials)."""
    b_hi = from_order_key(order_key(upv).amin())
    b_lo = from_order_key(order_key(lov).amax())
    i_hi = torch.where(upv == b_hi, upi, _IMAX).amin()
    i_lo = torch.where(lov == b_lo, loi, _IMAX).amin()
    return b_hi, i_hi, b_lo, i_lo


def _fused_update_select(f2d, alpha2d, y2d, valid2d, d_hi2d, d_lo2d, x_sq2d,
                         scalars, kp: KernelParams, c):
    """Plain PyTorch version of kernel B6: same contract as
    fused_update_select."""
    k_hi = kernel_from_dots(d_hi2d, x_sq2d, scalars[2], kp)
    k_lo = kernel_from_dots(d_lo2d, x_sq2d, scalars[3], kp)
    f_new = fma32(scalars[1], k_lo, fma32(scalars[0], k_hi, f2d))
    return (f_new, *reduce_candidates(
        *emit_row_candidates(f_new, alpha2d, y2d, valid2d, c)))


def lib_fn():
    """csrc/fused_update.cu's entry point, built at first use."""
    from dpsvm_tpu_torch.ops import _build

    fn = _build.load("fused_update").dpsvm_fused_update_select
    if fn.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.restype = ctypes.c_int
        # scalars, f, alpha, y, valid, d_hi, d_lo, x_sq, f_out, words, out;
        # n, the plan (threads, blocks, smem); the kernel family; c
        fn.argtypes = ([ptr] * 11 + [i32] * 5 + [f32, f32, i32, f32, f32,
                                                 ptr])
    return fn


# The kernel's cross-block words, one set per (device, stream), empty
# ({~0, ~0, 0, 0}: two 64-bit keys, flags, arrivals) between launches:
# every launch leaves them so, and launches on one stream run in order.
_word_sets: dict = {}


def _words(dev, stream) -> torch.Tensor:
    key = (dev.index, stream.cuda_stream)
    words = _word_sets.get(key)
    if words is None:
        words = _word_sets[key] = torch.tensor([-1, -1, 0],
                                               dtype=torch.int64, device=dev)
    return words


def _launch(args, plan: FusedUpdatePlan, kp: KernelParams, c):
    """Kernel B6 on checked CUDA views (`args` as fused_update_select
    takes them up to kp) with the launch plan `plan`."""
    f2d, alpha2d, y2d, valid2d, d_hi2d, d_lo2d, x_sq2d, scalars = args
    dev = f2d.device
    f_out = torch.empty_like(f2d)
    # (b_hi, b_lo) float32, then (i_hi, i_lo) int32: a fresh buffer each
    # launch, so a result the caller holds is never overwritten.
    out = torch.empty(4, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev)
    raise_on(lib_fn()(
        scalars.data_ptr(), f2d.data_ptr(), alpha2d.data_ptr(),
        y2d.data_ptr(), valid2d.data_ptr(), d_hi2d.data_ptr(),
        d_lo2d.data_ptr(), x_sq2d.data_ptr(), f_out.data_ptr(),
        _words(dev, stream).data_ptr(), out.data_ptr(), f2d.numel(),
        *plan, _KINDS[kp.kind], float(kp.gamma), float(kp.coef0),
        int(kp.degree), *c_consts(c), stream.cuda_stream),
        "fused_update_select")
    out_v = out[:2].view(torch.float32)
    return f_out, out_v[0], out[2], out_v[1], out[3]


def fused_update_select(f2d, alpha2d, y2d, valid2d, d_hi2d, d_lo2d, x_sq2d,
                        scalars, kp: KernelParams, c):
    """Apply the rank-2 update and select the next pair (kernel B6).

    The first seven arguments are (R, 128) float32 views (valid2d 1.0 on
    real rows); scalars (4,) float32 = (coef_hi, coef_lo, qsq_hi,
    qsq_lo) on the same device. Returns (f_new2d, b_hi, i_hi, b_lo,
    i_lo): 0-d float32 extrema and int32 flat ids."""
    dev = check_views(f2d, alpha2d, y2d, valid2d, d_hi2d, d_lo2d, x_sq2d)
    if (scalars.shape != (4,) or scalars.dtype != torch.float32
            or scalars.device != dev or not scalars.is_contiguous()):
        raise ValueError(f"scalars must be a contiguous (4,) float32 tensor "
                         f"on {dev}")
    if kp.kind not in _KINDS:
        raise ValueError(f"fused_update_select takes feature kernels only, "
                         f"got {kp.kind!r}")
    if dev.type == "cpu":
        return _fused_update_select(f2d, alpha2d, y2d, valid2d, d_hi2d,
                                    d_lo2d, x_sq2d, scalars, kp, c)
    out = _launch((f2d, alpha2d, y2d, valid2d, d_hi2d, d_lo2d, x_sq2d,
                  scalars), fused_update_plan(f2d.numel()), kp, c)
    fused_update_select.launches += 1
    return out


#: Kernel launches (CPU calls never count).
fused_update_select.launches = 0
