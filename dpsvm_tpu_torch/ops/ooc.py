"""Out-of-core tile primitives: one tile's share of the round fold
(counterpart of dpsvm_tpu/ops/ooc.py).

The in-core block engine folds with ONE (q, d) x (d, n) pass over the
resident X (solver/block.py fold_block). Out of core (config.ooc,
solver/ooc.py) X stays on the host and the same fold runs tile by tile
over (T, d) blocks streamed to the device: the (q, T) dot rows, the
kernel transform, ``coef @ K`` and the plain or Kahan accumulate into
the tile's slice of the gradient. Every operand is tile- or q-sized, so
the fold's device footprint does not grow with n.

As in the JAX package this is stock tensor algebra, not a hand-written
kernel: the products are ops/kernels.py mm_f32 (cuBLAS on the card).
Its operation order is the in-core fold's (row_dots, kernel_from_dots,
coef @ K, maybe_kahan), so a tile's gradient slice is the in-core
fold's wherever the library reduces a (q, T) product as it reduces the
matching columns of the (q, n) one (solver/ooc.py says where that
holds).
"""

from __future__ import annotations

import torch

from dpsvm_tpu_torch.ops.kernels import (KernelParams, kernel_from_dots,
                                         mm_f32)
from dpsvm_tpu_torch.solver.smo import kahan_add


def fold_tile_body(x_tile: torch.Tensor, xsq_tile: torch.Tensor,
                   f_tile: torch.Tensor, err_tile, qx: torch.Tensor,
                   qsq: torch.Tensor, coef: torch.Tensor, kp: KernelParams,
                   want_dots: bool = False, compensated: bool = False):
    """The fold algebra of one tile. Returns (f_new, err_new, dots):
    the folded gradient slice, its Kahan residual (None uncompensated)
    and the raw (q, T) dot rows when `want_dots` (the block cache's
    currency: it stores dot rows and applies the kernel per use), else
    None."""
    dots = mm_f32(qx.to(x_tile.dtype), x_tile.t())  # (q, T) float32
    k = kernel_from_dots(dots, xsq_tile, qsq, kp)
    delta = coef @ k  # (T,)
    if compensated:
        f_new, err_new = kahan_add(f_tile, err_tile, delta)
    else:
        f_new, err_new = f_tile + delta, None
    return f_new, err_new, (dots if want_dots else None)


def ooc_fold_tile(x_tile, xsq_tile, f_tile, err_tile, qx, qsq, coef,
                  kp: KernelParams, want_dots: bool = False,
                  compensated: bool = False):
    """One tile's share of the round fold (the JAX package's jitted
    entry point of the same name; here it is fold_tile_body itself).

    x_tile   (T, d)  streamed tile of X in the storage dtype
    xsq_tile (T,)    the tile rows' squared norms
    f_tile   (T,)    the tile's slice of the carried gradient
    err_tile (T,) or None  its Kahan residual (config.compensated)
    qx       (q, d)  working-set rows; qsq (q,) their squared norms
    coef     (q,)    fold coefficients (dalpha * y, dead slots zero)
    """
    return fold_tile_body(x_tile, xsq_tile, f_tile, err_tile, qx, qsq,
                          coef, kp, want_dots=want_dots,
                          compensated=compensated)
