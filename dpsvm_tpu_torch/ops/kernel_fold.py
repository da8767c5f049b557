"""The block round's fold after the kernel-row GEMM: delta = coef @ K(W, :)
in one pass over the (q, n) dot block (csrc/kernel_fold.cu).

``fold_kernel_rows(x, x_sq, qx, qsq, coef, kp)`` is the delta
solver/block.py fold_block folds into the gradient. On the CPU it is
literally ``coef @ kernel_rows(...)``, so every CPU trajectory is what it
was bit for bit; so it is for kind "precomputed" on any device (the
gathered Gram rows are the kernel values). On CUDA it is ``row_dots``
(cuBLAS's SGEMM through mm_f32: float32 products, TF32 off) and then
``fold_dots``: one launch of the hand-written kernel, which reads each dot
once, applies kernel_from_dots' per-element operations in their order,
multiplies by coef[k] and sums over k in order k, and writes only the
(n,) delta, where the plain version materialises (q, n) temporaries for
each elementwise step and reads the result again in a gemv. Any other
device raises.

``fold_dots(dots, x_sq, q_sq, coef, kp)`` is the kernel's wrapper and
``_fold_dots`` its plain version. It counts its launches in
``fold_dots.launches``.

Column invariance: the delta of column j depends only on column j's dots,
x_sq[j] and the coefficients, so folding a subset of the columns (a mesh
shard's rows) gives bit for bit those columns of a fold over all n.
"""

from __future__ import annotations

import ctypes

import torch

from dpsvm_tpu_torch.ops.kernels import (KernelParams, kernel_from_dots,
                                         kernel_rows, row_dots)

_KINDS = {"rbf": 0, "linear": 1, "poly": 2, "sigmoid": 3}
_MAX_N = 2 ** 31 - 1  # csrc/kernel_fold.cu takes n as a C int


def _fold_dots(dots, x_sq, q_sq, coef, kp: KernelParams):
    """Plain PyTorch version of the kernel: same contract as fold_dots."""
    return coef @ kernel_from_dots(dots, x_sq, q_sq, kp)


_fn = None


def _lib():
    """csrc/kernel_fold.cu's entry point, built at first use and typed
    once."""
    global _fn
    if _fn is None:
        from dpsvm_tpu_torch.ops import _build

        fn = _build.load("kernel_fold").dpsvm_kernel_fold
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.restype = ctypes.c_int
        # dots, x_sq, q_sq, coef, out; q, n, kind; gamma, coef0; degree;
        # stream
        fn.argtypes = [ptr] * 5 + [i32] * 3 + [f32, f32, i32, ptr]
        _fn = fn
    return _fn


def fold_dots(dots, x_sq, q_sq, coef, kp: KernelParams):
    """coef @ K(dots): the fold's delta from the (q, n) dot block.

    dots (q, n) float32, x_sq (n,) the data rows' squared norms, q_sq (q,)
    the working-set rows' (read for rbf only), coef (q,) the fold
    coefficients (dead slots zeroed): all float32, contiguous, on one
    device. Returns the (n,) float32 delta. CUDA tensors go through the
    kernel, CPU tensors through the plain version; anything else
    raises."""
    if dots.dim() != 2:
        raise ValueError(f"dots must be (q, n), got {tuple(dots.shape)}")
    q, n = dots.shape
    dev = dots.device
    for name, t, shape in (("dots", dots, (q, n)), ("x_sq", x_sq, (n,)),
                           ("q_sq", q_sq, (q,)), ("coef", coef, (q,))):
        if (not isinstance(t, torch.Tensor) or t.shape != shape
                or t.dtype != torch.float32 or t.device != dev
                or not t.is_contiguous()):
            got = (f"{tuple(t.shape)} {t.dtype} on {t.device}"
                   if isinstance(t, torch.Tensor) else type(t).__name__)
            raise ValueError(f"fold_dots takes {name} as a contiguous "
                             f"{shape} float32 tensor on {dev}, got {got}")
    if kp.kind not in _KINDS:
        raise ValueError(f"fold_dots takes feature kernels only, got "
                         f"{kp.kind!r}")
    if dev.type == "cpu":
        return _fold_dots(dots, x_sq, q_sq, coef, kp)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if n > _MAX_N:
        raise ValueError(f"fold_dots takes at most {_MAX_N} columns, got {n}")
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    err = _lib()(dots.data_ptr(), x_sq.data_ptr(), q_sq.data_ptr(),
                 coef.data_ptr(), out.data_ptr(), q, n, _KINDS[kp.kind],
                 float(kp.gamma), float(kp.coef0), int(kp.degree),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kernel_fold launch failed: CUDA error {err}")
    fold_dots.launches += 1
    return out


#: Kernel launches (CPU calls never count).
fold_dots.launches = 0


def fold_kernel_rows(x, x_sq, qx, qsq, coef, kp: KernelParams):
    """coef @ K(W, :), the (n,) fold delta of the working-set rows qx
    (their squared norms qsq) against every row of x: on CUDA the dots
    GEMM and then one pass of the kernel (fold_dots); on the CPU, and for
    a precomputed Gram on any device, coef @ kernel_rows(...)."""
    if kp.kind == "precomputed" or x.device.type == "cpu":
        return coef @ kernel_rows(x, x_sq, qx, qsq, kp)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return fold_dots(row_dots(x, qx), x_sq, qsq, coef, kp)
