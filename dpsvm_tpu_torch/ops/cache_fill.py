"""Fill the missed lines of the per-pair engines' row cache (kernel
cache_fill; it replaces no TPU kernel).

The JAX package branches on the hit/miss case of a lookup inside its
compiled per-pair loop (dpsvm_tpu/solver/cache.py lookup_pair's
lax.switch, lookup_one's lax.cond). The port keeps the cache's keys and
ticks on the device (solver/cache.py), so the case is device data and
the host cannot branch on it without a read. ``cache_fill`` takes the
case as device tensors instead:

    for each query r with flags[r]:  store[dest[r]] = row_dots(x, x[ids[r]])

in place; a query that hit (or a masked trip's, whose flags are all off)
writes nothing. A pair's third flag, save, copies line dest[1] to line
dest[0] before the fill: query 0 hit the line query 1's row replaces
(the one-line cache), and its row must survive in the spare line. ``cache_fill`` launches the Hopper kernel of
csrc/cache_fill.cu for CUDA tensors and runs its plain PyTorch version
``_cache_fill`` for CPU tensors: that one reads the flags and computes
what the JAX branch computes (one (2, d) x (d, n) product on a double
miss, a (1, d) one on a single miss). Any other device raises. It counts
its kernel launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from dpsvm_tpu_torch.ops.kernels import row_dots

__all__ = ["cache_fill", "cache_fill_plan"]

_WARPS = 8  # csrc/cache_fill.cu kWarps
_MAX_BLOCKS = 132 * 16  # enough to fill the H100's 132 SMs


class CacheFillPlan(NamedTuple):
    """The kernel's launch: `blocks` blocks of 256 threads, one warp a
    row of X in a grid-stride loop; `vec` when every row starts 16-byte
    aligned (16-byte loads)."""
    blocks: int
    vec: bool


def cache_fill_plan(x: torch.Tensor) -> CacheFillPlan:
    """The launch for X (n, d): one warp a row up to _MAX_BLOCKS blocks;
    16-byte loads when d values of X's type fill whole 16-byte words."""
    n, d = x.shape
    per = 16 // x.element_size()
    return CacheFillPlan(min(-(-n // _WARPS), _MAX_BLOCKS),
                         d % per == 0 and x.data_ptr() % 16 == 0)


def _cache_fill(x, store, ids, dest, flags) -> None:
    """Plain PyTorch version of the kernel: same contract as
    cache_fill. It reads the flags on the host and computes the missed
    rows as the JAX package's branches do."""
    fl = flags.tolist()
    rows = [r for r, m in enumerate(fl[:ids.shape[0]]) if m]
    if not rows:
        return
    ii, dd = ids.tolist(), dest.tolist()
    if len(fl) == 3 and fl[2]:
        store[dd[0]] = store[dd[1]]
    if len(rows) == 2:
        d2 = row_dots(x, x[ii])
        store[dd[0]] = d2[0]
        store[dd[1]] = d2[1]
    else:
        r = rows[0]
        store[dd[r]] = row_dots(x, x[ii[r]])


def lib_fn():
    """csrc/cache_fill.cu's entry point, built at first use."""
    from dpsvm_tpu_torch.ops import _build

    fn = _build.load("cache_fill").dpsvm_cache_fill
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.restype = ctypes.c_int
        # x, store, ids, dest, flags; nq, n, d, bf16, vec, blocks; stream
        fn.argtypes = [ptr] * 5 + [i32, ctypes.c_longlong] + [i32] * 4 + [ptr]
    return fn


def _check(x, store, ids, dest, flags) -> torch.device:
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16) \
            or not x.is_contiguous():
        raise ValueError("x must be a contiguous (n, d) float32 or "
                         "bfloat16 tensor")
    if store.dim() != 2 or store.shape[1] != x.shape[0] \
            or store.dtype != torch.float32 or not store.is_contiguous():
        raise ValueError(f"store must be a contiguous (lines, {x.shape[0]}) "
                         "float32 tensor")
    k = ids.shape[0] if ids.dim() == 1 else 0
    if k not in (1, 2) or ids.dtype != torch.int64 \
            or dest.shape != ids.shape or dest.dtype != torch.int64 \
            or flags.shape != (2 * k - 1,) or flags.dtype != torch.bool:
        raise ValueError("ids and dest must be (1,) or (2,) int64, flags "
                         "(1,) or (3,) bool")
    for t in (store, ids, dest, flags):
        if t.device != dev:
            raise ValueError(f"every argument must lie on {dev}")
        if not t.is_contiguous():
            raise ValueError("ids, dest and flags must be contiguous")
    return dev


def cache_fill(x, store, ids, dest, flags) -> None:
    """Write the dot rows of the missed queries into their lines.

    x (n, d) float32 or bfloat16: the solve's X; store (lines, n)
    float32: the cache's lines (and its spare line); ids, dest (k,)
    int64, k = 1 or 2: each query's row of X and the line its row goes
    to (distinct where both miss); flags (2 k - 1,) bool: which queries
    miss, and for a pair the save flag. All on one device; nothing is
    read back to the host on the card."""
    dev = _check(x, store, ids, dest, flags)
    if dev.type == "cpu":
        _cache_fill(x, store, ids, dest, flags)
        return
    # fold_select imports solver/smo.py, which imports this module's
    # caller (solver/cache.py).
    from dpsvm_tpu_torch.ops.fold_select import raise_on

    plan = cache_fill_plan(x)
    raise_on(lib_fn()(
        x.data_ptr(), store.data_ptr(), ids.data_ptr(), dest.data_ptr(),
        flags.data_ptr(), ids.shape[0], x.shape[0], x.shape[1],
        int(x.dtype == torch.bfloat16), int(plan.vec), plan.blocks,
        torch.cuda.current_stream(dev).cuda_stream), "cache_fill")
    cache_fill.launches += 1


#: Kernel launches (CPU calls never count).
cache_fill.launches = 0
