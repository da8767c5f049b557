"""Fill the missed lines of the per-pair engines' row cache (kernel
cache_fill; it replaces no TPU kernel).

The JAX package branches on the hit/miss case of a lookup inside its
compiled per-pair loop (dpsvm_tpu/solver/cache.py lookup_pair's
lax.switch, lookup_one's lax.cond). The port keeps the cache's keys and
ticks on the device (solver/cache.py), so the case is device data and
the host cannot branch on it without a read. ``cache_fill`` takes the
case as device tensors instead:

    for each query r with flags[r]:  store[dest[r]] = row_dots(x, q_r)

in place; a query that hit (or a masked trip's, whose flags are all off)
writes nothing. The query rows come in one of two forms. The id form,
the single-device engines' (solver/cache.py lookup_pair / lookup_one),
names rows of X: q_r = x[ids[r]]. The query form, the per-pair mesh
engine's (parallel/dist_smo.py through lookup_pair_mesh /
lookup_one_mesh), passes the rows themselves, q (k, d) in X's dtype: on
a row shard the pair's rows are not in the local X, and each shard
fills its own columns of the line. A pair's third flag, save, copies
line dest[1] to line dest[0] before the fill: query 0 hit the line query
1's row replaces (the one-line cache), and its row must survive in the
spare line. ``cache_fill`` launches the Hopper kernel of
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


def cache_fill_plan(x: torch.Tensor, q=None) -> CacheFillPlan:
    """The launch for X (n, d): one warp a row up to _MAX_BLOCKS blocks;
    16-byte loads when d values of X's type fill whole 16-byte words
    and X (and the query rows `q`, if given) start 16-byte aligned."""
    n, d = x.shape
    per = 16 // x.element_size()
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, q) if t is not None)
    return CacheFillPlan(min(-(-n // _WARPS), _MAX_BLOCKS),
                         d % per == 0 and aligned)


def _cache_fill(x, store, ids, dest, flags, q=None) -> None:
    """Plain PyTorch version of the kernel: same contract as
    cache_fill. It reads the flags on the host and computes the missed
    rows as the JAX package's branches do."""
    fl = flags.tolist()
    rows = [r for r, m in enumerate(fl[:dest.shape[0]]) if m]
    if not rows:
        return
    dd = dest.tolist()
    queries = q if q is not None else x[ids.tolist()]
    if len(fl) == 3 and fl[2]:
        store[dd[0]] = store[dd[1]]
    if len(rows) == 2:
        d2 = row_dots(x, queries)
        store[dd[0]] = d2[0]
        store[dd[1]] = d2[1]
    else:
        r = rows[0]
        store[dd[r]] = row_dots(x, queries[r])


def lib_fn():
    """csrc/cache_fill.cu's entry point, built at first use."""
    from dpsvm_tpu_torch.ops import _build

    fn = _build.load("cache_fill").dpsvm_cache_fill
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.restype = ctypes.c_int
        # x, q, store, ids, dest, flags; nq, n, d, bf16, vec, blocks;
        # stream
        fn.argtypes = [ptr] * 6 + [i32, ctypes.c_longlong] + [i32] * 4 + [ptr]
    return fn


def _check(x, store, ids, dest, flags, q) -> torch.device:
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
    k = dest.shape[0] if dest.dim() == 1 else 0
    if k not in (1, 2) or dest.dtype != torch.int64 \
            or flags.shape != (2 * k - 1,) or flags.dtype != torch.bool:
        raise ValueError("dest must be (1,) or (2,) int64, flags (1,) or "
                         "(3,) bool")
    if q is None:
        if ids is None or ids.shape != dest.shape \
                or ids.dtype != torch.int64:
            raise ValueError("ids must be dest's shape, int64 (or pass the "
                             "query rows q)")
    elif q.shape != (k, x.shape[1]) or q.dtype != x.dtype:
        raise ValueError(f"q must be ({k}, {x.shape[1]}) in x's dtype "
                         f"{x.dtype}")
    for t in (store, ids, dest, flags, q):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"every argument must lie on {dev}")
        if not t.is_contiguous():
            raise ValueError("ids, dest, flags and q must be contiguous")
    return dev


def cache_fill(x, store, ids, dest, flags, q=None) -> None:
    """Write the dot rows of the missed queries into their lines.

    x (n, d) float32 or bfloat16: the solve's X (a shard's on the
    mesh); store (lines, n) float32: the cache's lines (and its spare
    line); dest (k,) int64, k = 1 or 2: the line each query's row goes
    to (distinct where both miss); ids (k,) int64: each query's row of
    X (the id form), or None with q (k, d) in X's dtype: the query rows
    themselves (the query form); flags (2 k - 1,) bool: which queries
    miss, and for a pair the save flag. All on one device; nothing is
    read back to the host on the card."""
    dev = _check(x, store, ids, dest, flags, q)
    if dev.type == "cpu":
        _cache_fill(x, store, ids, dest, flags, q)
        return
    # fold_select imports solver/smo.py, which imports this module's
    # caller (solver/cache.py).
    from dpsvm_tpu_torch.ops.fold_select import raise_on

    plan = cache_fill_plan(x, q)
    raise_on(lib_fn()(
        x.data_ptr(), None if q is None else q.data_ptr(), store.data_ptr(),
        None if ids is None else ids.data_ptr(), dest.data_ptr(),
        flags.data_ptr(), dest.shape[0], x.shape[0], x.shape[1],
        int(x.dtype == torch.bfloat16), int(plan.vec), plan.blocks,
        torch.cuda.current_stream(dev).cuda_stream), "cache_fill")
    cache_fill.launches += 1


#: Kernel launches (CPU calls never count).
cache_fill.launches = 0
