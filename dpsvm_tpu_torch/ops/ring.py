"""The mesh block engines' ring exchange (counterpart of
dpsvm_tpu/ops/ring.py, kernels B7 and B8).

``ring_gather`` (B7)
    The candidate exchange of the global runner: every shard ends with
    all P (L, lanes) float32 blocks in rank-id slots of a (P, L, lanes)
    output, the layout and the bits of ``Mesh.all_gather``. On the TPU
    the blocks travel P - 1 leftward ring hops; on one card it is one
    ordinary launch that reads each block once and writes it into every
    rank's slot, split by ``gather_plan``.

``ring_fold_window`` (B8)
    The shard-local runner's sync: the (R q, d + 3) window
    [x row | x_sq | coef | pair-count lane] rides the same ring and each
    arriving window is folded into the shard's gradient inside the
    kernel, right neighbour first (``fold_window_peers`` is that fold in
    plain PyTorch, and the ``ring_exchange=False`` sync itself).

Both take one tensor per rank and launch csrc/ring.cu ONCE for all the
ranks (B8's blocks wait on each other's flags, so they must all be
running: one cooperative launch, its grid sized by an occupancy query).
For CPU tensors they run their plain versions; on CUDA tensors they
launch or raise. Ranks on several cards would need their pointers
peer-mapped: not run yet, so the wrappers refuse such a mesh.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from dpsvm_tpu_torch.ops.kernels import KernelParams, kernel_rows
from dpsvm_tpu_torch.solver.smo import maybe_kahan

_KINDS = {"rbf": 0, "linear": 1, "poly": 2, "sigmoid": 3}
_MAX_RANKS = 16  # csrc/ring.cu kMaxRanks
_MAX_FOLD_CHUNKS = 256  # csrc/ring.cu kFoldThreads
# B7's block: 128 threads of 4 units each (csrc/ring.cu kGatherUnroll, the
# 16-byte loads a thread keeps in flight), the best of the block shapes
# tried on the card at P = 2, 4, 8.
_GATHER_THREADS = 128
_GATHER_UNROLL = 4

# B8's flag words live across calls, per (device, stream, P, chunks):
# an int32 (P, slots, chunks) tensor, zero at first, and the sequence number
# of the last call that used it. A call's flags equal its sequence
# number, so no call resets them. Calls on one stream run in order;
# calls on two streams may overlap and so never share flag words.
_flags: dict = {}


def fold_window_peers(gathered, rank: int, x_loc, x_sq_loc, f, f_err,
                      kp: KernelParams):
    """Fold the OTHER ranks' windows of `gathered` (P, R q, d + 3) into
    rank `rank`'s gradient: one (R q, n_loc) kernel-row fold per peer in
    rotation order, right neighbour first. The own window was folded
    round by round and is skipped. Returns (f, f_err)."""
    p_dev = gathered.shape[0]
    d = x_loc.shape[1]
    for i in range(p_dev - 1):
        blk = gathered[(rank + 1 + i) % p_dev]
        delta = blk[:, d + 1] @ kernel_rows(
            x_loc, x_sq_loc, blk[:, :d].to(x_loc.dtype), blk[:, d], kp)
        f, f_err = maybe_kahan(f, f_err, delta)
    return f, f_err


def fold_window_peers_f64(gathered, rank: int, x_loc, x_sq_loc, f, f_err,
                          kp: KernelParams):
    """What fold_window_peers computes, carried in float64 from the same
    float32 inputs: f - f_err plus every peer's coef @ K(rows, x_loc), the
    window rows rounded to x_loc's storage type first. The yardstick that
    a float32 fold's rounding (the kernel's or the plain version's) is
    measured against. Feature kernels only. Returns one (n_loc,) float64
    tensor."""
    p_dev = gathered.shape[0]
    d = x_loc.shape[1]
    x64, xsq64 = x_loc.double(), x_sq_loc.double()
    total = f.double() if f_err is None else f.double() - f_err.double()
    for i in range(p_dev - 1):
        blk = gathered[(rank + 1 + i) % p_dev]
        v = blk[:, :d].to(x_loc.dtype).double() @ x64.t()
        if kp.kind == "rbf":
            sq = (xsq64 + blk[:, d].double()[:, None] - 2.0 * v).clamp(min=0.0)
            v = torch.exp(-kp.gamma * sq)
        elif kp.kind == "poly":
            v = (kp.gamma * v + kp.coef0) ** kp.degree
        elif kp.kind == "sigmoid":
            v = torch.tanh(kp.gamma * v + kp.coef0)
        elif kp.kind != "linear":
            raise ValueError(f"no dot-product form for kernel {kp.kind!r}")
        total = total + blk[:, d + 1].double() @ v
    return total


class GatherPlan(NamedTuple):
    """B7's launch: `chunks` blocks of `threads` for each rank's block, block
    x copying units [x per, min((x + 1) per, units)) of it into the same slot
    of every rank's output. A unit is 4 words when `vec` (16-byte copies),
    else 1 word."""
    threads: int
    per: int
    chunks: int
    vec: bool
    units: int


def gather_plan(count: int, aligned: bool) -> GatherPlan:
    """B7's split of a (count,)-word block per rank. `aligned`: every base
    pointer is 16-byte aligned, so 16-byte copies are safe where `count` is
    a multiple of 4 words."""
    vec = aligned and count % 4 == 0
    units = count // 4 if vec else count
    per = _GATHER_THREADS * _GATHER_UNROLL
    return GatherPlan(_GATHER_THREADS, per, -(-units // per), vec, units)


def ring_gather_plain(blocks) -> list:
    """Plain version of kernel B7: the stack, handed to every shard."""
    g = torch.stack(list(blocks))
    return [g] * len(blocks)


def ring_fold_window_plain(pends, xs, x_sqs, fs, f_errs, kp: KernelParams):
    """Plain version of kernel B8: stack, then fold_window_peers per rank.
    Returns (gathered per rank, f per rank, f_err per rank or None)."""
    p_dev = len(pends)
    g = torch.stack(list(pends))
    out = [fold_window_peers(g, r, xs[r], x_sqs[r], fs[r],
                             None if f_errs is None else f_errs[r], kp)
           for r in range(p_dev)]
    return ([g] * p_dev, [o[0] for o in out],
            None if f_errs is None else [o[1] for o in out])


def _lib() -> ctypes.CDLL:
    from dpsvm_tpu_torch.ops import _build

    so = _build.load("ring")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sigs = {
        "dpsvm_ring_max_blocks": [i32, ctypes.POINTER(i32)],
        # out, blk | P, count | threads, per, chunks, vec | stream
        "dpsvm_ring_gather": [ptr] * 2 + [i32, ctypes.c_long, i32,
                                          ctypes.c_long, i32, i32, ptr],
        # out, flags, pend, x, x_sq, f, err, f_out, err_out, conv
        "dpsvm_ring_fold_window": [ptr] * 10 + [i32] * 8
        + [ctypes.c_uint, i32, f32, f32, i32, ptr],
    }
    for name, argtypes in sigs.items():
        fn = getattr(so, name)
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
    return so


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _one_device(tensors, what: str) -> torch.device:
    """The single device all `tensors` lie on; raises for a mix."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        if all(d.type == "cuda" for d in devs):
            raise NotImplementedError(
                f"{what}: ranks on several cards need peer-mapped pointers "
                "(ROADMAP queue A item 10b); use ring_exchange=False there")
        raise ValueError(f"{what}: shards lie on {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _chunks(which: int, dev, p_dev: int, cap: int) -> int:
    """Blocks per rank of kernel `which` (csrc/ring.cu launch_of): all
    P x chunks blocks of the launch must run at once, so no more than the
    kernel's occupancy allows on `dev`. The cooperative launch refuses a
    grid that the context cannot hold at once. (The query is cached per
    kernel and device in csrc/common.cuh resident_blocks.)"""
    n = ctypes.c_int(0)
    with torch.cuda.device(dev):
        _raise_on(_lib().dpsvm_ring_max_blocks(which, ctypes.byref(n)),
                  "ring occupancy query")
    chunks = min(cap, n.value // p_dev)
    if chunks < 1:
        raise RuntimeError(f"{p_dev} ring ranks do not fit on {dev} at once "
                           f"({n.value} blocks)")
    return chunks


def _next_seq(dev, stream: int, p_dev: int, chunks: int, slots: int):
    key = (dev, stream, p_dev, chunks)
    if key not in _flags:
        _flags[key] = [torch.zeros((p_dev, slots, chunks), dtype=torch.int32,
                                   device=dev), 0]
    entry = _flags[key]
    entry[1] = entry[1] % (2 ** 32 - 1) + 1  # never 0, the flags' first state
    return entry


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(
        *(None if t is None else t.data_ptr() for t in tensors))


def _check_blocks(blocks, what: str):
    p_dev = len(blocks)
    if not 2 <= p_dev <= _MAX_RANKS:
        raise ValueError(f"{what} takes 2 <= P <= {_MAX_RANKS} shards, got "
                         f"{p_dev}")
    shape = blocks[0].shape
    for b in blocks:
        if (b.dim() != 2 or b.shape != shape or b.dtype != torch.float32
                or not b.is_contiguous()):
            raise ValueError(f"{what} takes one contiguous float32 "
                             f"{tuple(shape)} block per shard, got "
                             f"{tuple(b.shape)} {b.dtype}")
    return p_dev, shape


def ring_gather(blocks) -> list:
    """All-gather of one (L, lanes) float32 block per shard (kernel B7):
    one launch, split by ``gather_plan``. Returns, per rank, its own
    (P, L, lanes) copy of all P blocks in rank order: the layout and bits
    of ``torch.stack(blocks)``."""
    p_dev, (l, lanes) = _check_blocks(blocks, "ring_gather")
    dev = _one_device(blocks, "ring_gather")
    if dev.type == "cpu":
        return ring_gather_plain(blocks)
    out = torch.empty((p_dev, p_dev, l, lanes), dtype=torch.float32,
                      device=dev)
    outs = list(out)
    aligned = all(t.data_ptr() % 16 == 0 for t in (*outs, *blocks))
    plan = gather_plan(l * lanes, aligned)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        _raise_on(_lib().dpsvm_ring_gather(
            _ptrs(outs), _ptrs(blocks), p_dev, l * lanes, plan.threads,
            plan.per, plan.chunks, int(plan.vec), stream), "ring_gather")
    ring_gather.launches += 1
    return outs


def ring_fold_window(pends, xs, x_sqs, fs, f_errs, kp: KernelParams):
    """The shard-local sync as a ring (kernel B8): gather every shard's
    (R q, d + 3) window and fold each arriving one into the shard's
    gradient, right neighbour first.

    Per rank: pends[r] (R q, d + 3) float32; xs[r] (n_loc, d) float32 or
    bfloat16; x_sqs[r], fs[r] (n_loc,) float32; f_errs the Kahan
    residuals per rank, or None. Returns (gathered per rank
    (P, R q, d + 3), f' per rank, err' per rank or None)."""
    p_dev, (rq, lanes) = _check_blocks(pends, "ring_fold_window")
    compensated = f_errs is not None
    n_loc, d = xs[0].shape
    vecs = [*x_sqs, *fs, *(f_errs if compensated else ())]
    if lanes != d + 3 or not (len(xs) == len(x_sqs) == len(fs) == p_dev):
        raise ValueError(f"ring_fold_window takes (R q, {d + 3}) windows "
                         f"and one shard of X, x_sq and f per rank")
    for x in xs:
        if (x.shape != (n_loc, d) or x.dtype != xs[0].dtype
                or x.dtype not in (torch.float32, torch.bfloat16)
                or not x.is_contiguous()):
            raise ValueError("ring_fold_window takes contiguous float32 or "
                             f"bfloat16 ({n_loc}, {d}) shards of X")
    for v in vecs:
        if (v.shape != (n_loc,) or v.dtype != torch.float32
                or not v.is_contiguous()):
            raise ValueError(f"ring_fold_window takes contiguous float32 "
                             f"({n_loc},) vectors per shard")
    if kp.kind not in _KINDS:
        raise ValueError(f"ring_fold_window takes feature kernels only, got "
                         f"{kp.kind!r}")
    dev = _one_device([*pends, *xs, *vecs], "ring_fold_window")
    if dev.type == "cpu":
        return ring_fold_window_plain(pends, xs, x_sqs, fs, f_errs, kp)
    out = torch.empty((p_dev, p_dev, rq, lanes), dtype=torch.float32,
                      device=dev)
    f_out = [torch.empty_like(f) for f in fs]
    err_out = [torch.empty_like(f) for f in fs] if compensated else None
    x_bf16 = int(xs[0].dtype == torch.bfloat16)
    # Each arrived window in X's type, its rows padded to 16 bytes, where
    # the fold's tile loads take it from (one slot per peer, per rank).
    per16 = 16 // xs[0].element_size()
    dp = -(-d // per16) * per16
    conv = torch.empty((p_dev, p_dev, rq, dp), dtype=xs[0].dtype, device=dev)
    chunks = _chunks(1 + x_bf16, dev, p_dev, _MAX_FOLD_CHUNKS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # Slots [0, P) flag the ring's arrivals, [P, 2P) the converted windows.
    flags, seq = _next_seq(dev, stream, p_dev, chunks, 2 * p_dev)
    none = [None] * p_dev
    with torch.cuda.device(dev):
        _raise_on(_lib().dpsvm_ring_fold_window(
            _ptrs(list(out)), _ptrs(list(flags)), _ptrs(pends), _ptrs(xs),
            _ptrs(x_sqs), _ptrs(fs), _ptrs(f_errs if compensated else none),
            _ptrs(f_out), _ptrs(err_out if compensated else none),
            _ptrs(list(conv)), p_dev, rq, d, dp, n_loc, x_bf16,
            int(compensated), chunks, seq, _KINDS[kp.kind],
            float(kp.gamma), float(kp.coef0), int(kp.degree), stream),
            "ring_fold_window")
    ring_fold_window.launches += 1
    return list(out), f_out, err_out


#: Kernel launches (CPU calls never count).
ring_gather.launches = 0
ring_fold_window.launches = 0
