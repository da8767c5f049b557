"""LRU cache of kernel dot-product rows (counterpart of
dpsvm_tpu/solver/cache.py).

    data  (L, n) float32 -- cached DOT rows (the kernel transform is
                            recomputed per use, as in the JAX package and
                            the reference)
    keys  (L,)   int32   -- training row per line (-1 empty)
    ticks (L,)   int32   -- last-use stamp; eviction = argmin

Two forms share the state's shape.

The per-pair engines' cache (``init_cache``, ``lookup_pair``,
``lookup_one``) lives wholly on the solve's device, keys and ticks
included, as the JAX package's lives in its while_loop carry: the
per-pair loop queues many trips between host reads (solver/smo.py), so
no trip knows its pair ids, its hits or its victims on the host. The
lookups take 0-d device tensors and follow the JAX package's rules on
the device: the hit slot is the first matching key, the victim the
least recent tick, lo's victim found with hi's slot masked out, stamps
2 it + 1 and 2 it + 2 with lo's write winning where both land on one
line. The branch over the hit and miss cases is the kernel cache_fill
(ops/cache_fill.py): a missed row is computed into its line, a hit line
is only read. The lookups update the state in place, and an inactive
(masked) trip leaves data, keys and ticks bit for bit as they were. The
lines live in a store of L + 1 rows whose last row is a spare: where hi
misses and its victim is the line lo hits (or the cache has one line),
hi's row is computed there, since the line keeps lo's (or, hi hitting
the one line, saved there first).

The host-keyed form (``init_host_cache``: keys and ticks NumPy arrays)
serves the loops that read every step on the host anyway: the mesh
per-pair runner (parallel/dist_smo.py, through ``lookup_pair_sharded``
/ ``lookup_one_sharded``, data one (L, n_loc) block per shard) and the
out-of-core block cache (``probe_rows`` / ``refresh_rows``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from dpsvm_tpu_torch.ops.cache_fill import cache_fill
from dpsvm_tpu_torch.ops.kernels import row_dots

_I32_MAX = np.iinfo(np.int32).max


@dataclasses.dataclass
class CacheState:
    data: torch.Tensor  # (L, n) float32 (a list of shards on the mesh)
    keys: object  # (L,) int32: a device tensor, or a host array
    ticks: object  # (L,) int32, as keys
    store: Optional[torch.Tensor] = None  # (L + 1, n): data and a spare


def init_cache(lines: int, n: int, device) -> CacheState:
    """The per-pair engines' cache, all of it on `device`. Empty lines
    carry the ordered negative ticks arange(L) - L, so they fill in slot
    order before any real eviction (real stamps are >= 1)."""
    store = torch.zeros((lines + 1, n), dtype=torch.float32, device=device)
    return CacheState(
        data=store[:lines],
        keys=torch.full((lines,), -1, dtype=torch.int32, device=device),
        ticks=torch.arange(lines, dtype=torch.int32, device=device) - lines,
        store=store)


def init_host_cache(lines: int, n: int, device) -> CacheState:
    """The host-keyed cache: lines on `device`, keys and ticks on the
    host (ticks as init_cache's)."""
    return CacheState(
        data=torch.zeros((lines, n), dtype=torch.float32, device=device),
        keys=np.full((lines,), -1, np.int32),
        ticks=np.arange(lines, dtype=np.int32) - np.int32(lines))


def _stamp(vec: torch.Tensor, slot: torch.Tensor, value,
           active: torch.Tensor) -> None:
    """vec[slot] = value where the trip is active, in place on the
    device (slot (1,) int64, value a 0-d tensor)."""
    old = vec.index_select(0, slot)
    vec.index_copy_(0, slot, torch.where(active, value.to(vec.dtype), old))


def _first_or(match: torch.Tensor, fallback: torch.Tensor) -> tuple:
    """(hit, slot): whether a line matches, and the first matching
    line, else `fallback` (each a 0-d device tensor)."""
    hit = match.any()
    return hit, torch.where(hit, match.to(torch.uint8).argmax(), fallback)


def lookup_pair(cache: CacheState, x: torch.Tensor, i_hi: torch.Tensor,
                i_lo: torch.Tensor, it: torch.Tensor,
                active: torch.Tensor) -> tuple:
    """Dot rows of rows i_hi and i_lo of x through the cache, on the
    device (JAX lookup_pair). i_hi, i_lo and it are 0-d integer tensors,
    active a 0-d bool tensor (False: a masked trip, which changes
    nothing). Returns (rows (2, n) float32, n_hits 0-d int64): the rows
    are copies, valid after later lookups."""
    lines = cache.keys.shape[0]
    hit_hi, slot_hi = _first_or(cache.keys == i_hi, cache.ticks.argmin())
    masked = cache.ticks.index_fill(0, slot_hi.reshape(1), _I32_MAX)
    hit_lo, slot_lo = _first_or(cache.keys == i_lo, masked.argmin())
    # hi and lo land on one line where hi misses and its victim is the
    # line lo hits, or the cache has one line: the line keeps lo's row,
    # and hi's row goes to the spare line (computed, or on a one-line
    # hi hit saved there before lo's row replaces it).
    one = (slot_hi == slot_lo) & ~(hit_hi & hit_lo)
    dest = torch.stack([torch.where(one, lines, slot_hi), slot_lo])
    ids = torch.stack([i_hi, i_lo]).to(torch.int64)
    flags = torch.stack([~hit_hi, ~hit_lo, hit_hi & one]) & active
    cache_fill(x, cache.store, ids, dest, flags)
    rows = cache.store.index_select(0, dest)
    stamp = 2 * it
    for slot, i, t in ((slot_hi, i_hi, stamp + 1), (slot_lo, i_lo,
                                                    stamp + 2)):
        _stamp(cache.keys, slot.reshape(1), i, active)
        _stamp(cache.ticks, slot.reshape(1), t, active)
    n_hits = torch.where(active, hit_hi.long() + hit_lo.long(), 0)
    return rows, n_hits


def lookup_one(cache: CacheState, x: torch.Tensor, i: torch.Tensor,
               stamp: torch.Tensor, active: torch.Tensor) -> tuple:
    """The dot row of row i of x through the cache, stamped `stamp`
    (the second-order rule passes 2 it + 1, then 2 it + 2), on the
    device (JAX lookup_one). Returns (row (n,) float32, hit 0-d bool,
    False on a masked trip); the row is a copy."""
    hit, slot = _first_or(cache.keys == i, cache.ticks.argmin())
    slot1 = slot.reshape(1)
    cache_fill(x, cache.store, i.reshape(1).to(torch.int64), slot1,
               (~hit & active).reshape(1))
    row = cache.store.index_select(0, slot1)[0]
    _stamp(cache.keys, slot1, i, active)
    _stamp(cache.ticks, slot1, stamp, active)
    return row, hit & active


# ---------------------------------------------------------------------
# The host-keyed form: the mesh per-pair runner's, which reads each
# trip's pair ids on the host, so the host decides hits and victims with
# the same rules and only the rows live on the devices.

def _hit_slot(keys: np.ndarray, i: int):
    """The first line holding row i, or None."""
    hits = np.flatnonzero(keys == i)
    return int(hits[0]) if hits.size else None


def _pair_slots(cache: CacheState, i_hi: int, i_lo: int) -> tuple:
    """(h_hi, h_lo, slot_hi, slot_lo): each row's hit line (None on a
    miss) and the line it lands in. The hi slot is its hit line or the
    least recently used one; the lo slot its hit line or the least
    recently used line other than the hi slot, so a double miss fills two
    distinct lines (one line can only hold lo's)."""
    h_hi = _hit_slot(cache.keys, i_hi)
    h_lo = _hit_slot(cache.keys, i_lo)
    slot_hi = h_hi if h_hi is not None else int(np.argmin(cache.ticks))
    if h_lo is not None:
        slot_lo = h_lo
    else:
        masked = cache.ticks.copy()
        masked[slot_hi] = _I32_MAX
        slot_lo = int(np.argmin(masked))
    return h_hi, h_lo, slot_hi, slot_lo


def _pair_fill(data, x, q_hi, q_lo, slots) -> tuple:
    """The pair's dot rows against x for the query rows q_hi, q_lo, read
    from `data`'s hit lines or computed (one (2, d) x (d, n) product on a
    double miss), and the computed ones written to their lines."""
    h_hi, h_lo, slot_hi, slot_lo = slots
    if h_hi is None and h_lo is None:
        d2 = row_dots(x, torch.stack([q_hi, q_lo]))
        row_hi, row_lo = d2[0], d2[1]
    elif h_hi is None:
        row_hi, row_lo = row_dots(x, q_hi), data[h_lo]
    elif h_lo is None:
        row_hi, row_lo = data[h_hi], row_dots(x, q_lo)
        if slot_lo == slot_hi:  # one line: lo's row replaces the hi row
            row_hi = row_hi.clone()
    else:
        row_hi, row_lo = data[h_hi], data[h_lo]
    # JAX writes hi's row, then lo's, and a line keeps the last write; a
    # hit row already sits in its line.
    if h_hi is None and slot_hi != slot_lo:
        data[slot_hi] = row_hi
    if h_lo is None:
        data[slot_lo] = row_lo
    return row_hi, row_lo


def _pair_stamp(cache: CacheState, i_hi: int, i_lo: int, slots,
                it: int) -> int:
    """Key and stamp the pair's lines (2 it + 1 hi, 2 it + 2 lo; where
    both land on one line, lo's write wins). Returns the hits."""
    h_hi, h_lo, slot_hi, slot_lo = slots
    cache.keys[slot_hi] = i_hi
    cache.keys[slot_lo] = i_lo
    stamp = 2 * it
    cache.ticks[slot_hi] = stamp + 1
    cache.ticks[slot_lo] = stamp + 2
    return int(h_hi is not None) + int(h_lo is not None)


def lookup_pair_sharded(cache: CacheState, xs, i_hi: int, i_lo: int,
                        q_hi, q_lo, it: int) -> tuple:
    """lookup_pair over a host-keyed, row-sharded cache (the mesh's
    per-pair engine): cache.data is a list of (L, n_loc) lines, one per
    shard, keyed and stamped together (the JAX package's CacheState with
    data sharded along its columns); xs the shards of X and q_hi / q_lo
    the pair's query rows per shard, in X's dtype; the ids host ints.
    Returns (rows_hi, rows_lo) per shard and the hits."""
    slots = _pair_slots(cache, i_hi, i_lo)
    rows = [_pair_fill(data, x, qh, ql, slots)
            for data, x, qh, ql in zip(cache.data, xs, q_hi, q_lo)]
    return ([r[0] for r in rows], [r[1] for r in rows],
            _pair_stamp(cache, i_hi, i_lo, slots, it))


def lookup_one_sharded(cache: CacheState, xs, i: int, qs,
                       stamp: int) -> tuple:
    """lookup_one over a host-keyed, row-sharded cache (one (L, n_loc)
    line block per shard, keyed together); qs the query row per shard.
    Returns (rows per shard, hit)."""
    slot = _hit_slot(cache.keys, i)
    hit = slot is not None
    if not hit:
        slot = int(np.argmin(cache.ticks))
        for data, x, q in zip(cache.data, xs, qs):
            data[slot] = row_dots(x, q)
    cache.keys[slot] = i
    cache.ticks[slot] = stamp
    return [data[slot] for data in cache.data], hit


# ---------------------------------------------------------------------
# The block form (the out-of-core solver's, solver/ooc.py): the same
# lines probed and refreshed for a whole q-slot working set at once. An
# all-hit round reads its Gram block and fold rows from the device lines
# and streams no tile. Keys and ticks stay on the host
# (init_host_cache), rows on the device.

def probe_rows(keys: np.ndarray, w: np.ndarray, slot_ok: np.ndarray):
    """Which working-set slots hold a cached row: (hit (q,) bool,
    hit_slot (q,) int32, junk where ~hit). keys (L,), w (q,) and slot_ok
    (q,) are host arrays; dead slots never hit."""
    hit_mat = keys[None, :] == np.asarray(w)[:, None]  # (q, L)
    hit = hit_mat.any(axis=1) & np.asarray(slot_ok, bool)
    return hit, hit_mat.argmax(axis=1).astype(np.int32)


def refresh_rows(cache: CacheState, w: np.ndarray, slot_ok: np.ndarray,
                 rows: torch.Tensor, stamp: int) -> tuple:
    """Write a round's freshly streamed dot rows into the lines, in place
    (the JAX package's scatter refresh): a hit rewrites its own line,
    each live miss takes one of the q least recently used lines (ticks
    ascending, ties to the lower line; lines a hit refreshes are never
    victims), and every written line is stamped `stamp`. Needs L >= q
    (SVMConfig validates ooc_cache_lines). rows (q, n) on the device;
    dead slots write nothing. Returns (n_hits, n_evictions): an eviction
    is a live miss landing on a line that held a real key."""
    w = np.asarray(w)
    slot_ok = np.asarray(slot_ok, bool)
    q = w.shape[0]
    hit, hit_slot = probe_rows(cache.keys, w, slot_ok)
    ticks_m = cache.ticks.copy()
    ticks_m[hit_slot[hit]] = _I32_MAX
    victims = np.argsort(ticks_m, kind="stable")[:q]
    miss = slot_ok & ~hit
    miss_rank = np.cumsum(miss) - 1
    slot = np.where(hit, hit_slot,
                    victims[np.clip(miss_rank, 0, q - 1)]).astype(np.int64)
    n_evict = int(np.sum(miss & (cache.keys[slot] >= 0)))
    live = np.flatnonzero(slot_ok)
    lines = slot[live]
    cache.data[torch.as_tensor(lines, device=cache.data.device)] = rows[
        torch.as_tensor(live, device=rows.device)]
    cache.keys[lines] = w[live]
    cache.ticks[lines] = stamp
    return int(hit.sum()), n_evict
