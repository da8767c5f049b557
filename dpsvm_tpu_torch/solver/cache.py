"""LRU cache of kernel dot-product rows for the per-pair engines
(counterpart of dpsvm_tpu/solver/cache.py lookup_pair / lookup_one).

    data  (L, n) float32 on the solve's device -- cached DOT rows (the
                 kernel transform is recomputed per use, as in the JAX
                 package and the reference)
    keys  (L,)   int32 on the host             -- training row per line
                                                  (-1 empty)
    ticks (L,)   int32 on the host             -- last-use stamp;
                                                  eviction = argmin

The per-pair loop reads each trip's pair ids on the host anyway (one
small copy per trip), so keys and ticks live there and the host decides
hits and victims with the JAX package's rules; only the rows live on the
device. A hit reads its line and computes nothing; a double miss is one
(2, d) x (d, n) product, a single miss a (1, d) one. The lookups update
the state IN PLACE (lines are overwritten on the device, keys and ticks
on the host); a hit row comes back as a view of its line, valid until
the next lookup.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dpsvm_tpu_torch.ops.kernels import row_dots

_I32_MAX = np.iinfo(np.int32).max


@dataclasses.dataclass
class CacheState:
    data: torch.Tensor  # (L, n) float32
    keys: np.ndarray  # (L,) int32
    ticks: np.ndarray  # (L,) int32


def init_cache(lines: int, n: int, device) -> CacheState:
    """Empty lines carry the ordered negative ticks arange(L) - L, so they
    fill in slot order before any real eviction (real stamps are >= 1)."""
    return CacheState(
        data=torch.zeros((lines, n), dtype=torch.float32, device=device),
        keys=np.full((lines,), -1, np.int32),
        ticks=np.arange(lines, dtype=np.int32) - np.int32(lines))


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


def lookup_pair(cache: CacheState, x: torch.Tensor, i_hi: int, i_lo: int,
                it: int) -> tuple:
    """Dot rows of rows i_hi and i_lo of x, through the cache. Returns
    (row_hi, row_lo, n_hits)."""
    slots = _pair_slots(cache, i_hi, i_lo)
    row_hi, row_lo = _pair_fill(cache.data, x, x[i_hi], x[i_lo], slots)
    return row_hi, row_lo, _pair_stamp(cache, i_hi, i_lo, slots, it)


def lookup_pair_sharded(cache: CacheState, xs, i_hi: int, i_lo: int,
                        q_hi, q_lo, it: int) -> tuple:
    """lookup_pair over a row-sharded cache (the mesh's per-pair engine):
    cache.data is a list of (L, n_loc) lines, one per shard, keyed and
    stamped together (the JAX package's CacheState with data sharded
    along its columns); xs the shards of X and q_hi / q_lo the pair's
    query rows per shard, in X's dtype. Returns (rows_hi, rows_lo) per
    shard and the hits."""
    slots = _pair_slots(cache, i_hi, i_lo)
    rows = [_pair_fill(data, x, qh, ql, slots)
            for data, x, qh, ql in zip(cache.data, xs, q_hi, q_lo)]
    return ([r[0] for r in rows], [r[1] for r in rows],
            _pair_stamp(cache, i_hi, i_lo, slots, it))


def lookup_one(cache: CacheState, x: torch.Tensor, i: int,
               stamp: int) -> tuple:
    """The dot row of row i of x through the cache, stamped `stamp` (the
    second-order rule passes 2 it + 1, then 2 it + 2). Returns
    (row, hit)."""
    rows, hit = lookup_one_sharded(cache, [x], i, [x[i]], stamp, [cache.data])
    return rows[0], hit


def lookup_one_sharded(cache: CacheState, xs, i: int, qs, stamp: int,
                       datas=None) -> tuple:
    """lookup_one over a row-sharded cache (datas, default cache.data:
    one (L, n_loc) line block per shard, keyed together); qs the query
    row per shard. Returns (rows per shard, hit)."""
    datas = cache.data if datas is None else datas
    slot = _hit_slot(cache.keys, i)
    hit = slot is not None
    if not hit:
        slot = int(np.argmin(cache.ticks))
        for data, x, q in zip(datas, xs, qs):
            data[slot] = row_dots(x, q)
    cache.keys[slot] = i
    cache.ticks[slot] = stamp
    return [data[slot] for data in datas], hit


# ---------------------------------------------------------------------
# The block form (the out-of-core solver's, solver/ooc.py): the same
# lines probed and refreshed for a whole q-slot working set at once. An
# all-hit round reads its Gram block and fold rows from the device lines
# and streams no tile. Keys and ticks stay on the host, rows on the
# device.

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
