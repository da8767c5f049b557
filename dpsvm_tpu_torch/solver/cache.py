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


def lookup_pair(cache: CacheState, x: torch.Tensor, i_hi: int, i_lo: int,
                it: int) -> tuple:
    """Dot rows of rows i_hi and i_lo of x, through the cache. Returns
    (row_hi, row_lo, n_hits).

    The hi slot is its hit line or the least recently used one; the lo
    slot its hit line or the least recently used line other than the hi
    slot, so a double miss fills two distinct lines (one line can only
    hold lo's). Stamps are 2 it + 1 (hi) and 2 it + 2 (lo); where both
    land on one line, lo's write wins."""
    h_hi = _hit_slot(cache.keys, i_hi)
    h_lo = _hit_slot(cache.keys, i_lo)
    slot_hi = h_hi if h_hi is not None else int(np.argmin(cache.ticks))
    if h_lo is not None:
        slot_lo = h_lo
    else:
        masked = cache.ticks.copy()
        masked[slot_hi] = _I32_MAX
        slot_lo = int(np.argmin(masked))
    data = cache.data
    if h_hi is None and h_lo is None:
        d2 = row_dots(x, torch.stack([x[i_hi], x[i_lo]]))
        row_hi, row_lo = d2[0], d2[1]
    elif h_hi is None:
        row_hi, row_lo = row_dots(x, x[i_hi]), data[h_lo]
    elif h_lo is None:
        row_hi, row_lo = data[h_hi], row_dots(x, x[i_lo])
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
    cache.keys[slot_hi] = i_hi
    cache.keys[slot_lo] = i_lo
    stamp = 2 * it
    cache.ticks[slot_hi] = stamp + 1
    cache.ticks[slot_lo] = stamp + 2
    return row_hi, row_lo, int(h_hi is not None) + int(h_lo is not None)


def lookup_one(cache: CacheState, x: torch.Tensor, i: int,
               stamp: int) -> tuple:
    """The dot row of row i of x through the cache, stamped `stamp` (the
    second-order rule passes 2 it + 1, then 2 it + 2). Returns
    (row, hit)."""
    slot = _hit_slot(cache.keys, i)
    hit = slot is not None
    if not hit:
        slot = int(np.argmin(cache.ticks))
        cache.data[slot] = row_dots(x, x[i])
    cache.keys[slot] = i
    cache.ticks[slot] = stamp
    return cache.data[slot], hit


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
