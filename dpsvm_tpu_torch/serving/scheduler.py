"""Deadline-aware continuous batching: EDF queues per union group
(counterpart of dpsvm_tpu/serving/scheduler.py).

The v1 micro-batcher (serve.py enqueue/flush) merges whatever is queued
in arrival order and has no notion of time: under offered overload the
queue simply grows and every request gets uniformly late. This
scheduler makes lateness an explicit, per-request property:

* every request carries a DEADLINE (submit time + its deadline_ms, or
  +inf when deadlines are off) and batches form in EARLIEST-DEADLINE-
  FIRST order — the tightest requests ride the next dispatch;
* requests whose deadline has already passed at batch-forming time are
  SHED with an explicit ``expired`` verdict (counted per model) instead
  of occupying bucket rows that cannot help them — the backpressure
  that keeps an overloaded queue from growing without bound;
* requests are queued per UNION GROUP (registry.LoadedModel.group_key):
  models sharing one compacted union / kernel family coalesce into the
  SAME bucket dispatch — one kernel matmul answers all of them (the
  dispatch layer stacks their coefficient columns).

The scheduler is pure host bookkeeping (heapq + counters); device work
lives in :mod:`dpsvm_tpu_torch.serving.dispatch`.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
import threading
from typing import Optional

import numpy as np

from dpsvm_tpu_torch.serving.registry import LoadedModel


@dataclasses.dataclass
class Request:
    """One admitted request. ``entry`` is the LoadedModel resolved AT
    SUBMIT — the hot-swap routing point: this reference, not the name,
    decides which staged union answers the request, so in-flight work
    finishes on the version it was admitted against."""

    ticket: int
    entry: LoadedModel
    rows: np.ndarray  # caller's dtype kept (f64 stays exact on f64 cols)
    t_submit: float
    deadline: float  # absolute monotonic seconds; math.inf = none
    seq: int  # FIFO tiebreak among equal deadlines

    @property
    def n(self) -> int:
        return int(self.rows.shape[0])


class Scheduler:
    """Per-group EDF queues + global accounting.

    ``form(key, now, max_rows)`` pops the group's queue in deadline
    order, shedding expired requests, until the batch would exceed
    ``max_rows`` (a single oversized request forms alone — the
    dispatcher loops it over the top bucket, the v1 discipline).

    All mutation (submit and form) runs under one internal lock, so
    CONCURRENT SUBMIT from several threads is well-defined: seq
    numbers stay dense and FIFO-ordered per admission, queue_rows and
    the per-entry refcounts stay exact, and a scrape iterating the
    queues never races a heappush (Scheduler._q/_seq/queue_rows/
    _entry_refs are _lock's). form() is
    still driven by one pump at a time — the lock makes the
    ACCOUNTING safe, not two dispatchers per group sensible.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._q: dict = {}  # group key -> [(deadline, seq, Request)]
        self._seq = 0
        self.queue_rows = 0
        # Per-entry queued-request refcounts: pending_entries() sits on
        # the per-dispatch path (dispatch.py _group_for) and must stay
        # O(distinct entries), not O(queued requests) — a full queue
        # scan per dispatch is O(queue^2) host work under deep queues.
        # Maintained at submit and at every pop in form().
        self._entry_refs: dict = {}

    # ------------------------------------------------------------ admit
    def submit(self, entry: LoadedModel, rows: np.ndarray, now: float,
               deadline_s: Optional[float], ticket: int,
               dtype: str) -> Request:
        with self._lock:
            self._seq += 1
            req = Request(
                ticket=ticket, entry=entry, rows=rows, t_submit=now,
                deadline=(now + deadline_s if deadline_s is not None
                          else math.inf),
                seq=self._seq)
            key = entry.group_key(dtype)
            heapq.heappush(self._q.setdefault(key, []),
                           (req.deadline, req.seq, req))
            self.queue_rows += req.n
            self._entry_refs[entry] = \
                self._entry_refs.get(entry, 0) + 1
            return req

    # ------------------------------------------------------------ state
    @property
    def queue_depth(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._q.values())

    def depth_by_model(self) -> dict:
        """{model name: queued requests} — the exported queue-depth
        gauge's label set. Under the scheduler lock: a /metrics scrape
        thread or an admin thread preparing a hot swap reads this
        while serving threads submit."""
        out: dict = {}
        with self._lock:
            for q in self._q.values():
                for item in q:
                    name = item[2].entry.name
                    out[name] = out.get(name, 0) + 1
        return out

    def pending_entries(self) -> set:
        """Every LoadedModel with queued work — what keeps an old
        version's union group staged across a swap until it drains.
        O(distinct entries) via the maintained refcounts (this is on
        the per-dispatch path)."""
        with self._lock:
            return {e for e, c in self._entry_refs.items() if c > 0}

    def next_key(self):
        """The group whose head request has the earliest deadline (FIFO
        among equals) — the group the next dispatch should serve. None
        when idle."""
        best_key, best = None, None
        with self._lock:
            for key, q in self._q.items():
                if not q:
                    continue
                head = q[0][:2]
                if best is None or head < best:
                    best, best_key = head, key
        return best_key

    # ------------------------------------------------------------- form
    def form(self, key, now: float, max_rows: int):
        """(batch, expired): pop `key`'s queue in EDF order into a batch
        of at most `max_rows` total rows; requests already past their
        deadline are shed into `expired` (they never occupy bucket
        rows). The queue may drain entirely into one call."""
        with self._lock:
            return self._form_locked(key, now, max_rows)

    def _form_locked(self, key, now: float, max_rows: int):
        q = self._q.get(key, ())
        batch: list = []
        expired: list = []
        rows = 0
        while q:
            req = q[0][2]
            if req.deadline < now:
                heapq.heappop(q)
                self._drop_ref(req)
                expired.append(req)
                continue
            if batch and rows + req.n > max_rows:
                break
            heapq.heappop(q)
            self._drop_ref(req)
            batch.append(req)
            rows += req.n
            if rows >= max_rows:
                break
        if q == []:
            self._q.pop(key, None)
        return batch, expired

    def _drop_ref(self, req: Request) -> None:
        # caller holds self._lock (form's pop path)
        self.queue_rows -= req.n
        left = self._entry_refs.get(req.entry, 0) - 1
        if left > 0:
            self._entry_refs[req.entry] = left
        else:
            self._entry_refs.pop(req.entry, None)
