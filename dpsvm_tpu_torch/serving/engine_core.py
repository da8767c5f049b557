"""Engine core of the v2 serving engine: union staging, bucket dispatch
and the decision contraction (counterpart of
dpsvm_tpu/serving/engine_core.py), the device half of
serving/dispatch.py.

* :class:`UnionGroup` — the staged device operands of one coalescing
  family (registry.LoadedModel.group_key): ONE resident SV union and
  the member models' coefficient matrices stacked side by side into one
  (S, K_total) operand, so a bucket dispatch answers requests of every
  member with one kernel product (serve.py StagedUnion). With
  ``ServeConfig.num_devices > 1`` the union and the stacked coefficient
  rows shard over a mesh and the partial columns are summed.
* :class:`AsyncDispatcher` — at most one batch in flight: the next
  batch is formed and launched before the previous one is waited for,
  so host batch forming overlaps device work. On CUDA a launch returns
  once its work is queued on the engine's stream; waiting is the
  synchronize of the event recorded after the result's copy into pinned
  memory. An optional serial device-time floor
  (ServeConfig.device_floor_us_per_row) emulates a device-bound
  timeline on a host-bound harness.
* :func:`suggest_buckets` — the occupancy-driven bucket advice (host
  function; report-only unless a device profile arms the engine's
  between-legs auto-apply, dispatch.py maybe_apply_bucket_suggestion).
* :func:`_overwrite_f64` — the host float64 evaluation of risk-routed
  columns.

A CUDA device fault poisons the whole CUDA context, so "fail the batch
and serve on" holds for Python-level errors and
torch.cuda.OutOfMemoryError, not for a device-side fault (ROADMAP C).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from dpsvm_tpu_torch.obs.trace import span
from dpsvm_tpu_torch.serve import (Pending, StagedUnion, effective_buckets,
                                   union_nbytes)
from dpsvm_tpu_torch.serving.registry import LoadedModel
from dpsvm_tpu_torch.solver.reconstruct import gram_matvec_f64
from dpsvm_tpu_torch.testing import faults


class UnionGroup:
    """Staged device operands of one coalescing family.

    ``members`` is ordered; ``slices[entry]`` is the entry's column range
    in the stacked coefficient operand. Built off the request path (at
    registration or swap prepare, before the routing flip) and warmed,
    so later traffic uploads nothing.

    ``mesh`` is the engine's mesh (one shard, or ``config.num_devices``
    shards); ``mesh_devices`` its size. ``stream`` is the engine's CUDA
    stream (None on the CPU). ``buckets`` is the engine's current bucket
    ladder (dispatch.py ``_bucket_ladder``: the resolved ladder, or the
    one the auto-apply swapped in). ``storage`` is the RESOLVED union
    storage ('f32' | 'bf16' | 'int8'), part of the group key, so every
    member accepted it."""

    def __init__(self, key, members, buckets, mesh, stream, storage: str):
        self.key = key
        self.members = list(members)
        base = self.members[0].ens
        self.kp = base.kernel
        self.d = int(base.sv_union.shape[1])
        self.s_rows = int(base.sv_union.shape[0])
        self.buckets = effective_buckets(buckets, self.s_rows)
        self.mesh_devices = mesh.size
        self.union_storage = storage
        self.union_bytes = union_nbytes(storage, self.s_rows, self.d)
        self.slices: dict = {}
        lo = 0
        coefs, bs = [], []
        for m in self.members:
            self.slices[m] = slice(lo, lo + m.k)
            coefs.append(np.ascontiguousarray(m.ens.coef, np.float32))
            bs.append(np.ascontiguousarray(m.ens.b, np.float32))
            lo += m.k
        self.k_total = lo
        self.b_host = np.concatenate(bs)
        self._union = None  # an empty union decides exactly -b
        if self.s_rows:
            self._union = StagedUnion(base.sv_union, np.hstack(coefs),
                                      self.b_host, self.kp, storage, mesh,
                                      stream)

    def member_set(self) -> set:
        return set(self.members)

    def warm(self) -> None:
        """Run every bucket once on zero queries, so the first live
        request after a (re)stage allocates nothing new."""
        for bucket in self.buckets:
            self.dispatch(np.zeros((bucket, self.d), np.float32),
                          bucket).wait()

    def dispatch(self, qb: np.ndarray, bucket: int) -> Pending:
        """Launch one (bucket, d) padded batch -> its (bucket, K_total)
        decision columns, not yet waited for."""
        if self._union is None:
            return Pending(np.broadcast_to(
                -self.b_host, (qb.shape[0], self.k_total)).astype(
                np.float32))
        with span(f"serve/bucket{bucket}"):
            return self._union.launch(qb)


class AsyncDispatcher:
    """At most one in-flight batch; issuing the next waits for the
    previous. The issue-to-wait interval spans the NEXT batch's host
    forming (the overlap), so the cost recorded per dispatch is the
    time spent BLOCKED waiting (``wait_s``).

    Completed items are ``(meta, rows, wait_s, window_s, error)``;
    ``error`` is None on success, else a reason and ``rows`` is None:
    the engine fails that batch with explicit 'failed' verdicts and
    serves on. With ``timeout_s`` (ServeConfig.dispatch_timeout_ms) the
    wait runs on a watchdog thread, and a batch not done within the
    bound is failed the same way.

    ``floor_us_per_row`` imposes a SERIAL emulated device timeline: a
    dispatch completes no earlier than the previous one's emulated
    completion plus ``padded_rows * floor`` (a sleep)."""

    def __init__(self, timeout_s: Optional[float] = None,
                 floor_us_per_row: Optional[float] = None):
        self._inflight = None  # (Pending, meta, t_issue, padded rows)
        self._timeout = timeout_s
        self._floor = (None if floor_us_per_row is None
                       else floor_us_per_row / 1e6)
        self._dev_free_t = 0.0  # the emulated device's serial-free time

    @property
    def busy(self) -> bool:
        return self._inflight is not None

    def issue(self, group: UnionGroup, qb: np.ndarray, bucket: int,
              meta) -> list:
        """Launch this batch, then wait for the PREVIOUS one. Returns the
        completed items (0, 1, or 2 when this launch itself raises)."""
        prev = self._inflight
        try:
            # serve_dispatch fault seam (not in UnionGroup.dispatch:
            # warm-up launches never fault).
            if faults.arrive("serve_dispatch"):
                raise RuntimeError("injected fault at seam 'serve_dispatch'")
            pending = group.dispatch(qb, bucket)
        except Exception as e:
            self._inflight = None
            out = self._materialize(prev)
            out.append((meta, None, 0.0, 0.0,
                        f"dispatch raised {type(e).__name__}: {e}"))
            return out
        self._inflight = (pending, meta, time.perf_counter(), qb.shape[0])
        return self._materialize(prev)

    def drain(self) -> list:
        out = self._materialize(self._inflight)
        self._inflight = None
        return out

    def _materialize(self, item) -> list:
        if item is None:
            return []
        pending, meta, t_issue, padded_rows = item
        t0 = time.perf_counter()
        if self._timeout is None:
            try:
                rows, err = pending.wait(), None
            except Exception as e:
                rows, err = None, (f"materialization raised "
                                   f"{type(e).__name__}: {e}")
        else:
            # Bounded wait: the blocking wait runs on a daemon watchdog
            # thread. On timeout the batch is FAILED and the pump moves
            # on; the orphaned thread finishes (or never does) holding
            # nothing the engine needs. The serve_stall seam fires in
            # the waiting thread, modelling exactly that wedge.
            box: dict = {}

            def _pull():
                try:
                    faults.serve_stall()
                    box["rows"] = pending.wait()
                except Exception as e:  # pragma: no cover - rare path
                    box["err"] = (f"materialization raised "
                                  f"{type(e).__name__}: {e}")

            th = threading.Thread(target=_pull, daemon=True,
                                  name="dpsvm-dispatch-watchdog")
            th.start()
            th.join(self._timeout)
            if th.is_alive():
                rows, err = None, (
                    f"dispatch watchdog: batch not materialized within "
                    f"{self._timeout * 1e3:.0f} ms; failing the batch "
                    "and serving on")
            elif "err" in box:
                rows, err = None, box["err"]
            else:
                rows, err = box["rows"], None
        if self._floor is not None and err is None:
            done_t = (max(t_issue, self._dev_free_t)
                      + self._floor * padded_rows)
            self._dev_free_t = done_t
            now = time.perf_counter()
            if done_t > now:
                time.sleep(done_t - now)
        t1 = time.perf_counter()
        return [(meta, rows, t1 - t0, t1 - t_issue, err)]


def suggest_buckets(row_samples, current_buckets) -> dict:
    """Occupancy-driven ``ServeConfig.buckets`` advice (applied only by
    the engine's profile-gated auto-apply).

    `row_samples` are live rows per dispatch (the engine's batch_rows
    window); the suggestion is the ladder whose rungs sit at the next
    power of two above the traffic's p25 / p50 / p75 / p95 marks (the
    top bucket always kept), with the projected mean occupancy of both
    ladders. Host values only, no device work."""
    rows = np.asarray(list(row_samples), np.float64)
    rows = rows[rows > 0]
    current = tuple(int(b) for b in current_buckets)
    if rows.size == 0:
        return {"current_buckets": list(current),
                "suggested_buckets": None,
                "note": "no dispatches observed"}
    top = current[-1]

    def pow2_at_least(v):
        return 1 << max(0, int(np.ceil(np.log2(max(float(v), 1.0)))))

    marks = {f"p{q}": float(np.percentile(rows, q))
             for q in (25, 50, 75, 95)}
    ladder = sorted({min(pow2_at_least(v), top)
                     for v in marks.values()} | {top})

    def projected_occupancy(buckets):
        b = np.asarray(buckets, np.float64)
        idx = np.minimum(np.searchsorted(b, rows), len(b) - 1)
        return round(float(np.mean(rows / b[idx])), 4)

    return {
        "current_buckets": list(current),
        "suggested_buckets": [int(b) for b in ladder],
        "observed_rows": {**{k: round(v, 1) for k, v in marks.items()},
                          "max": int(rows.max()),
                          "dispatches": int(rows.size)},
        "projected_occupancy": {
            "current": projected_occupancy(current),
            "suggested": projected_occupancy(ladder)},
        "note": "report-only (no device profile decides it on this card)",
    }


def _overwrite_f64(entry: LoadedModel, q, dec: np.ndarray) -> None:
    """An entry's risk-routed columns exactly in float64 on the host;
    ``q`` is the caller's rows (float64 requests stay unquantized)."""
    q64 = np.asarray(q, np.float64)
    for j in entry.f64_cols:
        dec[:, j] = (gram_matvec_f64(entry.ens.sv_union,
                                     entry.ens.coef[:, j], entry.kp,
                                     queries=q64)
                     - float(entry.ens.b[j])).astype(np.float32)
