"""Engine host of the v2 serving engine (counterpart of
dpsvm_tpu/serving/dispatch.py): the ServingEngine — registry, scheduler
and dispatcher behind a submit / pump / drain API, with always-on
instruments (queue depth, deadline misses, hot swaps, batch occupancy)
and the /metrics endpoint.

The device half (:class:`UnionGroup`, :class:`AsyncDispatcher`,
:func:`suggest_buckets`, :func:`_overwrite_f64`) lives in
serving/engine_core.py and is re-exported here. Engine core scales down
into the mesh (ServeConfig.num_devices), engine host out into the
replica fleet (serving/replicas.py)."""

from __future__ import annotations

import dataclasses
import threading
import time
import weakref
from typing import Optional

import numpy as np

from dpsvm_tpu_torch.autotune.profile import device_kind_of
from dpsvm_tpu_torch.config import ServeConfig
from dpsvm_tpu_torch.device import resolve_device
from dpsvm_tpu_torch.obs import run_obs
from dpsvm_tpu_torch.obs import export as openmetrics
from dpsvm_tpu_torch.obs.metrics import Registry
from dpsvm_tpu_torch.serve import (new_stream, resolve_buckets,
                                   resolve_union_storage, serve_mesh,
                                   union_nbytes)
from dpsvm_tpu_torch.serving.engine_core import (  # noqa: F401
    AsyncDispatcher, UnionGroup, _overwrite_f64, suggest_buckets)
from dpsvm_tpu_torch.serving.registry import (LoadedModel, ModelRegistry,
                                              RegistryJournal)
from dpsvm_tpu_torch.serving.scheduler import Request, Scheduler


@dataclasses.dataclass
class ServeResult:
    """One completed request. ``verdict``:
      "ok"      — served, completed within its deadline (or none set);
      "late"    — served, but completed PAST its deadline: the decision
                  rows are real, and the request counts as a deadline
                  miss (admitted-past-deadline work is counted, never
                  silently served late);
      "expired" — shed at batch-forming time (deadline already passed
                  before any device work): no decision rows, counted.
      "failed"  — the batch's device dispatch raised or tripped the
                  dispatch watchdog (ServeConfig.dispatch_timeout_ms):
                  no decision rows, counted per model
                  (serve_dispatch_failures); the engine keeps serving
                  subsequent batches — an explicit verdict, never a
                  hung pump thread.

    ``entry`` is the LoadedModel THAT SERVED the request (the version
    resolved at submit) — label folding must use it, not a fresh
    registry lookup: after a hot swap the live entry may have a
    different class set/strategy than the one whose columns these are.
    """

    ticket: int
    model: str
    version: int
    decision: Optional[np.ndarray]
    verdict: str
    latency_s: float
    entry: object = dataclasses.field(default=None, repr=False)

    def labels(self) -> Optional[np.ndarray]:
        """Predicted labels via the SERVING version's fold (None for
        expired requests)."""
        if self.decision is None:
            return None
        return self.entry.labels(self.decision)

    @property
    def ok(self) -> bool:
        return self.verdict == "ok"

    @property
    def deadline_missed(self) -> bool:
        return self.verdict in ("late", "expired")

    @property
    def failed(self) -> bool:
        return self.verdict == "failed"


class ServingEngine:
    """Multi-model serving engine v2: model registry with zero-downtime
    hot swap, deadline-aware continuous batching, async dispatch.

    Request path: ``submit(rows, model=..., deadline_ms=...) ->
    ticket``; ``pump()`` runs one scheduling step (form the earliest-
    deadline batch, dispatch it async, complete whatever finished);
    ``drain()`` pumps until idle and returns every completed
    {ticket: ServeResult}; ``results()`` pops completions without
    blocking. With ``config.num_devices > 1`` the union groups stage
    mesh-sharded (logical shards of `device` when one is named, else
    the first cards); ``replica`` is the engine's index inside a
    serving/replicas.py ReplicaFleet, None for a standalone engine.
    The engine runs on `device` (None: the CUDA card) and owns one CUDA
    stream there; nothing on its dispatch path synchronizes the whole
    device."""

    def __init__(self, config: ServeConfig = ServeConfig(),
                 replica: Optional[int] = None, device=None):
        config.check_ported()
        self.config = config
        self.replica = None if replica is None else int(replica)
        self.device = resolve_device(device)
        self.mesh = serve_mesh(config.num_devices, self.device,
                               device is not None)
        self.stream = new_stream(self.device)
        # Bucket ladder: explicit config wins; buckets=None consults the
        # device profile's serve_buckets decision (the ladder starts at
        # the default; an authoritative pays verdict arms the
        # between-legs auto-apply, maybe_apply_bucket_suggestion).
        ladder, self.bucket_provenance = resolve_buckets(
            config, device_kind_of(self.device))
        self._bucket_ladder = tuple(ladder)
        self.scheduler = Scheduler()
        self.registry = ModelRegistry(prepare=self._prepare_entry,
                                      on_swap=self._on_swap)
        self._groups: dict = {}
        self._dispatcher = AsyncDispatcher(
            timeout_s=(None if config.dispatch_timeout_ms is None
                       else config.dispatch_timeout_ms / 1e3),
            floor_us_per_row=config.device_floor_us_per_row)
        self._done: dict = {}
        self._next_ticket = 0
        self._dispatches = 0
        self._rows_total = 0
        self._closing = False
        self._closed = False
        # Lifecycle lock: drain() and close()
        # serialize on it, so close() during an active drain() waits
        # for the drain to finish and then tears down exactly once —
        # double-shutdown is idempotent from any interleaving, and a
        # scrape during a drain reads live instruments (never torn:
        # only close() flips _closing, under this lock). RLock because
        # close() itself drains.
        self._lifecycle = threading.RLock()
        # The attached network front door (serving/server.py), if any:
        # its counters join snapshot() and the /metrics exposition so
        # one scrape carries one truth.
        self._front = None

        # Always-on instruments: one Registry per engine; percentiles
        # everywhere come from THESE histograms, so snapshot() and
        # /metrics cannot disagree.
        self.metrics = Registry()
        self.request_seconds = self.metrics.histogram(
            "serve.request_seconds")
        self.dispatch_seconds = self.metrics.histogram(
            "serve.dispatch_seconds")
        self.batch_occupancy = self.metrics.histogram(
            "serve.batch_occupancy")
        # Absolute live rows per dispatch (the occupancy histogram's
        # numerator): what the report-only bucket_suggestion() reads.
        self.batch_rows = self.metrics.histogram("serve.batch_rows")
        self.deadline_misses = self.metrics.counter(
            "serve.deadline_misses_total")
        self.expired = self.metrics.counter("serve.expired_total")
        self.hot_swaps = self.metrics.counter("serve.hot_swaps_total")
        self.coalesced = self.metrics.counter(
            "serve.coalesced_dispatches_total")
        # Executors built while serving: none in eager torch (reads 0).
        self.compiles = self.metrics.counter("serve.compiles_total")
        self.dispatch_failures = self.metrics.counter(
            "serve.dispatch_failures_total")
        self.watchdog_trips = self.metrics.counter(
            "serve.watchdog_trips_total")
        self._per_model: dict = {}

        self._prep_lock = threading.Lock()
        self._preparing = 0  # in-flight swap preparations (admin thread)
        # The run log (NULL_OBS unless config.obs / DPSVM_OBS): manifest
        # now, events as they happen, the snapshot at close().
        self._obs = run_obs(
            "serve", config, device=self.device,
            meta={"engine": "serving_v2",
                  "buckets": list(self._bucket_ladder),
                  "bucket_source": self.bucket_provenance["source"],
                  "dtype": config.dtype,
                  "union_storage": config.effective_union_storage(),
                  "deadline_ms": config.deadline_ms,
                  **({"replica": self.replica}
                     if self.replica is not None else {})})

        # The render callback holds the engine weakly: the exporter's
        # daemon thread must not pin an un-closed engine.
        self.exporter = None
        if config.metrics_port is not None:
            def _render(_ref=weakref.ref(self)):
                eng = _ref()
                if eng is None or eng._closing:
                    # A scrape racing close(): the minimal valid
                    # exposition, never a half-torn-down read.
                    return "# EOF\n"
                return eng.render_openmetrics()

            self.exporter = openmetrics.MetricsExporter(
                _render, port=config.metrics_port,
                host=config.metrics_host)

        # Crash recovery: replay the registry journal, then
        # attach it. Replay runs BEFORE attach so a crash mid-replay
        # can never rewrite the durable record with a partial subset;
        # each journaled model re-registers through the normal
        # validate-stage-warm path at its exact pre-crash version, so
        # the rehydrated engine serves decisions identical to the one
        # that died. A missing/corrupt journaled model file fails
        # construction LOUDLY (ModelLoadError) — silently coming up
        # with a hole in the model set is the failure mode the journal
        # exists to prevent.
        self.journal = None
        self._rehydrated: list = []
        if config.journal_path:
            try:
                journal = RegistryJournal(config.journal_path)
                entries = journal.load()
                for name in sorted(entries):
                    rec = entries[name]
                    self.registry.restore(name, rec["source"],
                                          int(rec["version"]))
                    self._model_metrics(name)
                    self._rehydrated.append(name)
                if self._rehydrated:
                    self._obs.event(
                        "rehydrate", models=list(self._rehydrated),
                        versions={n: int(entries[n]["version"])
                                  for n in self._rehydrated})
                self.registry.attach_journal(journal)
                self.journal = journal
            except BaseException:
                # Failed construction: close() is unreachable on a
                # half-built engine, so stop the exporter here (a leaked
                # one keeps the metrics port bound) and close the run
                # log.
                self._closing = True
                if self.exporter is not None:
                    self.exporter.close()
                self._obs.finish(aborted=True)
                raise

    # ------------------------------------------------------ registration
    def _storage_of(self, entry: LoadedModel) -> str:
        """The entry's RESOLVED union storage: the config's
        requested storage adjudicated per model by the shared guard
        (serve.resolve_union_storage — a refused int8 request falls
        back loudly; auto picks the narrowest accepted storage).
        Resolved ONCE per entry and cached on it: the token is part of
        the entry's group key, so two models whose guard verdicts
        differ stage in DIFFERENT groups and a hot swap between
        storage dtypes restages correctly."""
        st = getattr(entry, "union_storage", None)
        if st is None:
            st, guard = resolve_union_storage(
                entry.ens, entry.kp,
                self.config.effective_union_storage(), stacklevel=7)
            entry.union_storage = st
            entry.storage_guard = guard
            if guard.get("note"):
                self._obs.event("storage_guard", model=entry.name,
                                version=entry.version, **guard)
        return st

    def _members_for(self, key, extra=None) -> list:
        """Current membership of a union group: live registry entries
        plus entries still holding queued work (an old version keeps
        its columns staged across a swap until its queue drains), plus
        the incoming entry when preparing a swap."""
        seen: list = []
        for e in self.registry.entries():
            if e.group_key(self._storage_of(e)) == key \
                    and e not in seen:
                seen.append(e)
        for e in self.scheduler.pending_entries():
            if e.group_key(self._storage_of(e)) == key \
                    and e not in seen:
                seen.append(e)
        if extra is not None and extra not in seen:
            seen.append(extra)
        return seen

    def _prepare_entry(self, entry: LoadedModel) -> None:
        """Registry prepare hook: stage + warm the incoming version's
        union group BEFORE the routing pointer flips — the
        zero-downtime half of the hot-swap contract. Storage
        resolution (_storage_of) runs the quality guard here: a
        refused narrow storage warns during registration, off the
        request path."""
        storage = self._storage_of(entry)
        with self._prep_lock:
            self._preparing += 1  # parks _gc_groups: the GC must not
        try:                      # shrink away a group being prepared
            key = entry.group_key(storage)
            group = UnionGroup(key,
                               self._members_for(key, extra=entry),
                               self._bucket_ladder, self.mesh,
                               self.stream, storage)
            group.warm()
            # Publish the staged group. In-flight dispatches captured
            # their group object; queued requests of existing members
            # route here (a superset staging — their column slices are
            # present).
            self._groups[key] = group
        finally:
            with self._prep_lock:
                self._preparing -= 1

    def _on_swap(self, prev: LoadedModel, new: LoadedModel) -> None:
        self.hot_swaps.add(1)
        self._model_metrics(new.name)["swaps"].add(1)
        self._obs.event("hot_swap", model=new.name,
                        from_version=prev.version, to_version=new.version,
                        union_changed=prev.union_fp != new.union_fp)

    def register(self, name: str, source) -> LoadedModel:
        entry = self.registry.register(name, source)
        self._obs.event("register", model=name, version=entry.version,
                        k=entry.k, d=entry.d, n_union=int(entry.ens.n_union))
        self._model_metrics(name)  # instruments exist before traffic
        return entry

    def swap(self, name: str, source) -> LoadedModel:
        return self.registry.swap(name, source)

    def unregister(self, name: str) -> LoadedModel:
        return self.registry.unregister(name)

    # ----------------------------------------------------------- metrics
    def _model_metrics(self, name: str) -> dict:
        m = self._per_model.get(name)
        if m is None:
            m = {
                "requests": self.metrics.counter(
                    f"serve.requests.{name}"),
                "rows": self.metrics.counter(f"serve.rows.{name}"),
                "misses": self.metrics.counter(
                    f"serve.deadline_misses.{name}"),
                "expired": self.metrics.counter(
                    f"serve.expired.{name}"),
                "swaps": self.metrics.counter(f"serve.swaps.{name}"),
                "failures": self.metrics.counter(
                    f"serve.dispatch_failures.{name}"),
                "latency": self.metrics.histogram(
                    f"serve.request_seconds.{name}"),
            }
            self._per_model[name] = m
        return m

    # ------------------------------------------------------------ submit
    _DEADLINE_DEFAULT = object()  # sentinel: "use the config default"

    def submit(self, rows, model: Optional[str] = None,
               deadline_ms=_DEADLINE_DEFAULT) -> int:
        """Admit one request. ``model`` may be omitted when exactly one
        model is registered. ``deadline_ms``: omitted = the config
        default; an explicit number overrides it; an explicit ``None``
        means NO deadline for this request even when the config sets
        one (the synchronous decision()/predict() conveniences use
        this — they must never have their answer shed). Returns the
        ticket whose ServeResult a later pump/drain completes.
        Crossing ``max_pending`` queued rows forces scheduling steps
        until the queue is back under the bound (backpressure)."""
        entry = self.registry.get(model)
        q = np.asarray(rows)
        if q.ndim != 2 or q.shape[1] != entry.d:
            raise ValueError(
                f"queries for model {entry.name!r} must be "
                f"(n, {entry.d}); got {q.shape}")
        if deadline_ms is self._DEADLINE_DEFAULT:
            deadline_ms = self.config.deadline_ms
        now = time.perf_counter()
        ticket = self._next_ticket
        self._next_ticket += 1
        self.scheduler.submit(
            entry, q, now,
            None if deadline_ms is None else deadline_ms / 1e3,
            ticket, self._storage_of(entry))
        mm = self._model_metrics(entry.name)
        mm["requests"].add(1)
        mm["rows"].add(q.shape[0])
        while self.scheduler.queue_rows >= self.config.max_pending:
            self.pump()
        return ticket

    # -------------------------------------------------------- scheduling
    def pump(self) -> int:
        """One scheduling step: form the earliest-deadline group's next
        batch (shedding expired requests), dispatch it asynchronously,
        and complete whatever previous dispatch finished. Returns the
        number of requests completed by this call; results accumulate
        for :meth:`results`/:meth:`drain`."""
        completed = 0
        now = time.perf_counter()
        key = self.scheduler.next_key()
        if key is None:
            for item in self._dispatcher.drain():
                completed += self._complete_batch(item)
            # Idle moment: retire drained-out union groups here too —
            # a pump()/results()-driven server under sustained traffic
            # may never call drain(), and staged unions must not
            # accumulate across hot swaps.
            if not self._dispatcher.busy:
                self._gc_groups()
            return completed
        group = self._group_for(key)
        batch, expired = self.scheduler.form(key, now,
                                             group.buckets[-1])
        for req in expired:
            self._finish_expired(req)
            completed += 1
        if batch:
            completed += self._dispatch_batch(group, batch)
        elif not self.scheduler.queue_depth:
            for item in self._dispatcher.drain():
                completed += self._complete_batch(item)
        return completed

    def drain(self) -> dict:
        """Pump until every queued request and in-flight batch is
        complete; returns (and pops) all completed results. Serialized
        against close() on the lifecycle lock: a close() racing an
        active drain waits for it, and a drain() after close is a
        no-op returning whatever already completed — double-shutdown
        from any interleaving is idempotent."""
        with self._lifecycle:
            if self._closed:
                return self.results()
            while self.scheduler.queue_depth or self._dispatcher.busy:
                self.pump()
            self._gc_groups()
            # Between-legs idle moment: the only place the profile-gated
            # bucket auto-apply may swap the ladder (queues are empty,
            # nothing staged is mid-flight).
            self.maybe_apply_bucket_suggestion()
            return self.results()

    def results(self) -> dict:
        """Pop everything completed so far: {ticket: ServeResult}."""
        done = self._done
        self._done = {}
        return done

    def _group_for(self, key) -> UnionGroup:
        """The staged group for a key — normally staged by the prepare
        hook; restaged here only if a queued request's entry is not in
        the staged member set (possible after an unregister), or if
        the bucket ladder changed under the auto-apply."""
        group = self._groups.get(key)
        needed = {e for e in self.scheduler.pending_entries()
                  if e.group_key(self._storage_of(e)) == key}
        if group is None or not needed <= group.member_set():
            group = UnionGroup(key, self._members_for(key),
                               self._bucket_ladder, self.mesh,
                               self.stream, key[-1])
            group.warm()
            self._groups[key] = group
        return group

    def _gc_groups(self) -> None:
        """Idle-time retirement (queues are empty here): drop groups
        with no live member, and restage groups still carrying a
        drained old version's columns — staged unions must not
        accumulate across many swaps. No-op while an admin thread is
        preparing a swap (its superset group must not be shrunk from
        under it before the routing flip)."""
        with self._prep_lock:
            if self._preparing:
                return
        live_keys: dict = {}
        for e in self.registry.entries():
            live_keys.setdefault(
                e.group_key(self._storage_of(e)), []).append(e)
        for key in list(self._groups):
            members = live_keys.get(key)
            if members is None:
                del self._groups[key]
            elif set(members) != self._groups[key].member_set():
                group = UnionGroup(key, members, self._bucket_ladder,
                                   self.mesh, self.stream, key[-1])
                group.warm()
                self._groups[key] = group

    # ---------------------------------------------------------- dispatch
    def _dispatch_batch(self, group: UnionGroup, batch) -> int:
        """Merge an EDF-formed batch into one padded bucket dispatch
        (a single oversized request loops over the top bucket — the v1
        discipline). Completion of the PREVIOUS in-flight batch happens
        inside issue(), after this batch's async dispatch."""
        rows = sum(r.n for r in batch)
        merged = np.concatenate(
            [np.asarray(r.rows, np.float32) for r in batch])
        top = group.buckets[-1]
        completed = 0
        if rows <= top:
            bucket = next(b for b in group.buckets if rows <= b)
            qb = merged
            if rows != bucket:
                qb = np.zeros((bucket, group.d), np.float32)
                qb[:rows] = merged
            completed += self._issue(group, qb, bucket, batch, rows,
                                     chain=None, final=True)
        else:
            # One oversized request (form() guarantees multi-request
            # batches fit the top bucket): loop the top bucket,
            # assembling segments into one output before completion.
            # The chain dict carries the segment parts AND the dead
            # flag a failed segment sets, so one failed dispatch fails
            # the whole request exactly once — later segments of a
            # dead chain complete as no-ops.
            chain = {"parts": [], "total": rows, "dead": False}
            s = 0
            while s < rows:
                if chain["dead"]:
                    # An already-completed segment failed the chain
                    # (raise or watchdog): the request is already
                    # 'failed' — dispatching the remaining segments
                    # would be pure wasted device work.
                    break
                take = min(rows - s, top)
                qb = merged[s:s + take]
                if take != top:
                    qp = np.zeros((top, group.d), np.float32)
                    qp[:take] = qb
                    qb = qp
                completed += self._issue(
                    group, qb, top, batch, take,
                    chain=chain, final=s + take >= rows)
                s += take
        return completed

    def _issue(self, group, qb, bucket, batch, used_rows,
               chain, final) -> int:
        # Counters advance BEFORE the dispatch and ride the meta as a
        # snapshot: the chunk record for THIS batch must carry ITS OWN
        # cumulative (pairs, dispatch) — the completion callback fires
        # one batch later (double buffer), when the live counters
        # already describe the next batch.
        self._dispatches += 1
        self._rows_total += used_rows
        meta = (group, batch, used_rows, chain, final,
                self._rows_total, self._dispatches)
        items = self._dispatcher.issue(group, qb, bucket, meta)
        self.batch_occupancy.observe(used_rows / bucket)
        self.batch_rows.observe(used_rows)
        if final and len({r.entry.name for r in batch}) > 1:
            self.coalesced.add(1)
        completed = 0
        for item in items:
            completed += self._complete_batch(item)
        return completed

    def _complete_batch(self, item) -> int:
        (group, batch, used_rows, chain, final, rows_cum,
         dispatch_no), out, wait_s, window_s, err = item
        self.dispatch_seconds.observe(wait_s)
        if self._obs.live:
            self._obs.chunk(pairs=rows_cum, b_hi=0.0, b_lo=0.0,
                            device_seconds=wait_s, dispatch=dispatch_no,
                            rows=int(used_rows),
                            window_seconds=round(window_s, 6),
                            **({"failed": True} if err is not None else {}))
        if err is not None:
            return self._fail_batch(batch, chain, err, dispatch_no)
        if chain is not None:
            if chain["dead"]:  # an earlier segment already failed it
                return 0
            chain["parts"].append(out[:used_rows])
            if not final:
                return 0
            out = np.concatenate(chain["parts"])
            used_rows = chain["total"]
        elif not final:  # pragma: no cover - unsegmented is always final
            return 0
        now = time.perf_counter()
        lo = 0
        for req in batch:
            dec = np.array(out[lo:lo + req.n, group.slices[req.entry]])
            lo += req.n
            if req.entry.f64_cols.size:
                _overwrite_f64(req.entry, req.rows, dec)
            self._finish_served(req, dec, now)
        return len(batch)

    def _fail_batch(self, batch, chain, err: str,
                    dispatch_no: int) -> int:
        """A dispatch raised or the watchdog tripped: complete every
        request of the batch with an explicit 'failed' verdict and the
        per-model counters — the engine itself keeps serving (the
        wedged dispatch cost one batch, not the pump thread)."""
        if chain is not None:
            if chain["dead"]:
                return 0  # the chain already failed once
            chain["dead"] = True
        self.dispatch_failures.add(1)
        if "watchdog" in err:
            self.watchdog_trips.add(1)
        self._obs.event("dispatch_failed",
                        models=sorted({r.entry.name for r in batch}),
                        error=err[:200], dispatch=dispatch_no,
                        watchdog=bool("watchdog" in err))
        now = time.perf_counter()
        for req in batch:
            mm = self._model_metrics(req.entry.name)
            mm["failures"].add(1)
            self._done[req.ticket] = ServeResult(
                ticket=req.ticket, model=req.entry.name,
                version=req.entry.version, decision=None,
                verdict="failed", latency_s=now - req.t_submit,
                entry=req.entry)
        return len(batch)

    # -------------------------------------------------------- completion
    def _finish_served(self, req: Request, dec: np.ndarray,
                       now: float) -> None:
        late = now > req.deadline
        latency = now - req.t_submit
        mm = self._model_metrics(req.entry.name)
        self.request_seconds.observe(latency)
        mm["latency"].observe(latency)
        if late:
            self.deadline_misses.add(1)
            mm["misses"].add(1)
        self._done[req.ticket] = ServeResult(
            ticket=req.ticket, model=req.entry.name,
            version=req.entry.version, decision=dec,
            verdict="late" if late else "ok", latency_s=latency,
            entry=req.entry)

    def _finish_expired(self, req: Request) -> None:
        now = time.perf_counter()
        mm = self._model_metrics(req.entry.name)
        self.deadline_misses.add(1)
        self.expired.add(1)
        mm["misses"].add(1)
        mm["expired"].add(1)
        self._done[req.ticket] = ServeResult(
            ticket=req.ticket, model=req.entry.name,
            version=req.entry.version, decision=None,
            verdict="expired", latency_s=now - req.t_submit,
            entry=req.entry)

    # -------------------------------------------------------- convenience
    def decision(self, rows, model: Optional[str] = None) -> np.ndarray:
        """Synchronous one-request convenience: submit + drain + slice
        (the v1 decision() shape)."""
        ticket = self.submit(rows, model=model, deadline_ms=None)
        done = self.drain()
        res = done.pop(ticket)
        self._done.update(done)  # other tickets stay claimable
        return res.decision

    def predict(self, rows, model: Optional[str] = None) -> np.ndarray:
        ticket = self.submit(rows, model=model, deadline_ms=None)
        done = self.drain()
        res = done.pop(ticket)
        self._done.update(done)
        return res.labels()  # the SERVING version's fold, swap-safe

    # --------------------------------------------------------- telemetry
    def attach_net(self, front) -> None:
        """Attach the network front door (serving/server.py): its
        counters join snapshot() (under the ``net`` key) and its
        OpenMetrics families join the /metrics exposition.
        While a front door is attached, ITS pump thread is the
        engine's single driver — in-process submit()/drain() callers
        must not race it (registry swaps on admin threads remain
        fine)."""
        self._front = front

    def bucket_suggestion(self) -> dict:
        """Occupancy-driven ``ServeConfig.buckets`` advice from the
        engine's own dispatch telemetry (a host read of the batch_rows
        window). Report-only UNLESS ``buckets=None`` resolved to an
        armed auto-apply (maybe_apply_bucket_suggestion): whether
        right-sizing pays at all is a device property, which the
        autotune ``serve_buckets`` probe measures."""
        return suggest_buckets(self.batch_rows.window_values(),
                               self._bucket_ladder)

    def maybe_apply_bucket_suggestion(self):
        """Profile-gated bucket AUTO-APPLY. A no-op returning None unless
        ALL of:
          * ``config.buckets is None`` (an explicit ladder always wins);
          * the resolved provenance carries ``auto_apply`` (an
            AUTHORITATIVE serve_buckets pays verdict in the active
            DeviceProfile; the CPU profile pins it False);
          * the occupancy suggestion exists and differs from the
            current ladder.
          * no admin thread is preparing a swap (``_preparing``, as
            _gc_groups checks it).
        On apply: swaps the engine's ladder, drops the staged groups
        (they restage lazily, at the next request; drain() calls this
        between serving legs, with the queues empty) and extends the
        provenance with what was applied, so the snapshot carries the
        whole decision trail. Returns the applied ladder.

        The swap and the clear hold ``_prep_lock``: a preparation that
        started earlier would publish a group staged under the old
        ladder after the clear (so the swap waits for the next leg), and
        one that starts later reads the new ladder."""
        if self.config.buckets is not None \
                or not self.bucket_provenance.get("auto_apply"):
            return None
        sug = self.bucket_suggestion()
        ladder = sug.get("suggested_buckets")
        if not ladder or tuple(ladder) == self._bucket_ladder:
            return None
        with self._prep_lock:
            if self._preparing:
                return None
            self._bucket_ladder = tuple(int(b) for b in ladder)
            self.bucket_provenance = {
                **self.bucket_provenance,
                "applied_buckets": list(self._bucket_ladder),
                "suggestion": sug}
            self._groups.clear()
        self._obs.event("buckets_auto_applied",
                        buckets=list(self._bucket_ladder),
                        occupancy=sug.get("projected_occupancy"))
        return list(self._bucket_ladder)

    def snapshot(self) -> dict:
        """JSON-able engine state: counters, queue state, histogram
        snapshots, per-model breakdown."""
        storage_by_model = {e.name: self._storage_of(e)
                            for e in self.registry.entries()}
        per_model = {}
        for name, mm in sorted(self._per_model.items()):
            per_model[name] = {
                "requests": mm["requests"].value,
                "rows": mm["rows"].value,
                "deadline_misses": mm["misses"].value,
                "expired": mm["expired"].value,
                "swaps": mm["swaps"].value,
                "dispatch_failures": mm["failures"].value,
                "request_seconds": mm["latency"].snapshot(),
                **({"union_storage": storage_by_model[name]}
                   if name in storage_by_model else {}),
            }
        staged = list(self._groups.values())
        return {
            "models": self.registry.names(),
            "versions": {e.name: e.version
                         for e in self.registry.entries()},
            "union_mesh_devices": self.config.num_devices,
            **({"replica": self.replica}
               if self.replica is not None else {}),
            "dispatches": self._dispatches,
            "rows": self._rows_total,
            "requests": self._next_ticket,
            "queue_depth": self.scheduler.queue_depth,
            "queue_rows": self.scheduler.queue_rows,
            "deadline_misses": self.deadline_misses.value,
            "expired": self.expired.value,
            "hot_swaps": self.hot_swaps.value,
            "dispatch_failures": self.dispatch_failures.value,
            "watchdog_trips": self.watchdog_trips.value,
            "rehydrated_models": list(self._rehydrated),
            "coalesced_dispatches": self.coalesced.value,
            "compiles": self.compiles.value,
            "batch_occupancy": self.batch_occupancy.snapshot(),
            "dispatch_seconds": self.dispatch_seconds.snapshot(),
            "request_seconds": self.request_seconds.snapshot(),
            "union_bytes": sum(g.union_bytes for g in staged),
            "quantized_unions": sum(
                1 for g in staged if g.union_storage == "int8"),
            "union_storage": storage_by_model,
            "buckets": list(self._bucket_ladder),
            "bucket_provenance": self.bucket_provenance,
            "per_model": per_model,
            **({"net": self._front.net_snapshot()}
               if self._front is not None else {}),
        }

    def render_openmetrics(self) -> str:
        """The /metrics exposition: per-model labelled counters and
        latency summaries, queue-depth gauges, deadline-miss and
        hot-swap counters, batch-occupancy summary — quantiles ARE
        Histogram.percentiles() (scrape == snapshot). Host reads only;
        a scrape can never add a device dispatch."""
        om = openmetrics
        depth = self.scheduler.depth_by_model()
        versions = {e.name: e.version for e in self.registry.entries()}
        req_s, row_s, miss_s, exp_s, swap_s = [], [], [], [], []
        fail_s = []
        lat_samples = []
        for name, mm in sorted(self._per_model.items()):
            lb = {"model": name}
            req_s.append(("_total", lb, mm["requests"].value))
            row_s.append(("_total", lb, mm["rows"].value))
            miss_s.append(("_total", lb, mm["misses"].value))
            exp_s.append(("_total", lb, mm["expired"].value))
            swap_s.append(("_total", lb, mm["swaps"].value))
            fail_s.append(("_total", lb, mm["failures"].value))
            if len(mm["latency"]):
                lat_samples.extend(om.summary_samples(
                    mm["latency"], labels=lb))
        fams = [
            om.metric("serving_requests", "counter",
                      "requests admitted", req_s),
            om.metric("serving_rows", "counter", "query rows admitted",
                      row_s),
            om.metric("serving_deadline_misses", "counter",
                      "requests that missed their deadline (served "
                      "late or shed)", miss_s),
            om.metric("serving_expired", "counter",
                      "requests shed at batch forming (deadline "
                      "already passed)", exp_s),
            om.metric("serving_hot_swaps", "counter",
                      "zero-downtime model version swaps", swap_s),
            om.metric("serving_dispatch_failures", "counter",
                      "requests failed by a raising or watchdog-"
                      "bounded device dispatch (explicit 'failed' "
                      "verdicts, engine kept serving)", fail_s),
            om.counter("serving_watchdog_trips",
                       "dispatches failed by the dispatch watchdog "
                       "(ServeConfig.dispatch_timeout_ms)",
                       self.watchdog_trips.value),
            om.gauge("serving_model_version",
                     "live registered version per model",
                     [({"model": n}, v)
                      for n, v in sorted(versions.items())]),
            om.gauge("serving_queue_depth",
                     "queued requests awaiting dispatch",
                     [({"model": n}, v)
                      for n, v in sorted(depth.items())]),
            om.gauge("serving_queue_rows",
                     "queued query rows awaiting dispatch",
                     [({}, self.scheduler.queue_rows)]),
            om.counter("serving_dispatches", "device bucket dispatches",
                       self._dispatches),
            om.counter("serving_coalesced_dispatches",
                       "dispatches answering more than one model from "
                       "one union matmul", self.coalesced.value),
            om.counter("serving_compiles",
                       "bucket executors compiled while serving",
                       self.compiles.value),
            om.gauge("serving_union_bytes",
                     "staged union argument bytes per model at its "
                     "resolved storage (int8 includes the f32 row "
                     "scales)",
                     [({"model": e.name,
                        "union_storage": self._storage_of(e)},
                       union_nbytes(self._storage_of(e),
                                    int(e.ens.sv_union.shape[0]),
                                    int(e.ens.sv_union.shape[1])))
                      for e in sorted(self.registry.entries(),
                                      key=lambda e: e.name)]),
            om.gauge("serving_quantized_unions",
                     "staged union groups serving from int8 rows",
                     [({}, sum(1 for g in self._groups.values()
                               if g.union_storage == "int8"))]),
        ]
        if lat_samples:
            fams.append(om.metric(
                "serving_request_seconds", "summary",
                "request latency (submit->complete), recent-window "
                "quantiles", lat_samples))
        if len(self.batch_occupancy):
            fams.append(om.summary(
                "serving_batch_occupancy",
                "rows dispatched / bucket capacity, recent window",
                self.batch_occupancy))
        if len(self.dispatch_seconds):
            fams.append(om.summary(
                "serving_dispatch_seconds",
                "host blocking wait per dispatch (overlap residual), "
                "recent window", self.dispatch_seconds))
        sug = self.bucket_suggestion()
        if sug.get("suggested_buckets"):
            # Occupancy-driven bucket advice: one gauge sample per
            # suggested ladder slot, report-only.
            fams.append(om.gauge(
                "serving_suggested_bucket",
                "occupancy-driven ServeConfig.buckets suggestion "
                "(report-only)",
                [({"slot": str(i)}, b)
                 for i, b in enumerate(sug["suggested_buckets"])]))
        if self._front is not None:
            # Front-door families: connection / frame / verdict
            # accounting rides the SAME exposition (one scrape, one
            # truth).
            fams.extend(self._front.net_families())
        return om.render(fams)

    def close(self) -> None:
        """Drain outstanding work, stop /metrics FIRST (the ordering
        contract: a racing scrape sees a full exposition, the # EOF
        stub, or a clean refusal — never a half-torn-down read),
        and tear down. A
        close() arriving DURING an active drain() waits on the
        lifecycle lock for that drain to complete, then tears down
        once; a second close() is a no-op."""
        if self._closed:
            return
        with self._lifecycle:
            if self._closed:
                return
            self._closing = True
            if self.exporter is not None:
                self.exporter.close()
            while self.scheduler.queue_depth or self._dispatcher.busy:
                self.pump()
            self._gc_groups()
            self._obs.finish(**self.snapshot())
            self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

