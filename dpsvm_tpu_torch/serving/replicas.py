"""Replica fleet: N serving engines behind one front door (counterpart
of dpsvm_tpu/serving/replicas.py).

One :class:`~dpsvm_tpu_torch.serving.dispatch.ServingEngine` is single-driver
by design — one pump thread owns admission, dispatch and routing, and
on the device side one engine drives one accelerator (or one mesh of
them, via the UnionGroup mesh variant). That is the SCALE-DOWN axis.
This module is the SCALE-OUT axis: a :class:`ReplicaFleet` constructs
N engines from one ``ServeConfig`` (``replicas=N``) and hands them to
the network front door (serving/server.py), whose per-replica pump
threads route the shared inbox to whichever replica has room. The
fleet itself holds NO routing logic — routing lives in the front
door's pump/admission layer, the one place every frame already passes
through — and NO request state: it is the fleet's job to keep the N
engines' MODEL SETS identical and their lifecycles coordinated:

* REGISTRATION fans out: ``register``/``swap``/``unregister`` apply to
  every replica in fleet order, so version counters advance in
  lockstep and any replica answers any model at the same version.
  A mid-loop failure raises after rolling the already-updated
  replicas back where possible — a split fleet is the failure mode
  this loop exists to prevent (see ``swap``).
* THE REGISTRY JOURNAL IS THE SHARED SOURCE OF TRUTH: every replica
  attaches the SAME ``journal_path``. Each register/swap atomically
  rewrites the whole-set snapshot, and because every replica applies
  the same ops in the same order at the same versions, the N writes
  are byte-identical — last-writer-wins is idempotent. A restarted
  replica rehydrates from that one file and comes back serving the
  exact versions its peers are serving; ``swap`` therefore coordinates
  across replicas with zero downtime (in-flight work finishes on the
  old version per engine, exactly the single-engine hot-swap
  contract).
* ROLLING RESTART (:meth:`restart_replica`): drain replica k through
  the front door (its pump stops popping, queued work finishes or
  sheds through the normal verdicts, peers keep serving), close its
  engine, construct a fresh one that rehydrates from the shared
  journal, resume. Zero lost or duplicated frames under sustained load.

The fleet owns the /metrics exporter (engines are built with
``metrics_port=None``) so one scrape exposes the whole fleet:
``serving_fleet_*`` aggregates plus the front door's
``serving_replica_*`` and ``serving_net_*`` families.
"""

from __future__ import annotations

import threading

from dpsvm_tpu_torch.config import ServeConfig
from dpsvm_tpu_torch.obs import export as openmetrics
from dpsvm_tpu_torch.obs import run_obs
from dpsvm_tpu_torch.serving.dispatch import ServingEngine


class ReplicaFleet:
    """``config.replicas`` ServingEngines with identical model sets,
    one shared registry journal, one /metrics exposition — the object
    ``cli serve --listen --replicas N`` hands to ServeServer.

    Duck-type contract with the front door: ``engines`` (list, read
    through on every pump iteration so restarts are picked up live),
    ``config``, ``attach_net``. Model admin (register/swap/
    unregister) may run on any thread — per-engine it lands on the
    registry's admin path, same as a standalone engine. Every replica
    runs on `device` (None: the CUDA card), each with its own stream."""

    def __init__(self, config: ServeConfig = ServeConfig(), device=None):
        if config.replicas < 1:
            raise ValueError("ReplicaFleet needs replicas >= 1")
        config.check_ported()
        self.config = config
        self.device = device
        # Engines never bind their own metrics port (the fleet owns
        # the exposition) and individually look like single-replica
        # configs — replica identity is the constructor arg.
        self._eng_config = config.replace(metrics_port=None, replicas=1)
        self._obs = run_obs("serve", config, device=device,
                            meta={"engine": "serving_fleet",
                                  "replicas": config.replicas,
                                  "buckets": list(config.buckets or ()),
                                  "dtype": config.dtype,
                                  "deadline_ms": config.deadline_ms})
        self._front = None
        self._closed = False
        self._lifecycle = threading.RLock()
        self.exporter = None
        self.engines: list = []
        try:
            for i in range(config.replicas):
                self.engines.append(
                    ServingEngine(self._eng_config, replica=i,
                                  device=device))
            self._obs.event("fleet_up", replicas=len(self.engines),
                            journal=bool(config.journal_path))
            if config.metrics_port is not None:
                import weakref

                ref = weakref.ref(self)

                def _render(_ref=ref):
                    fleet = _ref()
                    if fleet is None or fleet._closed:
                        return "# EOF\n"
                    return fleet.render_openmetrics()

                self.exporter = openmetrics.MetricsExporter(
                    _render, port=config.metrics_port,
                    host=config.metrics_host)
        except BaseException:
            # Half-built fleet: tear down what exists (a leaked exporter
            # keeps the port bound).
            for eng in self.engines:
                try:
                    eng.close()
                except Exception:
                    pass
            if self.exporter is not None:
                self.exporter.close()
            self._obs.finish(aborted=True)
            raise

    # ------------------------------------------------------ registration
    def register(self, name: str, source):
        """Register on EVERY replica (fleet order). Returns the last
        replica's entry — all N are at the same version by
        construction. A failure on replica j unregisters the j
        already-registered replicas so the fleet never serves a model
        from some replicas and 'unknown model' from others."""
        done = []
        try:
            for eng in self.engines:
                entry = eng.register(name, source)
                done.append(eng)
        except BaseException:
            for eng in done:
                try:
                    eng.unregister(name)
                except Exception:
                    pass
            raise
        self._obs.event("fleet_register", model=name, version=entry.version,
                        replicas=len(self.engines))
        return entry

    def swap(self, name: str, source):
        """Hot-swap on EVERY replica. Each engine runs the full
        validate-stage-warm path before its routing flip, so a bad
        model fails on replica 0 BEFORE any replica flipped — the
        common failure (bad source) leaves the fleet untouched on the
        old version. A failure after some replicas flipped (rarer:
        resource exhaustion mid-loop) raises with the fleet split; the
        caller retries the swap, which is idempotent per engine. Every
        flip journals the same whole-set snapshot, so a replica
        restarting at ANY instant rehydrates to a version some live
        replica is serving."""
        entry = None
        flipped = 0
        try:
            for eng in self.engines:
                entry = eng.swap(name, source)
                flipped += 1
        except BaseException:
            if flipped:
                self._obs.event("fleet_swap_split", model=name,
                                flipped=flipped, replicas=len(self.engines))
            raise
        self._obs.event("fleet_swap", model=name, version=entry.version,
                        replicas=len(self.engines))
        return entry

    def unregister(self, name: str):
        out = None
        for eng in self.engines:
            out = eng.unregister(name)
        self._obs.event("fleet_unregister", model=name,
                        replicas=len(self.engines))
        return out

    # -------------------------------------------------- rolling restart
    def restart_replica(self, rep: int, timeout_s: float = 60.0):
        """Rolling restart of one replica with zero downtime: drain it
        through the front door (peers keep serving), close its engine,
        construct a fresh one — which REHYDRATES the model set from
        the shared registry journal at the exact versions its peers
        serve — and resume its pump. Returns the fresh engine.

        Requires a journal (``config.journal_path``) for the model set
        to survive the restart; without one the fresh engine comes up
        empty and the caller must re-register (in-memory models are
        never journaled — the single-engine crash-recovery contract).
        """
        if not 0 <= rep < len(self.engines):
            raise ValueError(f"replica {rep} out of range "
                             f"(0..{len(self.engines) - 1})")
        with self._lifecycle:
            if self._closed:
                raise RuntimeError("fleet is closed")
            self._obs.event("restart_replica", phase="begin", replica=rep)
            if self._front is not None:
                self._front.drain_replica(rep, timeout_s=timeout_s)
            old = self.engines[rep]
            old.close()
            fresh = ServingEngine(self._eng_config, replica=rep,
                                  device=self.device)
            # Engines are read through this list on every pump
            # iteration — publishing the fresh engine here is the
            # whole swap.
            self.engines[rep] = fresh
            if self._front is not None:
                self._front.resume_replica(rep)
            self._obs.event("restart_replica", phase="end", replica=rep,
                            rehydrated=list(fresh._rehydrated))
            return fresh

    # ---------------------------------------------------------- lifecycle
    def attach_net(self, front) -> None:
        """Attach the network front door: its per-replica pump threads
        drive the engines from here on; the fleet's snapshot and
        /metrics exposition read its routing state."""
        self._front = front

    def drain(self) -> dict:
        """Pump every replica to quiescence (in-process convenience —
        behind a front door, :meth:`ServeServer.drain` is the real
        drain). Returns {replica: results-dict}."""
        return {i: eng.drain() for i, eng in enumerate(self.engines)}

    def close(self) -> None:
        """Close every replica and the fleet exposition. Never touches
        an attached front door — callers own ``server.close()`` BEFORE
        ``fleet.close()`` (the cli teardown ordering), same as the
        single-engine contract."""
        with self._lifecycle:
            if self._closed:
                return
            self._closed = True
            if self.exporter is not None:
                self.exporter.close()
            for eng in self.engines:
                eng.close()
            self._obs.finish(**self.snapshot())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # --------------------------------------------------------- telemetry
    def snapshot(self) -> dict:
        """JSON-able fleet state: aggregates plus each replica's full
        engine snapshot (which carries its ``replica`` stamp and
        ``union_mesh_devices``)."""
        per = [eng.snapshot() for eng in self.engines]
        out = {
            "engine": "serving_fleet",
            "replicas": len(self.engines),
            "requests": sum(p["requests"] for p in per),
            "rows": sum(p["rows"] for p in per),
            "dispatches": sum(p["dispatches"] for p in per),
            "queue_depth": sum(p["queue_depth"] for p in per),
            "deadline_misses": sum(p["deadline_misses"] for p in per),
            "expired": sum(p["expired"] for p in per),
            "hot_swaps": sum(p["hot_swaps"] for p in per),
            "union_mesh_devices": self.config.num_devices,
            "per_replica": per,
        }
        if self._front is not None:
            out["net"] = self._front.net_snapshot()
            out["replica_routing"] = self._front.replica_snapshot()
        return out

    def render_openmetrics(self) -> str:
        """The fleet /metrics exposition: serving_fleet_* aggregates
        with a ``rep`` label where per-replica resolution matters,
        plus the front door's serving_replica_* and serving_net_*
        families (one scrape, one truth — same discipline as the
        single engine)."""
        om = openmetrics
        per = [(str(i), eng.snapshot())
               for i, eng in enumerate(self.engines)]
        fams = [
            om.gauge("serving_fleet_replicas",
                     "engine replicas behind the front door",
                     [({}, len(self.engines))]),
            om.metric("serving_fleet_requests", "counter",
                      "requests admitted, by replica",
                      [("_total", {"rep": i}, p["requests"])
                       for i, p in per]),
            om.metric("serving_fleet_rows", "counter",
                      "query rows admitted, by replica",
                      [("_total", {"rep": i}, p["rows"])
                       for i, p in per]),
            om.metric("serving_fleet_dispatches", "counter",
                      "device dispatches, by replica",
                      [("_total", {"rep": i}, p["dispatches"])
                       for i, p in per]),
        ]
        if self._front is not None:
            fams.extend(self._front.net_families())
        return om.render(fams)
