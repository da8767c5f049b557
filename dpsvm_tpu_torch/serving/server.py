"""Network front door of the v2 serving engine (counterpart of
dpsvm_tpu/serving/server.py).

The PR 9/13 ServingEngine — hot swap, EDF shedding, dispatch watchdog,
crash-recovery journal — was reachable only in-process; not one of the
failure modes a real network imposes (half-open connections, slow
writers, client deadlines, overload from strangers) had an answer or a
test. This module is that answer: a persistent-connection TCP endpoint
(threaded stdlib socketserver, no new deps) speaking the
length-prefixed binary frames of :mod:`dpsvm_tpu_torch.serving.wire`, built
so that **every accepted frame terminates in exactly one wire verdict**
and every degraded behavior is a policy, not an accident:

* DEADLINE PROPAGATION is clock-skew-safe: the client ships its
  REMAINING BUDGET (a duration); the server anchors it to its own
  monotonic clock at parse time and hands it to the EDF scheduler —
  wall clocks never cross the wire (wire.py's clock contract).
* ADMISSION CONTROL turns saturation into an immediate ``rejected``
  verdict with a ``retry_after_ms`` hint instead of unbounded
  buffering: a request arriving past ``ServeConfig.admission_max_rows``
  queued rows never enters the engine.
* PER-CONNECTION READ/WRITE TIMEOUTS bound slow-loris and dead-peer
  cost: an idle half-open connection dies after
  ``conn_read_timeout_ms`` with no complete frame; a stalled reader
  whose verdict write blocks ``conn_write_timeout_ms`` kills ONLY that
  connection (its unsent verdicts counted undeliverable) — the pump
  thread never blocks on any socket.
* PROTOCOL ERRORS (bad magic, oversized length prefix, truncated or
  inconsistent frames) cost exactly their own connection: an ERROR
  frame goes out, the connection closes, every other connection and
  the engine itself are untouched.
* GRACEFUL DRAIN (:meth:`ServeServer.drain`, wired to SIGTERM by
  ``cli serve --listen``): stop accepting, finish or shed in-flight
  work by its own deadline through the normal engine verdicts, flush
  the final verdicts, send each connection a GOODBYE frame, close.
  The registry journal was written atomically at register/swap time,
  so the rehydrate path needs nothing from the drain.

THREADING MODEL: reader threads (one per connection, socketserver's)
parse frames and enqueue them on ONE shared inbox; ONE pump thread PER
ENGINE REPLICA owns its engine — admission, submit, pump, result
routing all happen there (each engine is single-driver by design; only
registry swaps may run on admin threads). Writer threads (one per
connection) drain per-connection outboxes so a slow peer can never
block verdict routing. All accounting counters share one lock and
reconcile exactly: ``frames_accepted == sum(verdicts)`` and every
verdict is either delivered or counted undeliverable, so the
conservation law can be checked against the clients' tallies.

REPLICA ROUTING (serving/replicas.py ReplicaFleet behind this front
door) is slotted into the pump/admission layer — the one place every
frame already passes through: a replica's pump thread pops the shared
inbox only while it will actually take new work (not draining, and its
queue under the admission bound unless EVERY live replica is equally
full — then any of them pops and the admission reject fires exactly as
on a single engine). Work therefore flows to whichever replica has
room, with no separate router thread, no per-frame routing decision
outside the pump layer, and — at one replica — byte-for-byte the
single-engine behavior. Per-replica ``drain_replica``/
``resume_replica`` make rolling restarts a policy: the drained replica
stops popping, finishes or sheds its queued work through the normal
verdicts, and parks while its peers keep serving.
"""

from __future__ import annotations

import queue
import select
import socket
import socketserver
import threading
import time
from typing import Optional

from dpsvm_tpu_torch.obs import export as om
from dpsvm_tpu_torch.serving import wire
from dpsvm_tpu_torch.testing import faults

#: bounded per-connection outbox (verdict frames awaiting the writer).
#: A reader stalled long enough to back this up is a slow reader by
#: definition — the connection is killed (its verdicts counted
#: undeliverable) rather than letting the queue grow without bound.
OUTBOX_FRAMES = 1024


class _NetStats:
    """Front-door accounting. One lock, exact conservation:
    ``frames_accepted == sum(verdicts.values())`` at every quiescent
    instant, and ``verdicts[v] == delivered + undeliverable[v]`` —
    a client's tallies reconcile against these."""

    FIELDS = ("conns_opened", "conns_closed", "conns_killed",
              "accept_drops", "conns_aborted", "frames_accepted",
              "protocol_errors", "goodbyes_sent")

    def __init__(self):
        self.lock = threading.Lock()
        for f in self.FIELDS:
            setattr(self, f, 0)
        self.verdicts = {v: 0 for v in wire.VERDICTS}
        self.undeliverable = {v: 0 for v in wire.VERDICTS}

    def bump(self, field: str, n: int = 1) -> None:
        with self.lock:
            setattr(self, field, getattr(self, field) + n)

    def verdict(self, name: str) -> None:
        with self.lock:
            self.verdicts[name] += 1

    def undelivered(self, name: str) -> None:
        with self.lock:
            self.undeliverable[name] += 1

    def snapshot(self) -> dict:
        with self.lock:
            out = {f: getattr(self, f) for f in self.FIELDS}
            out["verdicts"] = dict(self.verdicts)
            out["verdicts_undeliverable"] = dict(self.undeliverable)
            out["rejected"] = self.verdicts["rejected"]
            out["undeliverable_total"] = sum(
                self.undeliverable.values())
            return out


def _send_with_deadline(sock: socket.socket, data: bytes,
                        timeout_s: float) -> None:
    """sendall with a WHOLE-FRAME deadline (socket timeouts bound one
    syscall, not a frame trickled to a slow reader). select-gated so a
    full send buffer costs bounded wall clock, never a wedged writer
    thread. PRECONDITION: the socket must be in timeout mode (every
    front-door connection is — _serve_conn sets conn_read_timeout) so
    a post-select send() does one partial write instead of blocking
    for the whole buffer."""
    deadline = time.monotonic() + timeout_s
    view = memoryview(data)
    off = 0
    while off < len(view):
        remain = deadline - time.monotonic()
        if remain <= 0:
            raise socket.timeout(
                f"frame write exceeded {timeout_s:.3f}s "
                f"({off}/{len(view)} bytes)")
        _, writable, _ = select.select([], [sock], [], remain)
        if not writable:
            raise socket.timeout(
                f"frame write exceeded {timeout_s:.3f}s "
                f"({off}/{len(view)} bytes)")
        off += sock.send(view[off:])


class _Conn:
    """One live connection: the reader runs in the socketserver handler
    thread; ``outbox`` feeds the dedicated writer thread. Frames are
    (kind, bytes, verdict-name-or-None) — ``goodbye``/``error`` close
    the connection after sending; ``close`` closes silently.

    The enqueue/teardown race is closed by ``_lock``: a frame is
    either enqueued BEFORE the connection is marked dead (and then
    counted undeliverable by the teardown drain if never sent) or
    refused AFTER (and counted undeliverable by the caller) — no
    verdict can fall between the two accountings."""

    def __init__(self, server: "ServeServer", sock: socket.socket,
                 cid: int):
        self.server = server
        self.sock = sock
        self.cid = cid
        self.outbox: queue.Queue = queue.Queue(maxsize=OUTBOX_FRAMES)
        self.dead = False  # no further enqueues accepted
        self._lock = threading.Lock()
        self._drained_dead = False
        self.reader: Optional[threading.Thread] = None
        self.writer = threading.Thread(
            target=self._write_loop, daemon=True,
            name=f"dpsvm-net-writer-{cid}")
        self.writer.start()

    def enqueue(self, kind: str, frame: bytes,
                verdict: Optional[str] = None) -> bool:
        """Queue one frame; False (undeliverable accounting is then
        the CALLER's) when the connection is dead or the outbox is
        full — a backed-up outbox IS the slow-reader bound, so it
        kills the connection rather than growing."""
        with self._lock:
            if self.dead:
                return False
            try:
                self.outbox.put_nowait((kind, frame, verdict))
                return True
            except queue.Full:
                pass
        self.kill("outbox full (slow reader)")
        return False

    def kill(self, reason: str) -> None:
        """Server-initiated teardown: mark dead, wake reader AND
        writer via socket shutdown; the writer's exit path counts the
        unsent verdicts undeliverable."""
        with self._lock:
            if self.dead:
                return
            self.dead = True
        self.server._stats.bump("conns_killed")
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:  # wake a writer idle on an empty outbox
            self.outbox.put_nowait(("close", b"", None))
        except queue.Full:
            pass  # writer is mid-queue; its next send fails post-shutdown

    def _drain_dead(self) -> None:
        """Mark dead and count every still-queued verdict
        undeliverable (exactly once — the _lock closes the race with
        concurrent enqueues)."""
        with self._lock:
            if self._drained_dead:
                return
            self.dead = True
            self._drained_dead = True
            while True:
                try:
                    _, _, verdict = self.outbox.get_nowait()
                except queue.Empty:
                    break
                if verdict is not None:
                    self.server._stats.undelivered(verdict)

    def _write_loop(self) -> None:
        stats = self.server._stats
        timeout_s = self.server._write_timeout_s
        while True:
            kind, frame, verdict = self.outbox.get()
            if kind == "close":
                break
            try:
                _send_with_deadline(self.sock, frame, timeout_s)
            except (OSError, ValueError):
                # ValueError: fd already closed under select()
                if verdict is not None:
                    stats.undelivered(verdict)
                break
            if kind in ("goodbye", "error"):
                break
        self._drain_dead()
        # shutdown BEFORE close: close() alone does not wake a reader
        # blocked in recv on the shared fd; shutdown delivers it EOF.
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        self.server._conn_closed(self)


class _TCP(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True
    front: "ServeServer" = None  # set right after construction

    def __init__(self, *a, **kw):
        import weakref

        self.owned_socks = weakref.WeakSet()
        super().__init__(*a, **kw)

    def shutdown_request(self, request):
        # socketserver closes the socket when the handler (our reader
        # loop) returns — but the connection's WRITER thread may still
        # be flushing verdicts on it. Once a _Conn owns the socket,
        # teardown belongs to the writer's exit path; refused
        # connections (verify_request False) never get an owner and
        # close here as usual.
        if request in self.owned_socks:
            return
        super().shutdown_request(request)

    def verify_request(self, request, client_address) -> bool:
        # Drain refusals and the net_accept fault seam (accept-queue
        # overflow) both drop the connection before any frame — the
        # client sees an instant EOF, the connect-retry class.
        if self.front._draining or faults.net_accept_drop():
            self.front._stats.bump("accept_drops")
            return False
        return True


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        self.server.front._serve_conn(self.request, self.client_address)


class ServeServer:
    """The TCP front door over one :class:`ServingEngine` — or over a
    :class:`serving.replicas.ReplicaFleet` of them (anything exposing
    ``engines``/``config``/``attach_net``).

    Construction binds the listener and starts the accept + pump
    threads (one pump thread per replica); the engine must already
    exist (models may register before or after — submits resolve at
    frame time). ``host``/``port`` default to the engine config's
    ``listen`` spec, else loopback on an ephemeral port (read
    ``server.port``).

    Lifecycle: :meth:`drain` is the graceful half (stop accepting,
    flush verdicts, GOODBYE, close connections, stop the pumps);
    :meth:`close` is drain + listener teardown and is idempotent;
    :meth:`drain_replica`/:meth:`resume_replica` are the per-replica
    rolling-restart half. The server never closes the engine — the
    caller owns that ordering (``cli serve --listen`` does drain →
    ``engine.close()`` on SIGTERM)."""

    def __init__(self, engine, host: Optional[str] = None,
                 port: Optional[int] = None):
        config = engine.config
        if host is None or port is None:
            if config.listen is not None:
                host, port = config.listen_addr()
            else:
                host, port = "127.0.0.1", 0
        # One engine or a fleet of replicas; either way the /metrics
        # attachment belongs to the target, the per-replica pump threads
        # to this front door.
        self._fleet = engine if hasattr(engine, "engines") else None
        self._engine = None if self._fleet is not None else engine
        self._n_rep = (len(self._fleet.engines)
                       if self._fleet is not None else 1)
        # The front door writes its events into the run log of the
        # engine or fleet it serves (NULL_OBS when obs is off).
        self._obs = engine._obs
        self._stats = _NetStats()
        self._inbox: queue.Queue = queue.Queue()
        self._inbox_pending = 0  # put-but-not-yet-handled (drain gate)
        self._pending_lock = threading.Lock()
        # Per replica: ticket -> (conn, req_id, want_dec) — tickets are
        # per-engine counters, so the routing key is (replica, ticket).
        self._tickets = [dict() for _ in range(self._n_rep)]
        self._rep_draining = [False] * self._n_rep
        self._rep_parked = [False] * self._n_rep
        self._rep_lock = threading.Lock()
        self._rep_verdicts = [{v: 0 for v in wire.VERDICTS}
                              for _ in range(self._n_rep)]
        self._conns: dict = {}
        self._conns_lock = threading.Lock()
        self._next_cid = 0
        self._life = threading.RLock()
        self._draining = False
        self._drained = False
        self._closed = False
        self._stop_pump = threading.Event()
        self._read_timeout_s = config.conn_read_timeout_ms / 1e3
        self._write_timeout_s = config.conn_write_timeout_ms / 1e3
        self._max_payload = int(config.max_frame_bytes)
        self._admission_rows = (config.admission_max_rows
                                if config.admission_max_rows is not None
                                else config.max_pending)
        self._retry_base_ms = config.admission_retry_ms

        self._tcp = _TCP((host, int(port)), _Handler,
                         bind_and_activate=True)
        self._tcp.front = self
        self.host, self.port = self._tcp.server_address[:2]
        self._accept_thread = threading.Thread(
            target=self._tcp.serve_forever, kwargs={"poll_interval": 0.05},
            daemon=True, name="dpsvm-net-accept")
        self._pump_threads = [
            threading.Thread(
                target=self._pump_loop, args=(i,), daemon=True,
                name=("dpsvm-net-pump" if self._n_rep == 1
                      else f"dpsvm-net-pump-{i}"))
            for i in range(self._n_rep)]
        self._pump_thread = self._pump_threads[0]
        engine.attach_net(self)
        self._obs.event("listen", host=self.host, port=self.port,
                        admission_max_rows=self._admission_rows,
                        replicas=self._n_rep)
        self._accept_thread.start()
        for th in self._pump_threads:
            th.start()

    def _eng(self, rep: int = 0):
        """The live engine for replica `rep` — read through the fleet
        on every call so restart_replica's fresh engine is picked up
        by the very next pump iteration."""
        if self._fleet is not None:
            return self._fleet.engines[rep]
        return self._engine

    # -------------------------------------------------------- reader side
    def _serve_conn(self, sock: socket.socket, addr) -> None:
        with self._conns_lock:
            cid = self._next_cid
            self._next_cid += 1
        threading.current_thread().name = f"dpsvm-net-conn-{cid}"
        self._tcp.owned_socks.add(sock)  # writer-thread teardown now
        sock.settimeout(self._read_timeout_s)
        conn = _Conn(self, sock, cid)
        conn.reader = threading.current_thread()
        with self._conns_lock:
            self._conns[cid] = conn
        self._stats.bump("conns_opened")
        self._obs.event("conn_open", conn=cid, peer=f"{addr[0]}:{addr[1]}")
        # The HELLO banner: the client's proof this connection was
        # actually accepted (a handshake alone completes in the listen
        # backlog — EOF before HELLO is the retry-safe accept-drop).
        conn.enqueue("hello", wire.pack_hello())
        try:
            self._read_loop(conn)
        finally:
            if not conn.dead:
                conn.enqueue("close", b"")
            # the writer owns the socket close + closed accounting

    def _read_loop(self, conn: _Conn) -> None:
        while not conn.dead and not self._closed:
            try:
                head = wire.recv_exact(conn.sock, wire.HEADER_BYTES)
            except wire.ConnectionClosed as e:
                if e.mid_frame:
                    self._stats.bump("conns_aborted")
                return  # clean goodbye at a frame boundary
            except socket.timeout:
                conn.kill("read timeout (idle or half-open peer)")
                return
            except OSError:
                return
            try:
                ftype, length = wire.parse_header(head, self._max_payload)
                if ftype != wire.T_REQUEST:
                    raise wire.WireError(
                        f"clients may only send REQUEST frames "
                        f"(got type {ftype})")
                payload = wire.recv_exact(conn.sock, length)
                req = wire.parse_request(payload)
            except wire.ConnectionClosed:
                self._stats.bump("conns_aborted")
                return
            except socket.timeout:
                conn.kill("read timeout mid-frame")
                return
            except wire.WireError as e:
                self._protocol_error(conn, str(e))
                return
            except OSError:
                return
            with self._pending_lock:
                self._inbox_pending += 1
            self._inbox.put((conn, req))

    def _protocol_error(self, conn: _Conn, msg: str) -> None:
        """A malformed frame kills ONLY its own connection, with an
        ERROR frame out first so the peer knows why."""
        self._stats.bump("protocol_errors")
        self._obs.event("protocol_error", conn=conn.cid, error=msg[:200])
        conn.enqueue("error", wire.pack_error(0, msg))

    # ---------------------------------------------------------- pump side
    def _takes_new(self, rep: int) -> bool:
        """Eligibility gate: may replica `rep`'s pump thread pop the
        shared inbox right now?  A draining replica never pops; under
        a server-wide drain anyone pops (the frame gets its drain
        reject); otherwise pop while this replica's queue is under the
        admission bound — and when it ISN'T, pop anyway only if every
        live peer is equally full, so the admission reject fires
        exactly as it would on a single engine instead of the frame
        rotting in the inbox. At one replica this reduces to
        unconditional popping — the pre-fleet behavior."""
        if self._rep_draining[rep]:
            return False
        if self._draining:
            return True
        if self._eng(rep).scheduler.queue_rows < self._admission_rows:
            return True
        for i in range(self._n_rep):
            if i == rep or self._rep_draining[i]:
                continue
            if self._eng(i).scheduler.queue_rows < self._admission_rows:
                return False  # a peer with room will take it
        return True  # everyone is full: reject rather than buffer

    def _pump_loop(self, rep: int) -> None:
        while not self._stop_pump.is_set():
            # Read the engine through the fleet EVERY iteration so a
            # restart_replica swap is picked up immediately.
            eng = self._eng(rep)
            handled = False
            if self._takes_new(rep):
                # With a batch in flight or queued, poll: blocking here
                # would hold its completion (and the client waiting on
                # it) up to the 20 ms timeout.
                working = eng.scheduler.queue_depth or eng._dispatcher.busy
                try:
                    conn, req = (self._inbox.get_nowait() if working
                                 else self._inbox.get(timeout=0.02))
                    handled = True
                except queue.Empty:
                    pass
            if handled:
                try:
                    self._handle_request(rep, eng, conn, req)
                finally:
                    with self._pending_lock:
                        self._inbox_pending -= 1
                # drain whatever else arrived without blocking, while
                # still eligible (queue may have crossed the bound)
                while self._takes_new(rep):
                    try:
                        conn, req = self._inbox.get_nowait()
                    except queue.Empty:
                        break
                    try:
                        self._handle_request(rep, eng, conn, req)
                    finally:
                        with self._pending_lock:
                            self._inbox_pending -= 1
            busy = eng.scheduler.queue_depth or eng._dispatcher.busy
            if busy:
                eng.pump()
            for ticket, res in eng.results().items():
                self._route(rep, ticket, res)
            if (self._rep_draining[rep] and not self._rep_parked[rep]
                    and not self._tickets[rep]
                    and not eng.scheduler.queue_depth
                    and not eng._dispatcher.busy):
                # drain_replica's signal; under _rep_lock so the park
                # flag never races resume_replica's reset (_rep_parked
                # is _rep_lock's).
                with self._rep_lock:
                    self._rep_parked[rep] = True
            if not handled and not busy:
                time.sleep(0.002)  # parked/ineligible: don't spin
        # Final sweep: a frame parsed between the drain's quiescence
        # check and the stop flag must still get its one verdict (a
        # drain-phase rejection, usually undeliverable past the
        # GOODBYE — but COUNTED, never silently dropped). Any pump
        # thread may pop it; each frame is handled exactly once.
        while True:
            try:
                conn, req = self._inbox.get_nowait()
            except queue.Empty:
                break
            try:
                self._handle_request(rep, self._eng(rep), conn, req)
            finally:
                with self._pending_lock:
                    self._inbox_pending -= 1

    def _handle_request(self, rep: int, eng, conn: _Conn,
                        req: wire.Request) -> None:
        self._stats.bump("frames_accepted")
        if self._draining:
            self._reject(rep, conn, req, "server draining",
                         retry_ms=int(self._retry_base_ms))
            return
        queued = eng.scheduler.queue_rows
        if queued >= self._admission_rows:
            # Deterministic hint: base, scaled by overshoot — enough
            # signal for a polite client backoff without pretending to
            # model service time.
            retry = int(self._retry_base_ms
                        * (1.0 + queued / self._admission_rows))
            self._reject(rep, conn, req,
                         f"admission: {queued} queued rows >= "
                         f"{self._admission_rows}", retry_ms=retry)
            return
        t0 = time.perf_counter()
        try:
            if req.budget_ms is None:
                ticket = eng.submit(req.rows, model=req.model)
            else:
                # The clock contract: budget_ms is a REMAINING DURATION;
                # submit anchors it to the server's monotonic clock.
                ticket = eng.submit(req.rows, model=req.model,
                                    deadline_ms=req.budget_ms)
        except (ValueError, KeyError) as e:
            # Request-level failure (unknown model, wrong width):
            # explicit 'failed' — NOT retryable, the frame itself is
            # wrong.
            self._send_verdict(conn, wire.pack_verdict(
                req.req_id, "failed", model=req.model or "",
                latency_ms=(time.perf_counter() - t0) * 1e3,
                message=str(e)[:300]), "failed", rep)
            return
        # Tickets are per-engine counters: the routing key is
        # (replica, ticket), kept as one dict per replica.
        self._tickets[rep][ticket] = (conn, req.req_id,
                                      req.want_decision)

    def _reject(self, rep: int, conn: _Conn, req: wire.Request,
                reason: str, retry_ms: int) -> None:
        self._send_verdict(conn, wire.pack_verdict(
            req.req_id, "rejected", model=req.model or "",
            retry_after_ms=retry_ms, message=reason), "rejected", rep)

    def _route(self, rep: int, ticket: int, res) -> None:
        meta = self._tickets[rep].pop(ticket, None)
        if meta is None:
            return  # not a wire ticket (in-process submit on this engine)
        conn, req_id, want_dec = meta
        verdict = "served" if res.verdict == "ok" else res.verdict
        labels = decision = None
        if res.decision is not None:
            if want_dec:
                decision = res.decision
            else:
                # ServeResult.labels(): the SERVING version's fold —
                # the one hot-swap-safe definition of label folding.
                labels = res.labels()
        self._send_verdict(conn, wire.pack_verdict(
            req_id, verdict, model=res.model, version=res.version,
            latency_ms=res.latency_s * 1e3, labels=labels,
            decision=decision), verdict, rep)

    def _send_verdict(self, conn: _Conn, frame: bytes,
                      verdict: str, rep: Optional[int] = None) -> None:
        """EVERY wire verdict passes here: counted at enqueue (the
        conservation law's left side); a dead/backed-up connection
        counts it undeliverable instead. `rep` additionally attributes
        the verdict to the replica that produced it — the per-replica
        counters sum exactly to the global ones."""
        self._stats.verdict(verdict)
        if rep is not None:
            with self._rep_lock:
                self._rep_verdicts[rep][verdict] += 1
        if not conn.enqueue("verdict", frame, verdict):
            self._stats.undelivered(verdict)

    # ----------------------------------------------------------- lifecycle
    def _conn_closed(self, conn: _Conn) -> None:
        with self._conns_lock:
            if self._conns.pop(conn.cid, None) is None:
                return
        self._stats.bump("conns_closed")
        self._obs.event("conn_close", conn=conn.cid)

    def drain(self, timeout_s: float = 60.0) -> dict:
        """Graceful drain: stop accepting, let queued work finish or
        shed BY ITS OWN DEADLINE through the engine's normal verdicts,
        flush every outbox, GOODBYE + close each connection, stop the
        pump. Returns the final net snapshot. Idempotent; concurrent
        callers serialize on the lifecycle lock."""
        with self._life:
            if self._drained:
                return self._stats.snapshot()
            self._draining = True
            self._obs.event("drain", phase="begin", conns=len(self._conns),
                            queued=sum(self._eng(i).scheduler.queue_depth
                                       for i in range(self._n_rep)))
            self._tcp.shutdown()  # accept loop exits; no new conns
            # Quiescence: nothing unparsed in the inbox, no un-routed
            # ticket on ANY replica, every engine queue empty, no
            # in-flight device batch anywhere.
            deadline = time.monotonic() + timeout_s
            while time.monotonic() < deadline:
                with self._pending_lock:
                    pending = self._inbox_pending
                if (pending == 0
                        and not any(self._tickets)
                        and all(not self._eng(i).scheduler.queue_depth
                                and not self._eng(i)._dispatcher.busy
                                for i in range(self._n_rep))):
                    break
                time.sleep(0.005)
            # Flush + goodbye. Verdicts already enqueued ride out
            # FIFO ahead of the GOODBYE frame.
            with self._conns_lock:
                conns = list(self._conns.values())
            for conn in conns:
                if conn.enqueue("goodbye",
                                wire.pack_goodbye("server draining")):
                    self._stats.bump("goodbyes_sent")
            for conn in conns:
                conn.writer.join(timeout=self._write_timeout_s + 5.0)
                if conn.writer.is_alive():  # pragma: no cover - wedged
                    conn.kill("writer did not flush within bound")
            for conn in conns:  # readers wake on the writer's shutdown
                if conn.reader is not None:
                    conn.reader.join(timeout=5.0)
            self._stop_pump.set()
            for th in self._pump_threads:
                th.join(timeout=10.0)
            self._tcp.server_close()
            self._accept_thread.join(timeout=5.0)
            self._drained = True
            snap = self._stats.snapshot()
            self._obs.event("drain", phase="end", **{
                k: snap[k] for k in ("frames_accepted", "conns_opened",
                                     "conns_closed", "goodbyes_sent",
                                     "undeliverable_total")})
            return snap

    def close(self) -> dict:
        """drain() + mark closed. Idempotent. Never touches the
        engine — callers own ``engine.close()`` ordering."""
        with self._life:
            snap = self.drain()
            self._closed = True
            return snap

    def drain_replica(self, rep: int, timeout_s: float = 60.0) -> dict:
        """Drain ONE replica for a rolling restart: its pump thread
        stops popping the shared inbox, finishes or sheds its queued
        work through the normal engine verdicts (deadlines still
        honored), routes the final results, then PARKS — peers keep
        serving throughout. Refuses to drain the last live replica
        (that is :meth:`drain`'s job, with the GOODBYE protocol).
        Returns the replica's parked-state snapshot; the engine itself
        is NOT closed — :meth:`ReplicaFleet.restart_replica` owns
        that ordering."""
        if not 0 <= rep < self._n_rep:
            raise ValueError(f"replica {rep} out of range "
                             f"(0..{self._n_rep - 1})")
        with self._life:
            if self._draining:
                raise RuntimeError(
                    "server is draining; per-replica drain is moot")
            live = [i for i in range(self._n_rep)
                    if i != rep and not self._rep_draining[i]]
            if not live:
                raise RuntimeError(
                    f"refusing to drain replica {rep}: it is the last "
                    f"live replica (use drain() to stop serving)")
            with self._rep_lock:
                already = self._rep_draining[rep]
                self._rep_draining[rep] = True
                if not already:
                    self._rep_parked[rep] = False
            self._obs.event("drain_replica", phase="begin", replica=rep,
                            queued=self._eng(rep).scheduler.queue_depth)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline and not self._rep_parked[rep]:
            time.sleep(0.005)
        self._obs.event("drain_replica", phase="end", replica=rep,
                        parked=self._rep_parked[rep])
        return {"replica": rep, "parked": self._rep_parked[rep],
                "verdicts": dict(self._rep_verdicts[rep])}

    def resume_replica(self, rep: int) -> None:
        """Put a drained (or restarted) replica back in rotation — its
        pump thread resumes popping on the very next iteration."""
        if not 0 <= rep < self._n_rep:
            raise ValueError(f"replica {rep} out of range "
                             f"(0..{self._n_rep - 1})")
        with self._life:
            with self._rep_lock:
                self._rep_draining[rep] = False
                self._rep_parked[rep] = False
        self._obs.event("resume_replica", replica=rep)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # --------------------------------------------------------- telemetry
    def net_snapshot(self) -> dict:
        with self._conns_lock:
            open_conns = len(self._conns)
        return {**self._stats.snapshot(), "open_connections": open_conns,
                "listen": f"{self.host}:{self.port}",
                "draining": self._draining,
                "replicas": self._n_rep}

    def replica_snapshot(self) -> list:
        """Per-replica routing state, one dict per replica. Kept OUT
        of :meth:`net_snapshot`, which stays a flat dict; the per-replica
        verdict counters here sum exactly to the global
        ``verdicts`` (both counted at enqueue, under their locks)."""
        out = []
        with self._rep_lock:
            verdicts = [dict(v) for v in self._rep_verdicts]
        for i in range(self._n_rep):
            eng = self._eng(i)
            out.append({
                "replica": i,
                "queue_rows": eng.scheduler.queue_rows,
                "queue_depth": eng.scheduler.queue_depth,
                "inflight_tickets": len(self._tickets[i]),
                "draining": self._rep_draining[i],
                "parked": self._rep_parked[i],
                "verdicts": verdicts[i],
            })
        return out

    def net_families(self) -> list:
        """OpenMetrics families the engine's /metrics render appends —
        the front door's counters ride the SAME exposition as the
        engine's (one scrape, one truth)."""
        s = self.net_snapshot()
        return [
            om.counter("serving_net_connections_opened",
                       "front-door connections accepted",
                       s["conns_opened"]),
            om.counter("serving_net_connections_closed",
                       "front-door connections fully closed",
                       s["conns_closed"]),
            om.counter("serving_net_connections_killed",
                       "connections the server killed (read/write "
                       "timeout, protocol error, slow-reader outbox "
                       "bound)", s["conns_killed"]),
            om.counter("serving_net_accept_drops",
                       "connections dropped at accept (net_accept "
                       "fault seam / drain refusals)",
                       s["accept_drops"]),
            om.counter("serving_net_frames_accepted",
                       "REQUEST frames successfully parsed (each "
                       "terminates in exactly one wire verdict)",
                       s["frames_accepted"]),
            om.counter("serving_net_protocol_errors",
                       "malformed frames (ERROR frame sent, only the "
                       "offending connection closed)",
                       s["protocol_errors"]),
            om.metric("serving_net_verdicts", "counter",
                      "wire verdicts by class (counted at enqueue)",
                      [("_total", {"verdict": v}, c)
                       for v, c in sorted(s["verdicts"].items())]),
            om.counter("serving_net_verdicts_undeliverable",
                       "verdicts that could not be delivered (dead or "
                       "slow peer)", s["undeliverable_total"]),
            om.gauge("serving_net_open_connections",
                     "currently open front-door connections",
                     [({}, s["open_connections"])]),
            *self._replica_families(),
        ]

    def _replica_families(self) -> list:
        """serving_replica_* families — one labeled sample per
        replica, present even at one replica (rep="0") so dashboards
        need no schema switch when a fleet appears."""
        reps = self.replica_snapshot()
        return [
            om.gauge("serving_replica_queue_rows",
                     "queued rows on each replica's scheduler (the "
                     "admission/routing signal)",
                     [({"rep": str(r["replica"])}, r["queue_rows"])
                      for r in reps]),
            om.gauge("serving_replica_queue_depth",
                     "queued requests on each replica's scheduler",
                     [({"rep": str(r["replica"])}, r["queue_depth"])
                      for r in reps]),
            om.gauge("serving_replica_inflight_tickets",
                     "wire tickets submitted to a replica and not yet "
                     "routed back", [({"rep": str(r["replica"])},
                                      r["inflight_tickets"])
                                     for r in reps]),
            om.gauge("serving_replica_draining",
                     "1 while the replica is draining for a rolling "
                     "restart (2 once parked)",
                     [({"rep": str(r["replica"])},
                       (2 if r["parked"] else 1) if r["draining"] else 0)
                      for r in reps]),
            om.metric("serving_replica_verdicts", "counter",
                      "wire verdicts by replica and class (sums to "
                      "serving_net_verdicts)",
                      [("_total", {"rep": str(r["replica"]),
                                   "verdict": v}, c)
                       for r in reps
                       for v, c in sorted(r["verdicts"].items())]),
        ]
