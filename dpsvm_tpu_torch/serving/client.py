"""Client library of the network front door (counterpart of
dpsvm_tpu/serving/client.py).

A thin wrapper over :mod:`dpsvm_tpu_torch.serving.wire` (numpy + stdlib
sockets; never any device work): one persistent connection, synchronous request/verdict round
trips, and the ONLY retry policy that cannot duplicate compute:

* CONNECT failures (refused, reset before a full send, accept-dropped)
  retry with exponential backoff + seeded jitter up to
  ``connect_retries`` — the server never saw the request, so a retry
  is free.
* ``rejected`` verdicts retry up to ``reject_retries``, sleeping the
  server's ``retry_after_ms`` hint (never less than the local
  backoff) — the server explicitly promised it did no work.
* ``failed`` and ``expired`` verdicts are returned to the caller
  verbatim and NEVER retried: the server may have spent real compute
  on them, and the failure classes they represent (bad request, blown
  deadline) would not be cured by resending.
* A connection that dies AFTER a full send raises
  :class:`ConnectionDropped` — the request may be mid-flight on the
  server, so the library refuses to guess (the caller owns
  idempotency decisions).

DEADLINES cross the wire as remaining budget: the caller's
``deadline_ms`` is anchored once at the first attempt, and every
retry ships the budget MINUS the time already burned — a request that
exhausts its budget in backoff arrives with ~0 budget and is
explicitly expired by the server, never silently late.

The ``net_conn_drop`` / ``net_partial_write`` / ``net_read_stall``
fault seams (dpsvm_tpu_torch/testing/faults.py) fire HERE, in the client:
the behaviors they model are things the wire does TO the server, so
arming them in the client drives the server's real read/write/
accounting paths.
"""

from __future__ import annotations

import random
import socket
import time
from typing import Optional

import numpy as np

from dpsvm_tpu_torch.serving import wire
from dpsvm_tpu_torch.testing import faults


class ServeClientError(Exception):
    """Base class for front-door client failures."""


class ConnectError(ServeClientError, ConnectionError):
    """Could not establish a connection within the retry budget."""


class SendAborted(ServeClientError, ConnectionError):
    """The request frame was NOT fully sent (the server never accepted
    it) — safe to retry, but counted separately by chaos legs."""


class ConnectionDropped(ServeClientError, ConnectionError):
    """The connection died AFTER a full send, before the verdict: the
    request may be mid-flight server-side. NEVER retried by the
    library (duplicate compute)."""


class ServerDraining(ServeClientError):
    """A GOODBYE frame arrived: the server is draining. Anything still
    outstanding past the GOODBYE was never admitted — safe to retry
    against a live server."""


class ProtocolError(ServeClientError):
    """The server answered with an ERROR frame (we sent something it
    considers malformed) or sent bytes we cannot parse."""


class ServeClient:
    """One persistent front-door connection.

    ``request()`` returns the :class:`dpsvm_tpu_torch.serving.wire.Verdict`
    the server produced (``served``/``late`` carry labels or decision
    columns; ``expired``/``rejected``/``failed`` carry accounting
    only). ``last_attempts`` exposes how many wire attempts the most
    recent request used (the reject-retry tests pin it)."""

    def __init__(self, host: str, port: int, *,
                 timeout_s: float = 30.0, connect_retries: int = 4,
                 reject_retries: int = 4, backoff_s: float = 0.05,
                 max_backoff_s: float = 2.0, seed: int = 0):
        self.host = host
        self.port = int(port)
        self.timeout_s = float(timeout_s)
        self.connect_retries = int(connect_retries)
        self.reject_retries = int(reject_retries)
        self.backoff_s = float(backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self._rng = random.Random(seed)
        self._sock: Optional[socket.socket] = None
        self._next_id = 1
        self.last_attempts = 0
        # Client-side accounting, to reconcile with the server's:
        # frames FULLY sent (the server-side frames_accepted mirror)
        # and every verdict actually observed — including rejected
        # verdicts the retry loop swallows. Exactness contract, per
        # client,
        #   sum(verdicts_observed) + dropped + goodbyed == frames_sent
        # and across clients frames_sent totals the server's
        # frames_accepted.
        self.frames_sent = 0
        self.verdicts_observed = {v: 0 for v in wire.VERDICTS}

    # ---------------------------------------------------------- transport
    def _backoff(self, attempt: int) -> float:
        base = min(self.backoff_s * (2 ** attempt), self.max_backoff_s)
        return base + self._rng.uniform(0.0, base)

    def connect(self) -> None:
        """Establish (or re-establish) the connection, with bounded
        exponential backoff + jitter. Raises ConnectError when the
        budget is exhausted."""
        self.close()
        last = None
        for attempt in range(self.connect_retries + 1):
            try:
                sock = socket.create_connection(
                    (self.host, self.port), timeout=self.timeout_s)
                sock.settimeout(self.timeout_s)
                # Wait for the server's HELLO banner: the TCP
                # handshake alone proves nothing (it completes in the
                # listen backlog) — EOF here means the server dropped
                # us AT ACCEPT, the one drop that is always safe to
                # retry.
                head = wire.recv_exact(sock, wire.HEADER_BYTES)
                ftype, length = wire.parse_header(head, 1 << 20)
                wire.recv_exact(sock, length)
                if ftype != wire.T_HELLO:
                    raise wire.WireError(
                        f"expected HELLO banner, got frame type "
                        f"{ftype}")
                self._sock = sock
                return
            except (OSError, wire.WireError) as e:
                last = e
                try:
                    sock.close()
                except (OSError, UnboundLocalError):
                    pass
                if attempt < self.connect_retries:
                    time.sleep(self._backoff(attempt))
        raise ConnectError(
            f"cannot connect to {self.host}:{self.port} after "
            f"{self.connect_retries + 1} attempts: {last}") from last

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ------------------------------------------------------------ request
    def request(self, rows, model: Optional[str] = None,
                deadline_ms: Optional[float] = None,
                want_decision: bool = False) -> wire.Verdict:
        """One request -> one verdict. Retries connect failures and
        ``rejected`` verdicts only (see module docstring); the
        remaining deadline budget shrinks across retries."""
        q = np.asarray(rows, np.float32)
        t0 = time.monotonic()
        attempts = 0
        while True:
            attempts += 1
            self.last_attempts = attempts
            if self._sock is None:
                self.connect()
            budget = deadline_ms
            if budget is not None:
                budget = max(
                    0.0, budget - (time.monotonic() - t0) * 1e3)
            req_id = self._next_id
            self._next_id += 1
            frame = wire.pack_request(req_id, q, model, budget,
                                      want_decision=want_decision)
            try:
                self._send_frame(frame)
            except SendAborted:
                self.close()
                raise
            except OSError as e:
                # A drain can close the socket mid-send with the
                # GOODBYE already sitting in our receive buffer —
                # surface THAT (an explicit, retry-safe signal), not a
                # drop.
                if self._goodbye_buffered():
                    self.close()
                    raise ServerDraining(
                        "server drained during send") from e
                # Otherwise sendall's failure point is unknowable —
                # part of the frame may have reached the server — so
                # treat it like a post-send drop, never a silent retry.
                self.close()
                raise ConnectionDropped(
                    f"connection died during send: {e}") from e
            self.frames_sent += 1
            # net_conn_drop fault seam: the frame is fully sent, then
            # the connection dies before the verdict is read — the
            # server's verdict becomes undeliverable; accounting must
            # still close.
            if faults.net_conn_drop():
                self.close()
                raise ConnectionDropped(
                    "injected fault at seam 'net_conn_drop' (socket "
                    "closed after send, before the verdict)")
            faults.net_read_stall()  # slow-reader seam: stall, then read
            verdict = self._read_verdict(req_id)
            if verdict.verdict == "rejected" \
                    and attempts <= self.reject_retries:
                hint_s = verdict.retry_after_ms / 1e3
                time.sleep(max(hint_s, self._backoff(attempts - 1)))
                continue
            return verdict

    def _send_frame(self, frame: bytes) -> None:
        # net_partial_write fault seam: HALF the frame goes out, then
        # the socket closes — the server must account a truncated
        # frame and kill only this connection.
        if faults.net_partial_write():
            try:
                self._sock.sendall(frame[:len(frame) // 2])
            except OSError:
                pass
            raise SendAborted(
                "injected fault at seam 'net_partial_write' "
                f"({len(frame) // 2}/{len(frame)} bytes sent)")
        self._sock.sendall(frame)

    def _goodbye_buffered(self) -> bool:
        """After a send failure: scan whatever frames are already in
        the receive buffer for a GOODBYE (drain closed the socket
        under us). Never blocks meaningfully; never counts verdicts
        (nothing is outstanding at send time)."""
        sock = self._sock
        if sock is None:
            return False
        try:
            sock.settimeout(0.05)
            while True:
                head = wire.recv_exact(sock, wire.HEADER_BYTES)
                ftype, length = wire.parse_header(head, 1 << 30)
                wire.recv_exact(sock, length)
                if ftype == wire.T_GOODBYE:
                    return True
        except Exception:
            return False

    def _read_verdict(self, req_id: int) -> wire.Verdict:
        while True:
            try:
                head = wire.recv_exact(self._sock, wire.HEADER_BYTES)
                ftype, length = wire.parse_header(
                    head, max_payload=1 << 30)
                payload = wire.recv_exact(self._sock, length)
            except (wire.ConnectionClosed, socket.timeout, OSError) as e:
                self.close()
                raise ConnectionDropped(
                    f"connection died awaiting verdict: {e}") from e
            except wire.WireError as e:
                self.close()
                raise ProtocolError(f"unparseable server frame: {e}") \
                    from e
            if ftype == wire.T_VERDICT:
                try:
                    v = wire.parse_verdict(payload)
                except wire.WireError as e:
                    self.close()
                    raise ProtocolError(
                        f"malformed verdict frame: {e}") from e
                if v.req_id == req_id:
                    self.verdicts_observed[v.verdict] += 1
                    return v
                continue  # a stale verdict (e.g. pre-drop pipelining)
            if ftype == wire.T_GOODBYE:
                self.close()
                raise ServerDraining(wire.parse_goodbye(payload)
                                     or "server draining")
            if ftype == wire.T_ERROR:
                self.close()
                _, msg = wire.parse_error(payload)
                raise ProtocolError(f"server refused the stream: {msg}")
            self.close()
            raise ProtocolError(f"unexpected frame type {ftype}")

    # ------------------------------------------------------- conveniences
    def predict(self, rows, model: Optional[str] = None,
                deadline_ms: Optional[float] = None) -> np.ndarray:
        """Labels for `rows`, raising on any non-served verdict."""
        v = self.request(rows, model=model, deadline_ms=deadline_ms)
        if v.labels is None:
            raise ServeClientError(
                f"request ended {v.verdict!r}: {v.message}")
        return v.labels

    def decision(self, rows, model: Optional[str] = None,
                 deadline_ms: Optional[float] = None) -> np.ndarray:
        """Decision columns for `rows` (the bitwise rehydrate-proof
        path), raising on any non-served verdict."""
        v = self.request(rows, model=model, deadline_ms=deadline_ms,
                         want_decision=True)
        if v.decision is None:
            raise ServeClientError(
                f"request ended {v.verdict!r}: {v.message}")
        return v.decision
