"""Wire protocol of the network front door (counterpart of
dpsvm_tpu/serving/wire.py, byte for byte: either package's client
speaks to either package's server).

Length-prefixed binary frames over a persistent TCP connection —
stdlib ``struct`` + raw sockets. No device is touched here.

Frame layout (network byte order throughout)::

    header   !2sBBI   magic b"DS", version (1), frame type, payload len
    REQUEST  !IBdH    req_id, flags, deadline budget ms (f64), name len
             name utf-8
             !II      rows, cols
             rows*cols big-endian f32
    VERDICT  !IBIdIH  req_id, verdict code, retry_after_ms,
                      latency_ms (f64), model version, name len
             name utf-8
             !BI      payload kind (0 none / 1 labels / 2 decision),
                      message len
             message utf-8
             kind 1:  !I n            then n   big-endian i32 labels
             kind 2:  !II n, k        then n*k big-endian f32 columns
    ERROR    !IH      req_id (0 = not attributable), message len
             message utf-8 — a protocol violation; the connection
             closes right after this frame.
    GOODBYE  !H       message len; message utf-8 — graceful drain:
                      every verdict for this connection has already
                      been flushed ahead of this frame; anything the
                      client still considers outstanding after GOODBYE
                      was never admitted (treat as rejected-by-drain,
                      safe to retry against a live server).
    HELLO    (empty)  server banner, first frame on every ACCEPTED
                      connection — EOF before HELLO means the server
                      dropped the connection at accept (nothing was
                      processed; a connect-class retry is safe).

THE CLOCK CONTRACT: deadlines cross the wire as the client's REMAINING
BUDGET in milliseconds — a duration, never a wall-clock timestamp — so
client/server clock skew cannot move a deadline. The server anchors
the budget to its OWN monotonic clock at frame-parse time (the
admitted request's deadline is ``server_now + budget``). A negative
budget means "use the server's configured default"; the scheduler
treats 0 as already due at the next batch forming.

THE VERDICT CONTRACT: every REQUEST frame the server successfully
parses terminates in EXACTLY ONE of the five verdict codes below (or
the connection receives an ERROR frame when the stream itself is
unparseable, after which the connection dies). ``served``/``late``
carry decision payloads; ``expired``/``rejected``/``failed`` never do.
``rejected`` carries a ``retry_after_ms`` hint and is the ONLY verdict
the client library retries (plus connect-level failures): ``failed``
and ``expired`` must never be retried blindly — the server may have
spent real compute on them, and a retry would duplicate it.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional

import numpy as np

MAGIC = b"DS"
VERSION = 1

T_REQUEST = 1
T_VERDICT = 2
T_ERROR = 3
T_GOODBYE = 4
#: server -> client banner, sent immediately after accept. Its role is
#: accounting, not greeting: a TCP handshake completes in the LISTEN
#: BACKLOG before the server ever sees the connection, so a client
#: cannot otherwise distinguish "dropped at accept" (server did
#: nothing — safe to retry) from "dropped mid-flight" (request may be
#: in flight — never retried). The client treats EOF-before-HELLO as a
#: connect-class failure.
T_HELLO = 5

#: wire verdict codes. Engine verdict "ok" maps to wire "served"; the
#: other engine verdicts keep their names. "rejected" exists only on
#: the wire (admission control / drain — the engine never sees the
#: request).
VERDICTS = ("served", "late", "expired", "rejected", "failed")
_CODE = {name: i for i, name in enumerate(VERDICTS)}

PAYLOAD_NONE = 0
PAYLOAD_LABELS = 1
PAYLOAD_DECISION = 2

_HEADER = struct.Struct("!2sBBI")
_REQ_HEAD = struct.Struct("!IBdH")
_REQ_SHAPE = struct.Struct("!II")
_VER_HEAD = struct.Struct("!IBIdIH")
_VER_BODY = struct.Struct("!BI")
_ERR_HEAD = struct.Struct("!IH")
_GOODBYE_HEAD = struct.Struct("!H")

HEADER_BYTES = _HEADER.size

#: REQUEST flag bits.
FLAG_WANT_DECISION = 0x01  # verdict carries f32 decision columns, not labels


class WireError(ValueError):
    """A malformed frame (bad magic/version/type, inconsistent
    lengths). The server answers with an ERROR frame and kills ONLY
    the offending connection."""


class ConnectionClosed(ConnectionError):
    """The peer closed the connection. ``mid_frame`` distinguishes a
    clean close at a frame boundary from a truncated frame."""

    def __init__(self, msg: str, mid_frame: bool = False):
        super().__init__(msg)
        self.mid_frame = mid_frame


@dataclasses.dataclass
class Request:
    """One parsed REQUEST frame."""

    req_id: int
    model: Optional[str]  # None = "" on the wire: the single-model default
    budget_ms: Optional[float]  # None = use the server default deadline
    rows: np.ndarray  # (n, d) float32
    want_decision: bool


@dataclasses.dataclass
class Verdict:
    """One parsed VERDICT frame (the client-side view)."""

    req_id: int
    verdict: str
    model: str
    version: int
    latency_ms: float
    retry_after_ms: int
    message: str
    labels: Optional[np.ndarray]
    decision: Optional[np.ndarray]

    @property
    def ok(self) -> bool:
        return self.verdict == "served"


# --------------------------------------------------------------- framing

def pack_frame(ftype: int, payload: bytes) -> bytes:
    return _HEADER.pack(MAGIC, VERSION, ftype, len(payload)) + payload


def parse_header(raw: bytes, max_payload: int) -> tuple:
    """(frame type, payload length); raises WireError on garbage — the
    oversized-length check runs HERE, before any allocation, so a
    hostile length prefix can never balloon server memory."""
    magic, version, ftype, length = _HEADER.unpack(raw)
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r} (want {MAGIC!r})")
    if version != VERSION:
        raise WireError(f"unsupported protocol version {version} "
                        f"(this build speaks {VERSION})")
    if ftype not in (T_REQUEST, T_VERDICT, T_ERROR, T_GOODBYE,
                     T_HELLO):
        raise WireError(f"unknown frame type {ftype}")
    if length > max_payload:
        raise WireError(f"frame payload {length} bytes exceeds the "
                        f"{max_payload}-byte bound")
    return ftype, length


def recv_exact(sock, n: int) -> bytes:
    """Read exactly `n` bytes; EOF raises ConnectionClosed (mid_frame
    when any bytes had already arrived — a truncated frame, not a
    clean goodbye). The socket's timeout bounds each recv."""
    parts = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise ConnectionClosed(
                f"peer closed after {got}/{n} bytes", mid_frame=got > 0)
        parts.append(chunk)
        got += len(chunk)
    return b"".join(parts)


# --------------------------------------------------------------- REQUEST

def pack_request(req_id: int, rows: np.ndarray, model: Optional[str],
                 budget_ms: Optional[float],
                 want_decision: bool = False) -> bytes:
    q = np.ascontiguousarray(rows, np.dtype(">f4"))
    if q.ndim != 2:
        raise ValueError(f"rows must be 2-D, got shape {q.shape}")
    name = (model or "").encode("utf-8")
    flags = FLAG_WANT_DECISION if want_decision else 0
    payload = (_REQ_HEAD.pack(int(req_id), flags,
                              -1.0 if budget_ms is None
                              else float(budget_ms), len(name))
               + name + _REQ_SHAPE.pack(*q.shape) + q.tobytes())
    return pack_frame(T_REQUEST, payload)


def parse_request(payload: bytes) -> Request:
    if len(payload) < _REQ_HEAD.size:
        raise WireError("REQUEST payload shorter than its fixed header")
    req_id, flags, budget_ms, name_len = _REQ_HEAD.unpack_from(payload)
    off = _REQ_HEAD.size
    if len(payload) < off + name_len + _REQ_SHAPE.size:
        raise WireError("REQUEST payload truncated inside the name")
    try:
        name = payload[off:off + name_len].decode("utf-8")
    except UnicodeDecodeError as e:
        # Still a WIRE error: anything a hostile payload can contain
        # must surface as the one refusal type the containment
        # handles, never escape the reader's protocol-error path.
        raise WireError(f"REQUEST model name is not UTF-8: {e}") from e
    off += name_len
    rows, cols = _REQ_SHAPE.unpack_from(payload, off)
    off += _REQ_SHAPE.size
    want = rows * cols * 4
    if len(payload) - off != want:
        raise WireError(
            f"REQUEST declares {rows}x{cols} f32 rows ({want} bytes) "
            f"but carries {len(payload) - off}")
    data = np.frombuffer(payload, np.dtype(">f4"), count=rows * cols,
                         offset=off).reshape(rows, cols)
    return Request(req_id=req_id, model=name or None,
                   budget_ms=None if budget_ms < 0 else budget_ms,
                   rows=data.astype(np.float32),
                   want_decision=bool(flags & FLAG_WANT_DECISION))


# --------------------------------------------------------------- VERDICT

def pack_verdict(req_id: int, verdict: str, model: str = "",
                 version: int = 0, latency_ms: float = 0.0,
                 retry_after_ms: int = 0, message: str = "",
                 labels: Optional[np.ndarray] = None,
                 decision: Optional[np.ndarray] = None) -> bytes:
    name = model.encode("utf-8")
    msg = message.encode("utf-8")
    head = _VER_HEAD.pack(int(req_id), _CODE[verdict],
                          int(retry_after_ms), float(latency_ms),
                          int(version), len(name)) + name
    if labels is not None:
        lab = np.ascontiguousarray(labels, np.dtype(">i4"))
        body = (_VER_BODY.pack(PAYLOAD_LABELS, len(msg)) + msg
                + struct.pack("!I", lab.shape[0]) + lab.tobytes())
    elif decision is not None:
        dec = np.ascontiguousarray(decision, np.dtype(">f4"))
        body = (_VER_BODY.pack(PAYLOAD_DECISION, len(msg)) + msg
                + struct.pack("!II", *dec.shape) + dec.tobytes())
    else:
        body = _VER_BODY.pack(PAYLOAD_NONE, len(msg)) + msg
    return pack_frame(T_VERDICT, head + body)


def parse_verdict(payload: bytes) -> Verdict:
    # A malformed verdict payload — short struct, bad UTF-8, declared
    # counts past the buffer — must surface as WireError (the client
    # maps it to ProtocolError and closes), never a raw struct/codec
    # exception escaping the documented error hierarchy.
    try:
        if len(payload) < _VER_HEAD.size:
            raise WireError(
                "VERDICT payload shorter than its fixed header")
        (req_id, code, retry_ms, latency_ms, version,
         name_len) = _VER_HEAD.unpack_from(payload)
        if code >= len(VERDICTS):
            raise WireError(f"unknown verdict code {code}")
        off = _VER_HEAD.size
        name = payload[off:off + name_len].decode("utf-8")
        off += name_len
        kind, msg_len = _VER_BODY.unpack_from(payload, off)
        off += _VER_BODY.size
        msg = payload[off:off + msg_len].decode("utf-8")
        off += msg_len
        labels = decision = None
        if kind == PAYLOAD_LABELS:
            (n,) = struct.unpack_from("!I", payload, off)
            off += 4
            labels = np.frombuffer(payload, np.dtype(">i4"), count=n,
                                   offset=off).astype(np.int32)
        elif kind == PAYLOAD_DECISION:
            n, k = struct.unpack_from("!II", payload, off)
            off += 8
            decision = np.frombuffer(payload, np.dtype(">f4"),
                                     count=n * k,
                                     offset=off).reshape(n, k).astype(
                                         np.float32)
        elif kind != PAYLOAD_NONE:
            raise WireError(f"unknown verdict payload kind {kind}")
    except WireError:
        raise
    except (struct.error, UnicodeDecodeError, ValueError) as e:
        raise WireError(f"malformed VERDICT payload: "
                        f"{type(e).__name__}: {e}") from e
    return Verdict(req_id=req_id, verdict=VERDICTS[code], model=name,
                   version=version, latency_ms=latency_ms,
                   retry_after_ms=retry_ms, message=msg, labels=labels,
                   decision=decision)


# ---------------------------------------------------------- ERROR/GOODBYE

def pack_error(req_id: int, message: str) -> bytes:
    msg = message.encode("utf-8")[:512]
    return pack_frame(T_ERROR, _ERR_HEAD.pack(int(req_id), len(msg))
                      + msg)


def parse_error(payload: bytes) -> tuple:
    req_id, msg_len = _ERR_HEAD.unpack_from(payload)
    off = _ERR_HEAD.size
    return req_id, payload[off:off + msg_len].decode("utf-8")


def pack_goodbye(message: str = "") -> bytes:
    msg = message.encode("utf-8")[:512]
    return pack_frame(T_GOODBYE, _GOODBYE_HEAD.pack(len(msg)) + msg)


def pack_hello() -> bytes:
    return pack_frame(T_HELLO, b"")


def parse_goodbye(payload: bytes) -> str:
    (msg_len,) = _GOODBYE_HEAD.unpack_from(payload)
    return payload[_GOODBYE_HEAD.size:
                   _GOODBYE_HEAD.size + msg_len].decode("utf-8")
