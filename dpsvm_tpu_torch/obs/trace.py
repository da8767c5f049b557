"""Spans and trace sessions (counterpart of dpsvm_tpu/obs/trace.py).

One primitive, ``span(name)``, names a host-driven stage of work: a
training job, X's upload, a block round's stage, a solver chunk
dispatch, an out-of-core round, a serve bucket dispatch. A span is live
while a :class:`TraceSession` is open or a ``torch.profiler`` is
recording (the caller's own profiler, or a benchmark's); otherwise
``span()`` returns one shared no-op context manager: no allocation, no
clock read, no event.

A live span enters ``torch.profiler.record_function`` while a profiler
records, so its name is a ``user_annotation`` on the same clock as the
kernels and copies it launched, and, on the card, an NVTX range. It
adds its host duration to the process-wide table :func:`span_totals`
reads, keyed by name, and hands the record ``(name, t, dur)`` to the
INNERMOST session live when the span was created: the session's sink
(normally its run log, obs/runlog.py), or its memory, bounded at
``_MAX_EVENTS`` with the overflow counted.

``span(name, device=dev)``, where the body's work runs on the CUDA
device `dev`, also records a pair of CUDA timing events on that
device's current stream around the body; the stream time between them
is the span's device time, resolved when :func:`span_totals` is read
(waiting for the device once, and only then). Pairs not yet resolved
are bounded at ``_MAX_PENDING``, with drops counted by name; completed
pairs are resolved without blocking as the pending list grows. On the
CPU (`dev` a CPU device) there are no events and the device time is
None.

A session given a ``trace_dir`` also owns a ``torch.profiler`` trace
(CPU activity, and CUDA activity on the card), exported as a Chrome
trace ``trace-<pid>-<k>.json`` into the directory when the session
closes; only the first such session of the process owns one. The CPU
build of torch has no NVTX: there the spans are host-only records plus
their profiler annotations.

Spans launch no kernel, copy or synchronisation: they bracket host code
around launches already issued; a device span adds two event records.

Span names are ``area/stage``: ``train``, ``solver/upload``,
``model/assemble``, ``block/select``, ``solver/chunk``,
``solver/ooc_round``, ``serve/bucket1024``, ...
"""

from __future__ import annotations

import collections
import itertools
import os
import threading
import time
from typing import Callable, Optional

import torch

# Events kept in memory per session before further ones are dropped (a
# long-lived server must not grow a list per dispatch forever). Drops
# are counted, never silent.
_MAX_EVENTS = 65536
# Device spans whose event pair is not yet resolved, before further
# pairs are dropped (counted by name); completed pairs are resolved
# without blocking once _DRAIN_AT are pending.
_MAX_PENDING = _MAX_EVENTS
_DRAIN_AT = 1024

# Live sessions, innermost last.
_STACK: list = []
_TRACE_SEQ = itertools.count(1)

# Whether a torch.profiler (or the autograd profiler) is recording: one
# C call, well under a microsecond.
_profiler_enabled = torch._C._autograd._profiler_enabled

# The process-wide span table: name -> [count, host_s, device_s (None
# until a device time lands), dropped event pairs], and the device
# spans' unresolved (name, start, end) event pairs, oldest first.
_LOCK = threading.Lock()
_TOTALS: dict = {}
_PENDING: collections.deque = collections.deque()


class _NullSpan:
    """The shared disabled span: a no-op context manager."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def _timing_event(stream):
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


class _LiveSpan:
    """One named timed region, bound at creation to the session that was
    innermost then (None under a profiler alone; stable attribution even
    if another session opens or closes while it runs). `rf` is the
    profiler annotation, `nvtx` whether to push an NVTX range, `device`
    the CUDA device whose stream an event pair brackets (None: none)."""

    __slots__ = ("name", "_t0", "_rf", "_nvtx", "_sess", "_device",
                 "_stream", "_start")

    def __init__(self, name: str, session, rf, nvtx: bool, device):
        self.name = name
        self._sess = session
        self._rf = rf
        self._nvtx = nvtx
        self._device = device
        self._start = None

    def __enter__(self):
        if self._rf is not None:
            self._rf.__enter__()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        if self._device is not None:
            # Looked up once: on the card it costs about as much as an
            # event record.
            self._stream = torch.cuda.current_stream(self._device)
            self._start = _timing_event(self._stream)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        end = (_timing_event(self._stream) if self._start is not None
               else None)
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _add(self.name, dur, self._start, end)
        if self._sess is not None:
            self._sess._emit(self.name, self._t0, dur)
        return False


def _add(name: str, dur: float, start, end) -> None:
    with _LOCK:
        ent = _TOTALS.get(name)
        if ent is None:
            ent = _TOTALS[name] = [0, 0.0, None, 0]
        ent[0] += 1
        ent[1] += dur
        if start is None:
            return
        if len(_PENDING) >= _DRAIN_AT:
            _drain(block=False)
        if len(_PENDING) >= _MAX_PENDING:
            ent[3] += 1
            return
        _PENDING.append((name, start, end))


def _drain(block: bool) -> None:
    """Resolve pending event pairs, oldest first, into the table: all of
    them (`block`: waiting for the device), or those already complete.
    Called with _LOCK held."""
    while _PENDING:
        name, start, end = _PENDING[0]
        if block:
            end.synchronize()
        elif not end.query():
            return
        _PENDING.popleft()
        ent = _TOTALS[name]
        ent[2] = (ent[2] or 0.0) + 1e-3 * start.elapsed_time(end)


def span_totals() -> dict:
    """The spans since the last reset, by name: ``{"count", "host_s",
    "device_s", "dropped"}``; ``device_s`` is the summed stream time of
    the name's device spans (None where it has none: host-only spans,
    the CPU), ``dropped`` the device spans whose events overflowed
    _MAX_PENDING. Resolving pending event pairs waits for the device
    once."""
    with _LOCK:
        _drain(block=True)
        return {name: {"count": c, "host_s": h, "device_s": d,
                       "dropped": k}
                for name, (c, h, d, k) in _TOTALS.items()}


def reset_span_totals() -> None:
    """Clear the span table and its pending event pairs."""
    with _LOCK:
        _TOTALS.clear()
        _PENDING.clear()


class TraceSession:
    """One tracing window: the host timeline every run gets, plus an
    optional ``torch.profiler`` trace into ``trace_dir`` (`cuda`: record
    CUDA activity too; the caller resolved the device).

    ``sink(record_dict)``, when given, receives each span record as it
    completes; without one the records accumulate in ``self.events``
    (bounded at ``_MAX_EVENTS``; ``self.dropped`` counts the overflow).
    ``self.trace_path`` is the exported Chrome trace, once closed."""

    def __init__(self, trace_dir: Optional[str] = None,
                 sink: Optional[Callable] = None, cuda: bool = False):
        self.trace_dir = trace_dir
        self.sink = sink
        self.cuda = bool(cuda)
        self.events: list = []
        self.dropped = 0
        self.trace_path: Optional[str] = None
        self._prof = None
        self._closed = False

    @property
    def _device_trace(self) -> bool:
        return self._prof is not None

    def __enter__(self):
        _STACK.append(self)
        if self.trace_dir and not any(s._device_trace for s in _STACK
                                      if s is not self):
            try:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU]
                if self.cuda:
                    acts.append(ProfilerActivity.CUDA)
                prof = profile(activities=acts)
                prof.__enter__()
                self._prof = prof
            except Exception:
                # A profiler that cannot start (another one running):
                # the host timeline is the degraded-mode contract.
                self._prof = None
        return self

    def __exit__(self, *exc):
        if self._closed:
            return False
        self._closed = True
        prof, self._prof = self._prof, None
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(self.trace_dir, exist_ok=True)
                path = os.path.join(
                    self.trace_dir,
                    f"trace-{os.getpid()}-{next(_TRACE_SEQ)}.json")
                prof.export_chrome_trace(path)
                self.trace_path = path
            except Exception:
                pass
        if self in _STACK:
            _STACK.remove(self)
        return False

    def _emit(self, name: str, t0: float, dur: float) -> None:
        rec = {"kind": "span", "name": name,
               "t": round(t0, 6), "dur": round(dur, 6)}
        if self.sink is not None:
            self.sink(rec)
            return
        if len(self.events) >= _MAX_EVENTS:
            self.dropped += 1
            return
        self.events.append(rec)


def span(name: str, device=None):
    """Named span, live while a session is open or a profiler records
    (bound to the innermost live session, if any); the shared no-op
    otherwise. `device`: the torch.device the body's work runs on; a
    CUDA device's stream time is also taken, by a CUDA event pair."""
    if not _STACK and not _profiler_enabled():
        return _NULL_SPAN
    rf = None
    nvtx = False
    if _profiler_enabled():
        rf = torch.profiler.record_function(name)
        owner = next((s for s in _STACK if s._device_trace), None)
        nvtx = owner.cuda if owner is not None else \
            torch.cuda.is_initialized()
    if device is not None and device.type != "cuda":
        device = None
    return _LiveSpan(name, _STACK[-1] if _STACK else None, rf, nvtx,
                     device)


def active_session() -> Optional[TraceSession]:
    """The innermost live session (None when tracing is off)."""
    return _STACK[-1] if _STACK else None
