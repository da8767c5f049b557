"""Spans and trace sessions (counterpart of dpsvm_tpu/obs/trace.py).

One primitive, ``span(name)``, names a host-driven stage of work: a
solver chunk dispatch, an out-of-core round, a serve bucket dispatch.
With no live :class:`TraceSession`, ``span()`` returns one shared no-op
context manager: no allocation, no clock read. With a live session the
span is a host-timeline record ``(name, t, dur)`` of the INNERMOST
session live when the span was created, handed to the session's sink
(normally its run log, obs/runlog.py) or kept in memory, bounded at
``_MAX_EVENTS`` with the overflow counted.

A session given a ``trace_dir`` also owns a ``torch.profiler`` trace
(CPU activity, and CUDA activity on the card), exported as a Chrome
trace ``trace-<pid>-<k>.json`` into the directory when the session
closes; only the first such session of the process owns one. While it
runs, every span also enters ``torch.profiler.record_function`` and, on
the card, an NVTX range, so the span's name brackets the kernels it
launched in the trace. The CPU build of torch has no NVTX: there the
spans are host-only records plus their profiler annotations.

Spans never touch the device: they bracket host code around launches
already issued, so they add no launch, copy or synchronisation.

Span names are ``area/stage``: ``solver/chunk``, ``solver/ooc_round``,
``solver/ooc_setup_stream``, ``serve/bucket1024``, ...
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Callable, Optional

# Events kept in memory per session before further ones are dropped (a
# long-lived server must not grow a list per dispatch forever). Drops
# are counted, never silent.
_MAX_EVENTS = 65536

# Live sessions, innermost last.
_STACK: list = []
_TRACE_SEQ = itertools.count(1)


class _NullSpan:
    """The shared disabled span: a no-op context manager."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _LiveSpan:
    """One named timed region, bound at creation to the session that was
    innermost then (stable attribution even if another session opens or
    closes while it runs). `annotate` enters the profiler annotation and
    the NVTX range while a device trace is running."""

    __slots__ = ("name", "_t0", "_rf", "_nvtx", "_sess")

    def __init__(self, name: str, session, rf, nvtx: bool):
        self.name = name
        self._sess = session
        self._rf = rf
        self._nvtx = nvtx

    def __enter__(self):
        if self._rf is not None:
            self._rf.__enter__()
        if self._nvtx:
            import torch

            torch.cuda.nvtx.range_push(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        if self._nvtx:
            import torch

            torch.cuda.nvtx.range_pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self._sess._emit(self.name, self._t0, dur)
        return False


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


def span(name: str):
    """Named span bound to the innermost live session; the shared no-op
    when none is live."""
    if not _STACK:
        return _NULL_SPAN
    owner = next((s for s in _STACK if s._device_trace), None)
    rf = None
    nvtx = False
    if owner is not None:
        import torch

        rf = torch.profiler.record_function(name)
        nvtx = owner.cuda
    return _LiveSpan(name, _STACK[-1], rf, nvtx)


def active_session() -> Optional[TraceSession]:
    """The innermost live session (None when tracing is off)."""
    return _STACK[-1] if _STACK else None
