"""The observability spine (counterpart of dpsvm_tpu/obs).

* :mod:`~dpsvm_tpu_torch.obs.trace`      spans and trace sessions (a host
  timeline; a ``torch.profiler`` trace with named spans and NVTX ranges
  when a trace directory is given; under any running profiler the spans
  are its annotations too; the process's span table, ``span_totals``,
  with the device spans' stream times);
* :mod:`~dpsvm_tpu_torch.obs.metrics`    bounded counters, gauges and
  histograms (a run's instruments and the serving engines' always-on
  ones);
* :mod:`~dpsvm_tpu_torch.obs.runlog`     schema-versioned JSONL run logs
  (manifest / chunk / event / span / compile / final records), the JAX
  package's schema: either package reads the other's files;
* :mod:`~dpsvm_tpu_torch.obs.compilelog` the kernel builds and CUDA-graph
  captures made while a run is live;
* :mod:`~dpsvm_tpu_torch.obs.analyze`    ``obs report | diff | tail``;
* :mod:`~dpsvm_tpu_torch.obs.export`     the OpenMetrics endpoint.

THE CONTRACT: observation reads only values the host already holds
(chunk-boundary scalars it read anyway, host clocks) and never issues a
kernel launch, copy or synchronisation of its own inside a solve; a
device span (``span(name, device=dev)`` on a CUDA device) adds two
CUDA event records, which are resolved only when ``span_totals()`` is
read. An observed solve runs the same launches, chunk cadence and host
reads as an unobserved one, and its result is bitwise the same
(tests/test_torch_obs.py, tests/test_torch_spans.py). Off, the default
(no obs and no profiler recording), every entry here is a no-op:
``run_obs`` returns the shared :data:`NULL_OBS` and ``span`` the shared
null context, with no clock read, allocation or event.

Enablement: ``config.obs.enabled`` (SVMConfig / ServeConfig), the CLI's
``--obs``, or ``DPSVM_OBS=1``. ``DPSVM_OBS_DIR`` overrides the run-log
directory, ``DPSVM_TRACE_DIR`` the trace directory.

The solver-facing surface is :func:`run_obs`: every host loop calls it
once per solve or server and gets either :data:`NULL_OBS` or a live
:class:`RunObs` that owns a run log, a trace session and the registry
instruments: ``chunk()`` / ``event()`` / ``finish()`` / ``span()``.
"""

from __future__ import annotations

import os
import time
import weakref
from typing import Optional

from dpsvm_tpu_torch.obs import compilelog, metrics, runlog, trace
from dpsvm_tpu_torch.obs.metrics import Registry, enable, get_registry
from dpsvm_tpu_torch.obs.runlog import SCHEMA_VERSION, RunLog, read_runlog
from dpsvm_tpu_torch.obs.trace import TraceSession, span

__all__ = [
    "compilelog", "metrics", "runlog", "trace", "Registry", "RunLog",
    "TraceSession", "SCHEMA_VERSION", "enable", "get_registry",
    "read_runlog", "span", "obs_enabled", "run_obs", "RunObs", "NULL_OBS",
]


def obs_enabled(obs_config=None) -> bool:
    """Effective on/off: an enabled config, else ``DPSVM_OBS=1``."""
    if obs_config is not None and getattr(obs_config, "enabled", False):
        return True
    return os.environ.get("DPSVM_OBS", "") not in ("", "0")


def _trace_dir(obs_config=None) -> Optional[str]:
    if obs_config is not None and getattr(obs_config, "trace_dir", None):
        return obs_config.trace_dir
    return os.environ.get("DPSVM_TRACE_DIR") or None


class _NullObs:
    """Disabled-mode run handle: every method is a no-op; ``span`` is the
    shared null context unless an outer session is live or a profiler
    records. One shared instance."""

    __slots__ = ()
    run_id = None
    live = False

    def chunk(self, **fields) -> None:
        pass

    def event(self, name: str, **fields) -> None:
        pass

    def finish(self, **fields) -> None:
        pass

    def span(self, name: str, shape: Optional[str] = None):
        return trace.span(name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_OBS = _NullObs()


class _LabeledSpan:
    """A RunObs span: the trace span plus a build-attribution label, so a
    kernel built inside this dispatch yields a ``compile`` record naming
    the span (obs/compilelog.py)."""

    __slots__ = ("_span", "_label")

    def __init__(self, name: str, shape):
        self._span = trace.span(name)
        self._label = compilelog.label(name, shape)

    def __enter__(self):
        self._label.__enter__()
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        self._span.__exit__(*exc)
        self._label.__exit__(*exc)
        return False


def _shape_signature(meta) -> Optional[str]:
    """A shape signature from a run's manifest meta, for compile records
    whose label gives none."""
    if not meta:
        return None
    keys = ("n", "n_pad", "d", "k", "n_union", "n_devices", "buckets")
    parts = [f"{k}={meta[k]}" for k in keys if k in meta]
    return " ".join(parts) or None


def _uses_cuda(device) -> bool:
    """Whether a run on `device` traces CUDA activity: resolves the
    device as every entry point does (None is the card, and raises
    without one)."""
    from dpsvm_tpu_torch.device import resolve_device

    if isinstance(device, (list, tuple)):  # a mesh's devices
        device = device[0]
    return resolve_device(device).type == "cuda"


class RunObs:
    """Live per-run observability: a RunLog (manifest written at
    construction), a TraceSession whose span records sink into the same
    JSONL, and a private registry the chunk records feed. Every record
    field comes from host-held values the caller passes; this class
    never touches a device tensor."""

    live = True

    def __init__(self, tool: str, config=None, meta=None, obs_config=None,
                 directory: Optional[str] = None, device=None):
        tdir = _trace_dir(obs_config)
        # A device trace records the run's device: resolved first, so a
        # run asking for a trace of the card raises without one.
        cuda = _uses_cuda(device) if tdir else False
        self._log = RunLog.open(tool, config=config, meta=meta,
                                obs_config=obs_config, directory=directory)
        self.run_id = self._log.run_id
        self._session = TraceSession(trace_dir=tdir,
                                     sink=self._log.span_sink, cuda=cuda)
        self._session.__enter__()
        # A private registry: two runs in one process never sum into
        # each other.
        self.registry = Registry()
        self._pairs = self.registry.counter(f"{tool}.pairs_total")
        self._dispatches = self.registry.counter(f"{tool}.dispatches_total")
        self._compiles = self.registry.counter(f"{tool}.compiles_total")
        self._last_pairs = None
        self._finished = False
        self._t0 = time.perf_counter()
        self._sig = _shape_signature(meta)
        # The build sink holds the run WEAKLY: a strong reference from
        # the global sink list would keep a faulted run alive and defeat
        # the __del__ path that closes it (the fault-retry contract).
        ref = weakref.ref(self)

        def _sink(entrypoint, shape, seconds, _ref=ref):
            run = _ref()
            if run is not None:
                run._on_compile(entrypoint, shape, seconds)

        self._compile_sink = _sink
        compilelog.add_sink(self._compile_sink)

    def _on_compile(self, entrypoint: str, shape, seconds: float):
        self._compiles.add(1)
        self._log.record("compile", entrypoint=entrypoint,
                         shape=shape or self._sig,
                         seconds=round(seconds, 6))

    def chunk(self, pairs: int, b_hi: float, b_lo: float,
              device_seconds: float, dispatch: int, **fields) -> None:
        """One host observation of device progress. ``pairs`` is the
        run-cumulative count the host just read; the delta against the
        previous observation is derived here, so readers sum deltas."""
        delta = pairs - (self._last_pairs
                         if self._last_pairs is not None else 0)
        self._last_pairs = pairs
        self._pairs.add(max(delta, 0))
        self._dispatches.add(1)
        self._log.record("chunk", pairs=int(pairs), pairs_delta=int(delta),
                         b_hi=float(b_hi), b_lo=float(b_lo),
                         gap=float(b_lo - b_hi),
                         device_seconds=round(float(device_seconds), 6),
                         dispatch=int(dispatch), **fields)

    def event(self, name: str, **fields) -> None:
        self._log.record("event", name=name, **fields)

    def finish(self, **fields) -> None:
        if self._finished:
            return
        self._finished = True
        compilelog.remove_sink(self._compile_sink)
        self._session.__exit__(None, None, None)
        if self._session.trace_path:
            fields.setdefault("trace_path", self._session.trace_path)
        self._log.finish(wall_seconds=round(time.perf_counter() - self._t0,
                                            6),
                         metrics=self.registry.snapshot(), **fields)

    def __del__(self):
        # A solve that faults mid-loop (the fault-retry path) never
        # reaches finish(); when the handler releases its frames this
        # closes the run log aborted and leaves the trace stack, so later
        # runs do not feed a dead session. Best effort at shutdown.
        try:
            self.finish(aborted=True)
        except Exception:
            pass

    def span(self, name: str, shape: Optional[str] = None):
        return _LabeledSpan(name, shape or self._sig)

    @property
    def path(self) -> str:
        return self._log.path

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()
        return False


def run_obs(tool: str, config=None, meta=None, directory=None, device=None):
    """The solver and tool entry point: NULL_OBS when observability is
    off (the strict zero-overhead default), else a live RunObs.
    `config` may be an SVMConfig / ServeConfig (its ``obs`` field is
    consulted and its snapshot lands in the manifest), any dataclass, or
    None. `device` is the run's device (a mesh passes its devices): a
    trace directory records its CUDA activity, and with device None (the
    card) it raises where there is no card, as every entry point does.

    Enabling obs never changes solver control flow: chunk cadence,
    launches and host reads are identical with obs on and off (records
    ride the observations the host was already making)."""
    ocfg = getattr(config, "obs", None)
    if not obs_enabled(ocfg):
        return NULL_OBS
    return RunObs(tool, config=config, meta=meta, obs_config=ocfg,
                  directory=directory, device=device)
