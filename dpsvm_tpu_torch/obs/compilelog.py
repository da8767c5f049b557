"""Build accounting (counterpart of dpsvm_tpu/obs/compilelog.py): make the
port's one-time builds visible.

Eager torch builds no executable per shape, so the JAX package's
compile events (XLA backend compiles) have no counterpart here. The
builds the port does pay for at run time are

* the CUDA sources' first-use ``nvcc`` builds and loads
  (ops/_build.py ``load``, entrypoint ``build/<name>``), and
* the CUDA-graph captures (solver/fleet.py ``FleetGraph``, 256 trips,
  entrypoint ``graph/fleet``).

Each is reported through :func:`record` and becomes

* a process-level counter (:func:`compiles_total`), which the serving
  /metrics endpoint exports as ``serve_compiles``, and their seconds
  (:func:`compile_seconds_total`), and
* a ``compile`` run-log record ``{entrypoint, shape, seconds}`` in every
  registered sink (obs/__init__.py RunObs registers one while a run is
  live), with ``shape`` taken from the innermost active :func:`label`
  (the span of the dispatch that triggered the build, e.g.
  ``solver/chunk``) when the reporter gives none.

A cached build (the library was built by an earlier process, or this
one) still counts its load: the count is of builds and loads this
process made, not of nvcc runs. Everything here is host bookkeeping;
nothing launches on the device.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

_compiles = 0
_seconds = 0.0
# (entrypoint, shape) labels, innermost last. Builds happen on the
# thread that first launches a kernel; a plain list under the GIL is
# enough.
_labels: List[Tuple[str, Optional[str]]] = []
_sinks: List[Callable] = []


def record(entrypoint: str, seconds: float,
           shape: Optional[str] = None) -> None:
    """Count one build (or capture) of `seconds` and hand it to every
    sink as (entrypoint, shape, seconds). The innermost label names the
    dispatch that triggered it: its name leads the entrypoint, and its
    shape stands in when the reporter has none."""
    global _compiles, _seconds
    _compiles += 1
    _seconds += float(seconds)
    if not _sinks:
        return
    if _labels:
        name, lshape = _labels[-1]
        entrypoint = f"{name}:{entrypoint}"
        shape = shape or lshape
    for sink in list(_sinks):
        try:
            sink(entrypoint, shape, float(seconds))
        except Exception:
            # An observer must never break the build that fed it.
            pass


def compiles_total() -> int:
    """Builds and graph captures recorded in this process."""
    return _compiles


def compile_seconds_total() -> float:
    """The seconds of the builds and captures compiles_total counts,
    rounded to the microsecond as the JAX package rounds its compile
    seconds."""
    return round(_seconds, 6)


def add_sink(sink: Callable) -> None:
    """Register ``sink(entrypoint, shape, seconds)`` for future builds."""
    if sink not in _sinks:
        _sinks.append(sink)


def remove_sink(sink: Callable) -> None:
    if sink in _sinks:
        _sinks.remove(sink)


class label:
    """Context manager naming the entrypoint (and optionally its shape
    signature) for any build fired inside it. Nested labels attribute
    to the innermost, as trace spans do."""

    __slots__ = ("_entry",)

    def __init__(self, entrypoint: str, shape: Optional[str] = None):
        self._entry = (entrypoint, shape)

    def __enter__(self):
        _labels.append(self._entry)
        return self

    def __exit__(self, *exc):
        # Remove THIS entry even when a sibling exits out of order.
        for i in range(len(_labels) - 1, -1, -1):
            if _labels[i] is self._entry:
                del _labels[i]
                break
        return False
