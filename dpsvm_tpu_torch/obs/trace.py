"""The span primitive of the JAX package's dpsvm_tpu/obs/trace.py.

``span(name)`` names a host stage of work (a serve bucket dispatch).
The port has no trace session yet (ROADMAP queue A item 11), so a span
is always the shared no-op context: no allocation, no clock read.
"""

from __future__ import annotations


class _NullSpan:
    """The shared disabled span: a no-op context manager."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def span(name: str) -> _NullSpan:
    """A named span; the shared no-op while no trace session is live."""
    return _NULL_SPAN
