"""Process-local, bounded, lock-free counters, gauges and histograms
(counterpart of dpsvm_tpu/obs/metrics.py).

Each instrument method is a few plain Python operations under the GIL,
with nothing allocated on the hot path (the histogram's ring is
allocated once), so a serving dispatch can observe a latency without
perturbing what it measures. A histogram holds a fixed log2 bin array
and a ring of the most recent ``window`` raw samples: memory is O(bins
+ window) however many observations arrive. ``get_registry`` is the
process-default registry, which ``DPSVM_OBS=1`` enables; disabled, a
registry hands out the shared no-op instrument ``NULL``.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def add(self, v: int = 1) -> None:
        self.value += v

    def snapshot(self):
        return self.value


class Gauge:
    """Last-written value."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = None

    def set(self, v) -> None:
        self.value = v

    def snapshot(self):
        return self.value


class Histogram:
    """Bounded histogram of non-negative samples (latencies, sizes).

    log2 BINS over [2^lo_exp, 2^hi_exp) keep the lifetime shape;
    a RING of the most recent ``window`` samples gives exact percentiles
    of the recent window, the one definition every consumer shares
    (offered_load_sweep, `cli serve --server-bench`, /metrics)."""

    __slots__ = ("name", "window", "count", "total", "vmin", "vmax",
                 "_ring", "_i", "_bins", "_lo_exp", "_hi_exp")

    def __init__(self, name: str, window: int = 4096,
                 lo_exp: int = -20, hi_exp: int = 7):
        # [2^-20 s ~ 1 us, 2^7 s = 128 s); out-of-range samples clamp to
        # the edge bins (counted, never dropped).
        self.name = name
        self.window = int(window)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._ring = np.empty((self.window,), np.float64)
        self._i = 0
        self._lo_exp = lo_exp
        self._hi_exp = hi_exp
        self._bins = np.zeros((hi_exp - lo_exp + 1,), np.int64)

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        self._ring[self._i % self.window] = v
        self._i += 1
        e = int(math.floor(math.log2(v))) if v > 0 else self._lo_exp
        e = min(max(e, self._lo_exp), self._hi_exp)
        self._bins[e - self._lo_exp] += 1

    def __len__(self) -> int:  # recent-window size
        return min(self.count, self.window)

    def window_values(self, last: Optional[int] = None) -> np.ndarray:
        """The most recent min(count, window[, last]) samples in arrival
        order; `last` scopes a shared histogram to one phase's
        observations."""
        m = len(self)
        if last is not None:
            m = min(m, max(int(last), 0))
        idx = (self._i - m + np.arange(m)) % self.window
        return self._ring[idx]

    def percentiles(self, qs=(50, 95, 99),
                    last: Optional[int] = None) -> dict:
        """{"p50": ..., ...} over the recent window (or its last `last`
        samples); {} when empty."""
        v = self.window_values(last)
        if v.size == 0:
            return {}
        return {f"p{q}": round(float(np.percentile(v, q)), 6)
                for q in qs}

    def snapshot(self) -> dict:
        out = {"count": self.count, "window": len(self)}
        if self.count:
            out.update({
                "sum": round(self.total, 6),
                "mean": round(self.total / self.count, 6),
                "min": round(self.vmin, 6),
                "max": round(self.vmax, 6),
                **self.percentiles(),
            })
            nz = np.nonzero(self._bins)[0]
            out["log2_bins"] = {
                str(int(e) + self._lo_exp): int(self._bins[e])
                for e in nz}
        return out


class _Null:
    """The shared do-nothing instrument (all three APIs), which a
    disabled registry hands out."""

    __slots__ = ()
    name = "<null>"
    value = 0
    count = 0

    def add(self, v: int = 1) -> None:
        pass

    def set(self, v) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def __len__(self) -> int:
        return 0

    def percentiles(self, qs=(50, 95, 99), last=None) -> dict:
        return {}

    def window_values(self, last=None):
        return np.empty((0,), np.float64)

    def snapshot(self):
        return None


NULL = _Null()


class Registry:
    """Name -> instrument map; asking for a name again returns the same
    instrument. A disabled registry hands out NULL (the strict no-op
    mode); the mode is read when an instrument is asked for, so
    long-lived holders keep the mode they were created under."""

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._m: dict = {}

    def _get(self, name: str, cls, **kw):
        if not self.enabled:
            return NULL
        inst = self._m.get(name)
        if inst is None or inst.__class__ is not cls:
            inst = cls(name, **kw)
            self._m[name] = inst
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, window: int = 4096) -> Histogram:
        return self._get(name, Histogram, window=window)

    def snapshot(self) -> dict:
        """JSON-able {name: value-or-dict} of everything registered."""
        return {k: v.snapshot() for k, v in sorted(self._m.items())}

    def reset(self) -> None:
        self._m.clear()


_DEFAULT: Optional[Registry] = None


def _env_enabled() -> bool:
    return os.environ.get("DPSVM_OBS", "") not in ("", "0")


def get_registry() -> Registry:
    """The process-default registry, made at first use: enabled when
    the environment sets ``DPSVM_OBS`` (to anything but 0)."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Registry(enabled=_env_enabled())
    return _DEFAULT


def enable(on: bool = True) -> Registry:
    """Switch the default registry's mode (tests; a programmatic
    opt-in). Returns the registry."""
    reg = get_registry()
    reg.enabled = bool(on)
    return reg
