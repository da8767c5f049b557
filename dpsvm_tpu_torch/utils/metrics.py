"""Structured training metrics and profiling hooks (counterpart of
dpsvm_tpu/utils/metrics.py).

``MetricsLogger`` is the CLI's ``--metrics-jsonl`` progress stream: a
solver callback that records {iteration, b-gap, SV estimate, cache hit
rate, iterations/s} at every chunk boundary, to a JSONL file and / or a
text sink. Being a callback, it makes the solve observed (chunked), a
user-chosen cadence; the run log (dpsvm_tpu_torch/obs) instead rides
whatever cadence the solve already has and never changes it.
``profile_trace`` is the CLI's ``--trace-dir`` wrapper for runs without
``--obs``: a ``torch.profiler`` trace of the whole run, exported as a
Chrome trace. ``PhaseTimer`` times named host phases, waiting for the
device at each phase's end.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import IO, Optional


def _count_positive(alpha) -> int:
    """SVs in a state's alpha: a tensor, an array, or a mesh's list of
    per-shard tensors."""
    import numpy as np

    if isinstance(alpha, (list, tuple)):
        return sum(_count_positive(a) for a in alpha)
    if hasattr(alpha, "detach"):
        return int((alpha > 0).sum())
    return int(np.count_nonzero(np.asarray(alpha) > 0))


class MetricsLogger:
    """Chunk-cadence metrics recorder; usable as the solver `callback`.

    `lookups_per_iter` is the engine's row-cache cadence: the per-pair
    engines probe it twice per pair update, the block engines never (pass
    0; the rate then reads 0.0)."""

    def __init__(self, sink: Optional[IO] = None,
                 jsonl_path: Optional[str] = None,
                 lookups_per_iter: int = 2):
        self.records: list = []
        self._lookups_per_iter = lookups_per_iter
        self._sink = sink
        self._jsonl = open(jsonl_path, "a") if jsonl_path else None
        self._t0 = time.perf_counter()
        self._start_iter: Optional[int] = None
        self._last_iter: Optional[int] = None
        self._last_t = self._t0

    def on_start(self, start_iter: int) -> None:
        """Called by the solver before its loop with the (possibly
        resumed) start iteration, so rates leave earlier history out."""
        self._start_iter = start_iter
        self._last_iter = start_iter
        self._last_t = time.perf_counter()

    def __call__(self, iteration: int, b_hi: float, b_lo: float,
                 state) -> None:
        now = time.perf_counter()
        if self._last_iter is None:  # the solver announced no start
            self._start_iter = self._last_iter = 0
        d_it = iteration - self._last_iter
        d_t = max(now - self._last_t, 1e-9)
        hits = int(getattr(state, "hits", 0) or 0)
        this_run = iteration - (self._start_iter or 0)
        rec = {
            "iteration": int(iteration),
            "b_hi": float(b_hi),
            "b_lo": float(b_lo),
            "gap": float(b_lo - b_hi),
            "sv_estimate": _count_positive(state.alpha),
            "cache_hits": hits,
            "cache_hit_rate": hits / max(self._lookups_per_iter * this_run,
                                         1),
            "iters_per_sec": d_it / d_t,
            "elapsed_sec": now - self._t0,
        }
        self.records.append(rec)
        self._last_iter, self._last_t = iteration, now
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        if self._sink is not None:
            self._sink.write(
                f"iter={iteration} gap={rec['gap']:.6f} "
                f"sv~{rec['sv_estimate']} {rec['iters_per_sec']:.0f} it/s\n")
        return None

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str], device=None):
    """A torch.profiler trace of the enclosed run, exported as
    ``log_dir/trace-<pid>.json`` (Chrome trace). CUDA activity is
    recorded when the run's `device` is the card (None: the card, which
    raises without one, as every entry point does). No-op without a
    directory."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    from dpsvm_tpu_torch.device import resolve_device

    acts = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace-{os.getpid()}.json"))


class PhaseTimer:
    """Named wall-clock phases; a phase ends after the device work of the
    tensors it names has finished."""

    def __init__(self):
        self.phases: dict = {}

    @contextlib.contextmanager
    def phase(self, name: str, *tensors):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            import torch

            for dev in {t.device for t in tensors
                        if hasattr(t, "device")}:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            self.phases[name] = (self.phases.get(name, 0.0)
                                 + time.perf_counter() - t0)
