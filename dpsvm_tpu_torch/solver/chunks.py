"""The observed chunk loop shared by solve and solve_mesh (counterpart of
the chunk loops of dpsvm_tpu/solver/smo.py _solve_impl and
dpsvm_tpu/parallel/dist_smo.py _solve_mesh_impl).

A solve is observed when it has a callback, config.verbose,
config.check_numerics or an active checkpointer (a path and
checkpoint_every > 0). An observed solve runs in chunks: config.chunk_iters
pair updates on the per-pair engines, max(1, chunk_iters // inner) rounds
on the block engines. Between chunks the host reads (pairs, b_hi, b_lo),
calls the callback (a truthy return stops the solve at that boundary and
forces a checkpoint), checks the state under check_numerics, writes a due
checkpoint and prints the verbose line. A solve that nothing observes runs
as ONE chunk, so its launches and host reads are those of the unchunked
loop.

The clock: train_seconds sums the chunks, each from its dispatch to its
work retired on the device; observation runs with the clock stopped and
is counted in phase_seconds["observe"].

The run log (obs/__init__.py run_obs, NULL_OBS when off) is not part of
`observed`: its chunk records ride whatever cadence the solve already
has, so enabling it changes no chunking, launch or host read. Each chunk
runs inside the span `span` and behind the ``dispatch`` fault seam; the
``nonfinite_obs`` seam sits before the non-finite sentinel
(testing/faults.py).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from dpsvm_tpu_torch.config import SVMConfig
from dpsvm_tpu_torch.obs import NULL_OBS, run_obs
from dpsvm_tpu_torch.solver.smo import drain_pending_obs_events, gap_open
from dpsvm_tpu_torch.testing import faults
from dpsvm_tpu_torch.utils.checkpoint import (PeriodicCheckpointer,
                                              resume_state)


def observed(config: SVMConfig, callback, ckpt: PeriodicCheckpointer) -> bool:
    """Whether anything reads the solve's chunk boundaries."""
    return bool(callback is not None or config.verbose
                or config.check_numerics or ckpt.active)


def round_bound(config: SVMConfig, observe: bool,
                inner: int) -> Optional[int]:
    """Rounds a block-engine chunk runs: None (to the end) unobserved."""
    return max(1, int(config.chunk_iters) // inner) if observe else None


def pair_end(config: SVMConfig, observe: bool, it: int) -> int:
    """The pair count a per-pair chunk runs to."""
    if not observe:
        return int(config.max_iter)
    return min(it + int(config.chunk_iters), int(config.max_iter))


@dataclass
class Start:
    """A solve's start point on the host over its n real rows: alpha,
    f, the Kahan residual (None uncompensated), the carried extrema and
    the pair and round counters; `resumed` when it came from a
    checkpoint, with the file's shrink keys (solver/ooc.py)."""

    alpha: np.ndarray
    f: np.ndarray
    f_err: Optional[np.ndarray]
    b_hi: float = -np.inf
    b_lo: float = np.inf
    pairs: int = 0
    rounds: int = 0
    resumed: bool = False
    shrink_demoted: bool = False
    shrink_gap: Optional[float] = None
    shrink_stall: int = 0

    def padded(self, n_pad: int) -> tuple:
        """(alpha, f, f_err) over n_pad rows; the padded rows (y = 1)
        start at alpha 0, f -1, residual 0."""
        pad = (0, n_pad - len(self.alpha))
        return (np.pad(self.alpha, pad),
                np.pad(self.f, pad, constant_values=-1.0),
                None if self.f_err is None else np.pad(self.f_err, pad))


def start_state(y, config: SVMConfig, checkpoint_path=None,
                resume: bool = False, alpha_init=None,
                f_init=None) -> Start:
    """Where a solve of labels `y` (n,) starts: the C-SVC start (alpha =
    0, f = -y, an open gap) with alpha_init / f_init in place where
    given; all of it replaced by the newest loadable generation of
    `checkpoint_path` when `resume` finds one (utils/checkpoint.py
    resume_state, written by either package): raw f with its residual
    when compensated (a zero residual where the file has none), the
    effective f - f_err when not."""
    y = np.asarray(y)
    n = len(y)
    st = resume_state(checkpoint_path, config, n) if resume else None
    err = np.zeros(n, np.float32) if config.compensated else None
    if st is None:
        alpha = np.zeros(n, np.float32)
        f = -y.astype(np.float32)
        for buf, init in ((alpha, alpha_init), (f, f_init)):
            if init is not None:
                buf[:] = np.asarray(init, np.float32)
        return Start(alpha, f, err)
    f = np.asarray(st.f, np.float32)
    if st.f_err is not None:
        if config.compensated:
            err = np.asarray(st.f_err, np.float32)
        else:
            f = (f - np.asarray(st.f_err, np.float32)).astype(np.float32)
    return Start(np.asarray(st.alpha, np.float32), f, err, float(st.b_hi),
                 float(st.b_lo), int(st.iteration), int(st.rounds), True,
                 st.shrink_demoted, st.shrink_gap, st.shrink_stall)


class NonFiniteTrajectory(FloatingPointError):
    """The chunk-boundary observation read a NaN gap, or an infinite
    extremum of a sign only inf entries of f can produce: the carried
    gradient has blown up. Raised instead of reading a NaN gap as
    "converged"."""


def check_obs_finite(b_hi: float, b_lo: float, it: int, progressed: bool,
                     backend: str) -> None:
    """The JAX package's check_obs_finite: NaN in either extremum, or
    b_hi = -inf / b_lo = +inf after the solve made progress (an empty
    side reads b_hi = +inf / b_lo = -inf and is legitimate; the start
    state carries the impossible signs until the first selection)."""
    if b_hi != b_hi or b_lo != b_lo or (
            progressed and (b_hi == -np.inf or b_lo == np.inf)):
        raise NonFiniteTrajectory(
            f"[{backend}] non-finite optimality extrema at iteration {it}: "
            f"b_hi={b_hi!r} b_lo={b_lo!r} — the carried gradient has "
            "blown up")


def assert_finite_state(parts, it: int, backend: str) -> None:
    """config.check_numerics: every f and alpha entry finite, else
    FloatingPointError with the solver's context. `parts` is (f tensors,
    alpha tensors)."""
    f_parts, a_parts = parts
    bad_f = sum(int((~torch.isfinite(t)).sum()) for t in f_parts)
    bad_a = sum(int((~torch.isfinite(t)).sum()) for t in a_parts)
    if bad_f or bad_a:
        raise FloatingPointError(
            f"[{backend}] non-finite solver state at iteration {it}: "
            f"{bad_f} bad f entries, {bad_a} bad alpha entries — check "
            "input features for inf/NaN and gamma/C scaling")


@dataclass
class ChunkRun:
    """The loop's outcome: the host-read observation of the last chunk
    and the clocks."""

    state: object
    it: int
    b_hi: float
    b_lo: float
    chunks: int
    train_seconds: float
    phase_seconds: dict = field(default_factory=dict)


def open_run_obs(tool: str, config: SVMConfig, meta: dict, device,
                 write: bool = True):
    """The solve's run handle (NULL_OBS when obs is off, or when this
    process does not `write` the run log: a multi-process job's process
    k > 0), with the events a faulted or demoted earlier attempt queued
    drained into it."""
    obs = run_obs(tool, config, meta=meta, device=device) if write \
        else NULL_OBS
    drain_pending_obs_events(obs)
    return obs


def finish_run_obs(obs, res, dispatches: int, **fields) -> None:
    """Close a live run with the result's host-held fields and name its
    log in res.stats (obs_run_id, obs_runlog). Nothing when obs is off."""
    if not obs.live:
        return
    res.stats["obs_run_id"] = obs.run_id
    res.stats["obs_runlog"] = obs.path
    obs.finish(iterations=int(res.iterations),
               converged=bool(res.converged),
               train_seconds=round(float(res.train_seconds), 6),
               dispatches=int(dispatches), b_hi=float(res.b_hi),
               b_lo=float(res.b_lo),
               n_sv=int(np.count_nonzero(res.alpha > 0)),
               phase_seconds={k: round(v, 6) for k, v in
                              res.stats.get("phase_seconds", {}).items()},
               **fields)


def run_chunks(run_chunk: Callable, state, read: Callable, *,
               config: SVMConfig, eps_run: float, callback,
               ckpt: PeriodicCheckpointer, start_iter: int, sync: Callable,
               payload: Callable, tensors: Callable, backend: str,
               t_entry: float, obs=NULL_OBS, span: str = "solver/chunk",
               chunk_fields: Optional[Callable] = None) -> ChunkRun:
    """Drive `run_chunk(state) -> state` chunk by chunk. `read(state)`
    returns the host's (pairs, b_hi, b_lo) in one read; `payload(state)`
    the checkpoint's arrays (alpha, f, f_err, rounds; the first n rows);
    `tensors(state)` (f tensors, alpha tensors) for check_numerics;
    `sync()` waits for the device. The loop ends when the carried gap
    closes (tested in float32, as the runners test it), the pair budget
    is spent, or the callback asks to stop. `obs` gets a chunk record
    per chunk (with `chunk_fields()`'s extra fields)."""
    if callback is not None and hasattr(callback, "on_start"):
        callback.on_start(start_iter)
    sync()
    phases = {"setup": time.perf_counter() - t_entry, "solve": 0.0,
              "observe": 0.0, "finalize": 0.0}
    train_seconds = 0.0
    chunks = 0
    while True:
        with obs.span(span):
            t0 = time.perf_counter()
            faults.device_fault("dispatch", f"chunk {chunks + 1}")
            state = run_chunk(state)
            sync()
            # The clock stops inside the span: the span's record is
            # written as it closes, on observation time.
            t_obs = time.perf_counter()
        dt = t_obs - t0
        train_seconds += dt
        chunks += 1
        it, b_hi, b_lo = read(state)
        b_hi, b_lo = faults.poison_obs(b_hi, b_lo)
        check_obs_finite(b_hi, b_lo, it, it > start_iter, backend)
        if obs.live:
            obs.chunk(pairs=it, b_hi=b_hi, b_lo=b_lo, device_seconds=dt,
                      dispatch=chunks,
                      **(chunk_fields() if chunk_fields else {}))
        closed = not gap_open(b_hi, b_lo, eps_run)
        abort = bool(callback is not None
                     and callback(it, b_hi, b_lo, state))
        if config.check_numerics:
            assert_finite_state(tensors(state), it, backend)
        if ckpt.due(it) or (abort and ckpt.active):
            alpha, f, f_err, rounds = payload(state)
            ckpt.save(it, alpha, f, b_hi, b_lo, force=True, f_err=f_err,
                      rounds=rounds)
        if config.verbose:
            print(f"[{backend}] iter={it} b_lo-b_hi={b_lo - b_hi:.6f}",
                  flush=True)
        phases["observe"] += time.perf_counter() - t_obs
        if closed or it >= config.max_iter or abort:
            break
    phases["solve"] = train_seconds
    return ChunkRun(state, it, b_hi, b_lo, chunks, train_seconds, phases)
