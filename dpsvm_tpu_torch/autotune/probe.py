"""Shared A/B probe measurement core (counterpart of
dpsvm_tpu/autotune/probe.py).

Every A/B the autotune probes (autotune/probes.py) run needs the same
defenses:

* :func:`salted`: a representable perturbation of the probe state, so
  every timed start is a fresh buffer with fresh contents (the JAX
  package needs it against its runtime's result cache; here it keeps
  the two packages' probes the same measurement);
* :func:`differenced_rounds`: the whole-chunk differenced timing: run
  the same chunk body at two chunk lengths (reps and 2*reps) and
  difference, so each chunk call's fixed cost (its seed selection, the
  first round's ramp, the final synchronize) cancels instead of reading
  as +F/reps on every round;
* best-of-N per chunk length, absorbing jitter between probes.

Every reading synchronizes the device before it reads the clock
(``torch.cuda.synchronize`` takes the place of JAX's
``block_until_ready``). ``timer`` is injectable everywhere (None: the
host's ``time.perf_counter``, or CUDA events in :func:`timed_loop` on
the card), so the determinism tests drive the whole measurement path
with a fake clock and assert byte-stable records.
"""

from __future__ import annotations

import time

import torch


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _leaves(x) -> list:
    return list(x) if isinstance(x, (list, tuple)) else [x]


def salted(x, k: int):
    """A copy of float tensor x (or of each tensor of a list of shards)
    whose contents differ REPRESENTABLY from x: a relative 2^-20 bump,
    exact in float32 at any magnitude, in a fresh buffer. Harmless to
    cost profiling: probe runs never need exact optima."""
    scale = 1.0 + k * 2.0 ** -20
    if isinstance(x, (list, tuple)):
        out = [t * scale for t in x]
        for t in out:
            _sync(t.device)
        return out
    out = x * scale
    _sync(out.device)
    return out


def timed_loop(fn, *args, reps: int, timer=None) -> float:
    """Seconds per repetition of ``fn(*carry) -> carry``, started from
    ``args``.

    JAX's version runs the repetitions as one ``fori_loop`` dispatch.
    Here the loop stays on the host: on the card it enqueues N calls
    back to back on the current stream between two CUDA events and
    synchronizes once, at N = reps and 2*reps, and differences the two
    readings, so the fixed cost of the events and the synchronize
    cancels. The host's enqueue cost of each call IS inside the
    reading: a call whose device work is shorter than its launch
    overhead measures the launch overhead. Elsewhere, or with an
    injected `timer`, the same differencing runs on the host clock with
    a synchronize before each reading."""
    dev = args[0].device
    events = timer is None and dev.type == "cuda"
    clock = timer or time.perf_counter

    def loop(a, n):
        carry = a
        for _ in range(n):
            carry = fn(*carry)
        return carry

    loop(args, reps)  # warm: build, allocate, first-launch costs
    _sync(dev)
    salt = [0]

    def run(n):
        # Off-clock representable perturbation of the first float arg.
        salt[0] += 1
        a = (salted(args[0], salt[0]),) + tuple(args[1:])
        if events:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            loop(a, n)
            e1.record()
            torch.cuda.synchronize(dev)
            return e0.elapsed_time(e1) / 1e3
        t0 = clock()
        loop(a, n)
        _sync(dev)
        return clock() - t0

    # best-of-2 per count absorbs jitter between the two readings.
    t1 = min(run(reps), run(reps))
    t2 = min(run(2 * reps), run(2 * reps))
    return max(t2 - t1, 0.0) / reps


def _count(v) -> int:
    return int(v[0] if isinstance(v, (list, tuple)) else v)


def best_chunk(run, base_state, salt_base: int, tries: int = 3,
               timer=None):
    """Best-of-`tries` timed executions of one chunk runner from salted
    fresh starts. `run(state)` returns a state carrying ``.rounds`` and
    ``.pairs`` (the BlockState / MeshBlockState contract; a mesh
    state's counters are lists, one per device). Returns ``(seconds,
    rounds, pairs)`` of the fastest try."""
    clock = timer or time.perf_counter
    devs = {t.device for t in _leaves(base_state.f)}
    best = None
    for k in range(tries):
        st = base_state._replace(f=salted(base_state.f, salt_base + k))
        t0 = clock()
        out = run(st)
        for dv in devs:
            _sync(dv)
        t = clock() - t0
        if best is None or t < best[0]:
            best = (t, _count(out.rounds), _count(out.pairs))
    return best


def differenced_rounds(make_run, base_state, reps: int, *,
                       salt_base: int = 0, tries: int = 3, timer=None):
    """THE whole-chunk differenced probe: build (and warm) the chunk
    runner at `reps` and `2*reps` rounds a chunk, time each best-of-
    `tries` from salted starts, and difference: each chunk call's fixed
    cost and the first call's build cancel, leaving `reps` rounds of
    chunk-body time.

    `make_run(rounds_per_chunk)` returns ``run(state) -> state`` whose
    output carries ``.rounds`` / ``.pairs``. Returns ``(seconds,
    rounds, pairs)`` of the differenced `reps`-round window (seconds
    clamped at >= 0)."""
    devs = {t.device for t in _leaves(base_state.f)}
    runs = {}
    for rpc in (reps, 2 * reps):
        run = make_run(rpc)
        run(base_state)  # build + warm
        for dv in devs:
            _sync(dv)
        runs[rpc] = best_chunk(run, base_state,
                               salt_base=salt_base + 101 * rpc,
                               tries=tries, timer=timer)
    t = max(runs[2 * reps][0] - runs[reps][0], 0.0)
    rounds = runs[2 * reps][1] - runs[reps][1]
    pairs = runs[2 * reps][2] - runs[reps][2]
    return t, rounds, pairs
