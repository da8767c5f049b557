"""Deterministic fault injection (counterpart of
dpsvm_tpu/testing/faults.py; host code, the same seams and grammar).

Each fault-tolerance behavior is proven by an injected fault: a named
SEAM is a host-side hook on a host-driven boundary (a dispatch, a
checkpoint write, a model load, a socket) that this module arms. A
:class:`FaultPlan` fires on exact ARRIVAL COUNTS at a seam, never on
wall clock or randomness; byte corruption is seeded. Disarmed, a seam
is one module attribute read and a truthiness test.

Activation, in tests::

    from dpsvm_tpu_torch.testing import faults
    with faults.install(faults.FaultPlan.parse("serve_dispatch@3")):
        ...

or for a subprocess: ``DPSVM_FAULTS="serve_stall@1"``. The grammar is
comma-separated ``seam[@N][xK]``: fire on the N-th arrival (1-based,
default 1) and the K-1 after it. ``DPSVM_FAULTS_SEED`` seeds the byte
corruption (default 0).

Seams armed by the solver: ``dispatch`` (a chunk or round dispatch of
solve, solve_mesh and both out-of-core solvers raises the transient
``UNAVAILABLE:`` fault that run_with_fault_retry retries),
``ooc_tile_put`` (an out-of-core tile or stream-step upload raises the
same), ``ckpt_truncate`` (a checkpoint write is truncated and dies
between the tmp write and the rename) and ``nonfinite_obs`` (the
chunk-boundary observation reads NaN, the trigger of the demotion to
the safe configuration). Seams armed by serving: ``swap_corrupt`` (a
registry load reads a corrupted copy of the file), ``serve_dispatch``
(a bucket dispatch raises), ``serve_stall`` (a batch's materialization
sleeps STALL_SECONDS in the watchdog's waiting thread), ``lock_stall``
(ModelRegistry.get holds its lock), ``net_accept`` (the front door
drops a connection at accept), and in the client ``net_conn_drop``,
``net_read_stall`` and ``net_partial_write``. ``plan.fired`` counts the
firings, so a test can assert that its fault really happened.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import re
import threading
import time
from collections import Counter
from typing import List, Optional

#: every seam name a spec may arm (typos fail loudly at parse time).
SEAMS = frozenset({
    "dispatch", "ooc_tile_put", "ckpt_truncate", "swap_corrupt",
    "serve_dispatch", "serve_stall", "nonfinite_obs",
    "net_accept", "net_conn_drop", "net_read_stall",
    "net_partial_write", "lock_stall",
})

#: how long a fired ``serve_stall`` sleeps (long enough to trip any
#: sane dispatch watchdog, short enough that the daemon worker thread
#: dies quickly after the test). Tests may monkeypatch.
STALL_SECONDS = 5.0

#: how long a fired ``net_read_stall`` client stalls before reading its
#: verdict (a slow reader, not a dead one — shorter than STALL_SECONDS
#: because the stall rides INSIDE a chaos leg's wall clock; the server
#: must be provably unaffected, so nothing waits on it). Tests may
#: monkeypatch.
NET_STALL_SECONDS = 0.5

#: how long a fired ``lock_stall`` holds its caller's lock. The seam
#: is CALLED INSIDE a critical section (ModelRegistry.get), so this
#: bounds seeded lock contention: long enough that every contending
#: thread provably blocks on the lock, short enough that a test's
#: wall clock stays sane. Tests may monkeypatch.
LOCK_STALL_SECONDS = 0.25

_SPEC_RE = re.compile(r"^(?P<seam>[a-z_]+)(@(?P<at>\d+))?(x(?P<times>\d+))?$")


class FaultInjected(RuntimeError):
    """A non-device injected fault (e.g. the checkpoint-write
    truncation)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One armed seam: fire on arrivals [at, at + times)."""

    seam: str
    at: int = 1
    times: int = 1

    def __post_init__(self):
        if self.seam not in SEAMS:
            raise ValueError(
                f"unknown fault seam {self.seam!r} (have "
                f"{sorted(SEAMS)})")
        if self.at < 1 or self.times < 1:
            raise ValueError(
                f"fault spec {self.seam}@{self.at}x{self.times}: "
                "@N and xK must be >= 1 (arrivals are 1-based)")

    def covers(self, arrival: int) -> bool:
        return self.at <= arrival < self.at + self.times


class FaultPlan:
    """A deterministic set of armed seams with per-seam arrival
    counters. Thread-safe: serving seams fire from pump/admin threads
    concurrently."""

    def __init__(self, specs: List[FaultSpec], seed: int = 0):
        self.specs = list(specs)
        self.seed = int(seed)
        self.arrivals: Counter = Counter()
        self.fired: Counter = Counter()
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "FaultPlan":
        """Parse the ``DPSVM_FAULTS`` grammar: comma-separated
        ``seam[@N][xK]`` tokens."""
        specs = []
        for tok in (t.strip() for t in (text or "").split(",")):
            if not tok:
                continue
            m = _SPEC_RE.match(tok)
            if m is None:
                raise ValueError(
                    f"bad fault spec {tok!r} (grammar: seam[@N][xK], "
                    f"seams: {sorted(SEAMS)})")
            specs.append(FaultSpec(
                seam=m.group("seam"),
                at=int(m.group("at") or 1),
                times=int(m.group("times") or 1)))
        return cls(specs, seed=seed)

    @property
    def armed(self) -> bool:
        return bool(self.specs)

    def arrive(self, seam: str) -> bool:
        """Count one arrival at `seam`; True when an armed spec covers
        this arrival (the caller then injects its fault)."""
        with self._lock:
            self.arrivals[seam] += 1
            n = self.arrivals[seam]
            hit = any(s.seam == seam and s.covers(n) for s in self.specs)
            if hit:
                self.fired[seam] += 1
            return hit


# ------------------------------------------------------- active plan
# _PLAN is the installed plan (tests); _ENV_CACHE memoizes the parsed
# DPSVM_FAULTS value so the disarmed hot path is one env read + a
# string compare.
_PLAN: Optional[FaultPlan] = None
_ENV_CACHE: tuple = ("", None)  # (env string, FaultPlan | None)
# Guards writes to the two module globals above. arrive() runs on pump
# and watchdog threads; the lock keeps a racing first-touch env parse
# single-flight. The disarmed hot path stays lock-free — a plain tuple
# read.
_plan_lock = threading.Lock()


def active_plan() -> Optional[FaultPlan]:
    """The armed plan, or None (the overwhelmingly common case)."""
    global _ENV_CACHE
    if _PLAN is not None:
        return _PLAN if _PLAN.armed else None
    env = os.environ.get("DPSVM_FAULTS", "")
    if not env:
        return None
    if env != _ENV_CACHE[0]:
        seed = int(os.environ.get("DPSVM_FAULTS_SEED", "0"))
        with _plan_lock:
            if env != _ENV_CACHE[0]:  # single-flight parse
                _ENV_CACHE = (env, FaultPlan.parse(env, seed=seed))
    return _ENV_CACHE[1]


@contextlib.contextmanager
def install(plan: Optional[FaultPlan]):
    """Install `plan` as the process-wide active plan for the scope
    (tests). Nesting replaces; exit restores the previous plan."""
    global _PLAN
    with _plan_lock:
        prev = _PLAN
        _PLAN = plan
    try:
        yield plan
    finally:
        with _plan_lock:
            _PLAN = prev


def arrive(seam: str) -> bool:
    """The universal seam check: False-fast when nothing is armed."""
    plan = active_plan()
    return plan is not None and plan.arrive(seam)


# ------------------------------------------------------- seam actions

def device_fault(seam: str, detail: str = "") -> None:
    """Raise a transient device-runtime fault when `seam` fires: a
    RuntimeError whose text starts with ``UNAVAILABLE:``, the status the
    retry classifier (solver/smo.py _is_transient_fault) reads as
    transient, as the JAX package's injected fault is."""
    if arrive(seam):
        raise RuntimeError(
            f"UNAVAILABLE: injected fault at seam {seam!r}"
            + (f" ({detail})" if detail else ""))


def damage_checkpoint(tmp_path: str) -> None:
    """The ``ckpt_truncate`` seam: truncate the staged tmp file to half
    its bytes and die before the atomic rename, which is what a
    preemption mid-save leaves behind. The writer's except path must
    unlink the wreck and leave the previous checkpoint intact."""
    if arrive("ckpt_truncate"):
        size = os.path.getsize(tmp_path)
        with open(tmp_path, "r+b") as fh:
            fh.truncate(size // 2)
        raise FaultInjected(
            f"injected preemption mid-checkpoint-save ({tmp_path}: "
            f"{size} -> {size // 2} bytes, rename never ran)")


def poison_obs(b_hi: float, b_lo: float):
    """The ``nonfinite_obs`` seam: the chunk-boundary host observation
    reads NaN, what a blown-up gradient looks like from the host.
    Identity when disarmed."""
    if arrive("nonfinite_obs"):
        return float("nan"), float("nan")
    return b_hi, b_lo


def corrupt_bytes(data: bytes, seed: int = 0,
                  mode: str = "truncate") -> bytes:
    """Deterministically corrupt an npz payload. ``truncate`` cuts the
    byte stream inside the member data (a partial copy / killed
    writer); ``flip`` XORs a seeded sample of bytes past the zip local
    header (bit rot / torn write). Same (data, seed, mode) -> same
    output, always != input for len(data) > 64."""
    import numpy as np

    if mode == "truncate":
        # Keep the zip local-file header so np.load starts parsing and
        # fails INSIDE a member read — the lazy-decompression case the
        # registry's eager validation exists for.
        return data[:max(64, int(len(data) * 0.6))]
    if mode == "flip":
        rng = np.random.default_rng(seed)
        arr = np.frombuffer(data, np.uint8).copy()
        # Flip past the zip local header when the payload is big enough
        # to have one worth preserving; tiny payloads flip anywhere
        # (the != guarantee only holds above 64 bytes either way).
        lo = 64 if len(arr) > 64 else 0
        idx = rng.integers(lo, max(lo + 1, len(arr)),
                           size=min(32, max(1, len(arr))))
        idx = idx[idx < len(arr)]
        arr[idx] ^= 0xFF
        return arr.tobytes()
    raise ValueError(f"unknown corruption mode {mode!r}")


def corrupt_npz_file(src: str, dst: Optional[str] = None,
                     seed: int = 0, mode: str = "truncate") -> str:
    """Write a deterministically corrupted copy of `src` (the chaos
    legs' bad-swap input). Returns the written path."""
    with open(src, "rb") as fh:
        data = fh.read()
    if dst is None:
        root, ext = os.path.splitext(src)
        dst = f"{root}.corrupt{ext or '.npz'}"
    bad = corrupt_bytes(data, seed=seed, mode=mode)
    with open(dst, "wb") as fh:
        fh.write(bad)
    return dst


def maybe_corrupt_model(path: str) -> str:
    """The ``swap_corrupt`` seam: when fired, the registry load reads a
    corrupted sibling copy instead of `path`, so the REAL
    validate/reject path is what gets exercised (never a mocked
    error). Returns `path` unchanged when disarmed."""
    if not isinstance(path, str) or not arrive("swap_corrupt"):
        return path
    plan = active_plan()
    seed = plan.seed if plan is not None else 0
    import tempfile

    dst = os.path.join(tempfile.mkdtemp(prefix="dpsvm_fault_"),
                       os.path.basename(path))
    return corrupt_npz_file(path, dst, seed=seed)


def serve_stall() -> None:
    """The ``serve_stall`` seam: called from the dispatcher's WAITING
    thread (never the pump thread) so a fired stall models a wedged
    device dispatch the watchdog must bound."""
    if arrive("serve_stall"):
        time.sleep(STALL_SECONDS)


def lock_stall() -> None:
    """The ``lock_stall`` seam: seeded lock CONTENTION. It is called
    inside ModelRegistry.get's critical section, so a fired stall
    holds ModelRegistry._lock for ``LOCK_STALL_SECONDS`` while every
    other registry caller (submits routing a model, an admin thread
    preparing a swap, a scrape labelling queue depth) blocks on the
    lock: a held lock may delay serving, never wedge it."""
    if arrive("lock_stall"):
        time.sleep(LOCK_STALL_SECONDS)


# The network seams. net_accept fires in the SERVER's accept
# path; the other three fire in the CLIENT (serving/client.py), because
# the behaviors they model — a killed connection, a slow reader, a
# truncated send — are things the wire does TO the server: arming them
# in the client exercises the server's real read/write/accounting
# paths, never a mock.

def net_accept_drop() -> bool:
    """True when the ``net_accept`` seam fires: the server drops this
    incoming connection without a frame."""
    return arrive("net_accept")


def net_conn_drop() -> bool:
    """True when the ``net_conn_drop`` seam fires: the client must
    close its socket after the send, before reading the verdict."""
    return arrive("net_conn_drop")


def net_partial_write() -> bool:
    """True when the ``net_partial_write`` seam fires: the client must
    send only half the frame bytes and close."""
    return arrive("net_partial_write")


def net_read_stall() -> None:
    """The ``net_read_stall`` seam: the client sleeps before reading
    its verdict — a slow reader the server must not block on."""
    if arrive("net_read_stall"):
        time.sleep(NET_STALL_SECONDS)
