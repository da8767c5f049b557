"""Structured run logs (counterpart of dpsvm_tpu/obs/runlog.py; the same
schema, so either package reads the other's files).

One JSONL stream per process and tool, every record self-describing
and schema-versioned. Record shapes (all carry ``schema`` =
:data:`SCHEMA_VERSION`, ``run`` = the writer's run id, and ``kind``):

* ``manifest`` -- opened-run header: ``utc``, ``tool``, ``git_sha``,
  ``torch``, ``backend``, ``device_kind``, ``n_devices``, ``config``
  (dataclass snapshot), plus caller metadata (n, d, engine, ...).
* ``chunk``   -- one host observation of device progress: cumulative
  ``pairs``, per-chunk ``pairs_delta``, ``b_hi``/``b_lo``/``gap``,
  ``device_seconds`` (this chunk's dispatch to retired time),
  ``dispatch`` ordinal.
* ``event``   -- named occurrences: ``{"name": ..., **fields}``.
* ``span``    -- host timeline events from obs/trace.py.
* ``compile`` -- one kernel build or CUDA-graph capture made while the
  run was live (obs/compilelog.py): ``entrypoint``, ``shape``,
  ``seconds``.
* ``final``   -- run result fields + ``metrics`` (registry snapshot).

Every field comes from a value the host already holds: writing a run
log adds no kernel launch, copy or synchronisation. Files are
per-process append-only (``<tool>-<pid>.jsonl`` under the run-log
directory); records of one run share a ``run`` id. :func:`read_runlog`
loads and validates a stream; :func:`records_for` filters one run.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Optional

# The record schema's version, the JAX package's: bump on an
# incompatible shape change. Readers skip records NEWER than what they
# understand, explicitly rather than by crashing.
SCHEMA_VERSION = 1

_RUN_COUNTER = 0


def _git_dir(root: str) -> str:
    """The actual git directory for `root`. In a worktree or submodule
    checkout ``.git`` is a FILE holding a ``gitdir: <path>`` pointer
    (relative paths resolve against root) — following it is what keeps
    manifests from logging sha "unknown" there."""
    dot_git = os.path.join(root, ".git")
    if os.path.isfile(dot_git):
        with open(dot_git) as fh:
            first = fh.readline().strip()
        if first.startswith("gitdir:"):
            target = first.split(":", 1)[1].strip()
            if not os.path.isabs(target):
                target = os.path.normpath(os.path.join(root, target))
            return target
    return dot_git


def git_sha(repo_root: Optional[str] = None) -> str:
    """Current commit sha, read from .git directly (no subprocess: run
    logs open on hot paths and on machines without git). Handles
    ``.git``-as-file checkouts (worktrees/submodules) via the
    ``gitdir:`` pointer; a worktree's HEAD ref resolves against the
    parent repository's common dir."""
    root = repo_root or os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    try:
        git_dir = _git_dir(root)
        with open(os.path.join(git_dir, "HEAD")) as fh:
            head = fh.read().strip()
        if head.startswith("ref:"):
            ref = head.split(None, 1)[1]
            # Worktree git dirs keep refs/packed-refs in the parent
            # repository's common dir (the `commondir` pointer file).
            common = git_dir
            common_file = os.path.join(git_dir, "commondir")
            if os.path.isfile(common_file):
                with open(common_file) as fh:
                    rel = fh.read().strip()
                common = (rel if os.path.isabs(rel)
                          else os.path.normpath(os.path.join(git_dir,
                                                             rel)))
            for base in (git_dir, common):
                ref_path = os.path.join(base, *ref.split("/"))
                if os.path.exists(ref_path):
                    with open(ref_path) as fh:
                        return fh.read().strip()
            packed = os.path.join(common, "packed-refs")
            with open(packed) as fh:
                for line in fh:
                    if line.strip().endswith(ref):
                        return line.split()[0]
            return "unknown"
        return head
    except OSError:
        return "unknown"


def config_snapshot(config) -> Optional[dict]:
    """JSON-able snapshot of a (frozen dataclass) config; None stays
    None. Non-JSON leaves (e.g. nested dataclasses) are stringified
    rather than dropped."""
    if config is None:
        return None
    if dataclasses.is_dataclass(config):
        d = dataclasses.asdict(config)
    elif isinstance(config, dict):
        d = dict(config)
    else:
        return {"repr": repr(config)}

    def _clean(v):
        if isinstance(v, dict):
            return {k: _clean(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [_clean(x) for x in v]
        if v is None or isinstance(v, (bool, int, float, str)):
            return v
        return repr(v)

    return _clean(d)


def device_topology() -> dict:
    """Backend and device facts for the manifest record, from torch:
    the CUDA card's name, compute capability and memory when one is
    visible, else the CPU. Never initialises a device that the run did
    not already use beyond torch.cuda's own queries."""
    import torch

    out = {"torch": torch.__version__, "backend": "cpu",
           "device_kind": "cpu", "n_devices": 1, "process_count": 1}
    try:
        if torch.cuda.is_available():
            props = torch.cuda.get_device_properties(0)
            out.update(backend="gpu", device_kind=props.name,
                       n_devices=torch.cuda.device_count(),
                       capability=f"{props.major}.{props.minor}",
                       memory_bytes=int(props.total_memory))
    except Exception:
        pass
    return out


def default_dir(obs_config=None) -> str:
    """Run-log directory resolution: explicit config beats the
    DPSVM_OBS_DIR env beats ./obs_runs."""
    if obs_config is not None and getattr(obs_config, "runlog_dir", None):
        return obs_config.runlog_dir
    return os.environ.get("DPSVM_OBS_DIR") or "obs_runs"


def _jsonable(v):
    """JSON form of the values the port's records may carry beyond the
    JSON types: NumPy scalars and arrays, tuples of them; anything else
    as its repr."""
    if hasattr(v, "tolist"):
        return v.tolist()
    return repr(v)


class RunLog:
    """Append-only JSONL writer for ONE run (manifest -> chunk/event/
    span stream -> final). Use as a context manager or call
    :meth:`finish` explicitly; both are idempotent."""

    def __init__(self, path: str, tool: str, config=None, meta=None):
        global _RUN_COUNTER
        _RUN_COUNTER += 1
        self.path = path
        self.run_id = f"{os.getpid():d}-{_RUN_COUNTER:d}"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path, "a")
        # Serving writes events from its connection and pump threads:
        # one line per record, never interleaved.
        self._lock = threading.Lock()
        self._finished = False
        # dict-merge, caller meta last: a caller key (e.g. a solve's
        # mesh width as n_devices) overrides the topology default
        # instead of raising a duplicate-kwarg TypeError.
        manifest = {"utc": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                         time.gmtime()),
                    "tool": tool, "git_sha": git_sha(),
                    **device_topology(),
                    "config": config_snapshot(config),
                    **(meta or {})}
        self.record("manifest", **manifest)

    @classmethod
    def open(cls, tool: str, config=None, meta=None,
             obs_config=None, directory: Optional[str] = None) -> "RunLog":
        """Open the per-process stream for `tool` under the resolved
        run-log directory (one file per (tool, pid); runs append)."""
        d = directory or default_dir(obs_config)
        return cls(os.path.join(d, f"{tool}-{os.getpid()}.jsonl"),
                   tool, config=config, meta=meta)

    def record(self, kind: str, **fields) -> None:
        rec = {"schema": SCHEMA_VERSION, "run": self.run_id,
               "kind": kind, **fields}
        line = json.dumps(rec, default=_jsonable) + "\n"
        with self._lock:
            if self._fh is None:
                return
            self._fh.write(line)
            self._fh.flush()

    # The trace-session sink signature (obs/trace.py): span dicts
    # arrive pre-shaped {"kind": "span", ...}.
    def span_sink(self, rec: dict) -> None:
        self.record(**rec)

    def finish(self, **fields) -> None:
        if self._finished or self._fh is None:
            return
        self._finished = True
        self.record("final", **fields)
        with self._lock:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()
        return False


def read_runlog(path: str) -> list:
    """Parse + validate a runlog JSONL: every record must carry
    schema/run/kind; records with a NEWER schema than this reader are
    skipped (the forward-compatibility contract). Truncated or garbled
    lines (a writer killed mid-record) are dropped."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if not isinstance(rec, dict):
                continue
            if {"schema", "run", "kind"} - rec.keys():
                continue
            if not isinstance(rec["schema"], int) \
                    or rec["schema"] > SCHEMA_VERSION:
                continue
            out.append(rec)
    return out


def records_for(records: list, run_id: str, kind: Optional[str] = None):
    """One run's records (optionally one kind), in stream order."""
    return [r for r in records
            if r["run"] == run_id and (kind is None or r["kind"] == kind)]
