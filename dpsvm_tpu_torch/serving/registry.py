"""Model registry: named, versioned serving models with atomic hot swap
(counterpart of dpsvm_tpu/serving/registry.py; model files and
journals written by either package load in the other).

The v1 server binds ONE model at construction; replacing it means a new
process and a cold bucket-warmup window — downtime. The registry makes
the model a named, versioned slot:

* ``register(name, source)`` / ``swap(name, source)`` fully LOAD,
  VALIDATE and (via the engine's ``prepare`` hook) STAGE + WARM the
  incoming version before anything observable changes; only then does
  the name flip to the new :class:`LoadedModel` under the lock. A
  corrupted or truncated npz (driver killed mid-write, partial copy)
  raises :class:`ModelLoadError` and the prior version keeps serving —
  the failure mode the validation exists for.
* Readers (the engine's submit path) resolve ``name -> LoadedModel``
  once per request and carry the reference: requests admitted before a
  swap finish on the version they were admitted against (the old
  union stays staged until its queue drains); requests admitted after
  the flip see the new version. There is no intermediate state — the
  flip is one dict assignment under the lock.

Versions are monotonic per name (1, 2, ...), exported as the
``serving_model_version`` gauge so a scrape can tell which version is
live without parsing logs.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import threading
from typing import Callable, Optional, Union

import numpy as np

from dpsvm_tpu_torch.models.multiclass import (CompactedEnsemble,
                                               MulticlassSVM, compact_models,
                                               ovo_vote_fold)
from dpsvm_tpu_torch.models.svm_model import SVMModel
from dpsvm_tpu_torch.predict import AUTO_F64_RISK, decision_risk_columns
from dpsvm_tpu_torch.testing import faults
from dpsvm_tpu_torch.utils.checkpoint import fsync_dir


class ModelLoadError(ValueError):
    """A model file failed to load or validate. Raised BEFORE any
    registry state changes, so the live version is never disturbed."""


def _union_fingerprint(ens: CompactedEnsemble) -> str:
    """Content hash of the SV union rows — the coalescing identity.
    Two models whose unions are byte-identical (and share kernel and
    feature width) can have their queries answered by ONE kernel
    matmul with their coefficient columns stacked side by side, so
    this hash keys the scheduler's union groups. Computed once per
    registration (a few ms at MNIST-OvO scale), never on the request
    path."""
    sv = np.ascontiguousarray(ens.sv_union, np.float32)
    return hashlib.sha256(sv.tobytes()).hexdigest()[:16]


@dataclasses.dataclass(eq=False)  # identity semantics: sets/dicts key
class LoadedModel:                # on THE staged version, not its bytes
    """One registered model version: the loaded model object plus every
    derived fact the request path needs (so submit/dispatch never
    re-derive anything). Immutable after construction — a swap builds a
    NEW LoadedModel; it never mutates the live one."""

    name: str
    version: int
    source: str  # path or "<object>"
    model: Union[MulticlassSVM, SVMModel]
    ens: CompactedEnsemble
    strategy: str  # "binary" | "ovr" | "ovo"
    classes: Optional[np.ndarray]
    union_fp: str
    f64_cols: np.ndarray

    @property
    def kp(self):
        return self.ens.kernel

    @property
    def d(self) -> int:
        return int(self.ens.sv_union.shape[1])

    @property
    def k(self) -> int:
        return self.ens.n_models

    def group_key(self, dtype: str) -> tuple:
        """The coalescing family: models sharing (union bytes, kernel,
        feature width, storage dtype) answer from one staged union."""
        return (self.union_fp, int(self.ens.sv_union.shape[0]), self.d,
                self.kp, dtype)

    def labels(self, dec: np.ndarray) -> np.ndarray:
        """Decision columns -> predicted labels (strategy-aware; the
        PredictServer.labels semantics)."""
        if self.strategy == "binary":
            return np.where(dec[:, 0] >= 0, 1, -1).astype(np.int32)
        if self.strategy == "ovr":
            return self.classes[np.argmax(dec, axis=1)]
        return self.classes[np.argmax(
            ovo_vote_fold(dec, len(self.classes)), axis=1)]


def _validate_compacted(ens: CompactedEnsemble) -> None:
    """Structural consistency of the compacted arrays — a partial write
    can produce a loadable npz whose arrays disagree (e.g. a truncated
    coef matrix); serving it would crash mid-dispatch or, worse, gather
    wrong columns. Checked before the model is ever visible."""
    s = int(ens.sv_union.shape[0])
    k = ens.n_models
    if ens.coef.shape != (s, k):
        raise ModelLoadError(
            f"compacted coef shape {ens.coef.shape} disagrees with "
            f"sv_union rows {s} x {k} models")
    if ens.b.shape != (k,):
        raise ModelLoadError(
            f"compacted b shape {ens.b.shape} != ({k},)")
    if ens.idx.shape[0] != k or ens.coef_pad.shape != ens.idx.shape:
        raise ModelLoadError(
            f"compacted idx/coef_pad shapes {ens.idx.shape}/"
            f"{ens.coef_pad.shape} disagree ({k} models)")
    if s and (int(ens.idx.min()) < 0 or int(ens.idx.max()) >= s):
        raise ModelLoadError(
            f"compacted idx points outside the union "
            f"[{int(ens.idx.min())}, {int(ens.idx.max())}] vs {s} rows")
    if not (np.isfinite(ens.coef).all() and np.isfinite(ens.b).all()
            and np.isfinite(ens.sv_union).all()):
        raise ModelLoadError("compacted arrays hold non-finite values")


def load_model_file(path: str) -> Union[MulticlassSVM, SVMModel]:
    """Load a servable classifier model (.npz multiclass bundle or
    binary model, .txt binary) with the loud-failure contract: ANY
    loading problem — truncated zip, missing keys, zlib corruption in a
    member, wrong model_type — raises :class:`ModelLoadError` so the
    registry can refuse the file without disturbing the live version."""
    # swap_corrupt fault seam: when armed, this load reads a
    # deterministically corrupted copy of the file, so the REAL
    # validate/reject path below is what the chaos legs exercise —
    # never a mocked error. Identity when disarmed.
    path = faults.maybe_corrupt_model(path)
    try:
        if path.endswith(".npz"):
            z = np.load(path, allow_pickle=False)
            mt = str(z.get("model_type", ""))
            if mt in ("svr", "oneclass", "precomputed_svc"):
                raise ModelLoadError(
                    f"cannot serve a {mt} model (the serving engine is "
                    "the classifier decision path)")
            if mt == "multiclass" or ("n_models" in z and "strategy" in z):
                # Force every member array through the decompressor NOW:
                # np.load is lazy per member, so a file truncated inside
                # a compressed member would otherwise pass load and
                # crash at first dispatch.
                return MulticlassSVM.load(path)
            return SVMModel.load(path)
        return SVMModel.load(path)
    except ModelLoadError:
        raise
    except Exception as e:  # BadZipFile, zlib.error, KeyError, ...
        # Deliberately broad: the contract is "reject, keep serving" —
        # whatever shape the corruption takes, it must surface as the
        # one refusal type the registry handles, never escape and take
        # the engine down.
        raise ModelLoadError(f"cannot load model {path!r}: "
                             f"{type(e).__name__}: {e}") from e


def build_loaded(name: str, source, version: int) -> LoadedModel:
    """LoadedModel from a path or an in-memory model object (the
    object form is the test/bench convenience; files are the
    production path)."""
    if isinstance(source, str):
        model = load_model_file(source)
        src = source
    else:
        model, src = source, "<object>"
    if isinstance(model, MulticlassSVM):
        ens = model.ensure_compacted()
        if ens is None:
            raise ModelLoadError(
                f"model {name!r}: submodels do not share one kernel "
                "(mixed-kernel ensembles have no SV union to share)")
        strategy, classes = model.strategy, np.asarray(model.classes)
    elif isinstance(model, SVMModel):
        ens = compact_models([model])
        strategy, classes = "binary", None
    else:
        raise ModelLoadError(
            f"cannot serve a {type(model).__name__}; expected "
            "MulticlassSVM or SVMModel")
    _validate_compacted(ens)
    risks = decision_risk_columns(ens.coef)
    f64_cols = np.nonzero(risks >= AUTO_F64_RISK)[0]
    return LoadedModel(name=name, version=version, source=src,
                       model=model, ens=ens, strategy=strategy,
                       classes=classes,
                       union_fp=_union_fingerprint(ens),
                       f64_cols=f64_cols)


class RegistryJournal:
    """Durable record of the live model set (crash recovery).

    The registry itself is process memory — a crashed or restarted
    engine comes back EMPTY, which a millions-of-users front door
    cannot afford. The journal closes that gap with the minimum
    durable state: a JSON file holding {name -> model path + version},
    ATOMICALLY REWRITTEN (tmp + rename, the checkpoint discipline) on
    every register/swap/unregister, so it is always a complete,
    parseable snapshot of the live set — a kill at any instant leaves
    either the old snapshot or the new one, never a torn file.

    Replay (:meth:`ServingEngine` construction) re-registers each
    journaled (name, path) through the NORMAL validate-stage-warm
    path, seeding version counters so the rehydrated engine serves the
    exact pre-crash versions. Only file-backed models journal:
    in-memory model objects cannot be replayed, so they are recorded
    nowhere (the registry's entries() still serves them live)."""

    FORMAT_VERSION = 1

    def __init__(self, path: str):
        self.path = path

    def write(self, models: dict) -> None:
        """Atomically AND durably persist {name: {"source": path,
        "version": v}}: tmp + fsync + rename + directory fsync — the
        checkpoint.py discipline: without the fsyncs the rename could
        reach disk before the tmp file's data blocks."""
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".journal.tmp")
        try:
            with os.fdopen(fd, "w") as fh:
                json.dump({"format_version": self.FORMAT_VERSION,
                           "models": models}, fh, indent=1)
                fh.flush()
                os.fsync(fh.fileno())  # data durable BEFORE the rename
            os.replace(tmp, self.path)
            fsync_dir(d)  # …and the rename itself durable after
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def load(self) -> dict:
        """The journaled {name: {"source", "version"}} map; {} when the
        journal does not exist yet. A corrupt/unreadable journal fails
        LOUDLY — silently serving an empty model set after a crash is
        exactly the failure mode the journal exists to prevent."""
        if not os.path.exists(self.path):
            return {}
        try:
            with open(self.path) as fh:
                doc = json.load(fh)
        except (OSError, json.JSONDecodeError) as e:
            raise ValueError(
                f"registry journal {self.path!r} is unreadable "
                f"({type(e).__name__}: {e}); refusing to start with a "
                "silently empty model set — repair or remove the "
                "journal explicitly") from e
        if int(doc.get("format_version", -1)) != self.FORMAT_VERSION:
            raise ValueError(
                f"registry journal {self.path!r} has format_version "
                f"{doc.get('format_version')!r}; this build writes "
                f"{self.FORMAT_VERSION}")
        return dict(doc.get("models", {}))


class ModelRegistry:
    """name -> live LoadedModel, with atomic replacement.

    ``prepare`` (the engine's hook) runs on the fully built incoming
    LoadedModel BEFORE it becomes visible: device staging and bucket
    warm-up happen there, so the first post-swap request pays no
    upload (zero-downtime). If prepare raises, the
    registry is untouched."""

    def __init__(self, prepare: Optional[Callable] = None,
                 on_swap: Optional[Callable] = None,
                 journal: Optional[RegistryJournal] = None):
        self._lock = threading.Lock()
        self._live: dict = {}
        self._versions: dict = {}
        self._prepare = prepare
        self._on_swap = on_swap
        self._journal = journal
        # Journal writes run OUTSIDE self._lock (disk I/O must never
        # stall request routing, which takes self._lock on every
        # submit via get()). Publish order is preserved by snapshotting
        # under self._lock with a sequence number and skipping any
        # snapshot older than the last one written.
        self._journal_lock = threading.Lock()
        self._journal_seq = 0
        self._journal_written_seq = 0

    def attach_journal(self, journal: RegistryJournal) -> None:
        """Attach (and immediately snapshot to) a journal. The engine
        attaches AFTER replay — a journal attached during replay would
        be rewritten with each partially replayed subset, and a crash
        mid-replay would then SHRINK the durable record. An unwritable
        journal raises HERE (engine construction, no traffic yet):
        discovering it at the post-crash rehydrate would be too late."""
        with self._lock:
            self._journal = journal
            snap = self._journal_snapshot_locked()
        self._journal_publish(snap, strict=True)

    def _journal_snapshot_locked(self):
        """Snapshot the live set for the journal (caller holds
        self._lock; cheap — pure dict work, no I/O). Only file-backed
        entries are recorded: an in-memory object registration cannot
        be replayed, so journaling it would turn the next rehydrate
        into a hard error for state that was never durable to begin
        with. Returns (seq, payload, journal) or None."""
        if self._journal is None:
            return None
        self._journal_seq += 1
        return (self._journal_seq, {
            e.name: {"source": e.source, "version": e.version}
            for e in self._live.values() if e.source != "<object>"},
            self._journal)

    def _journal_publish(self, snap, strict: bool = False) -> None:
        """Write a snapshot taken by _journal_snapshot_locked to disk,
        outside the registry lock. A snapshot that lost the race to a
        newer one is dropped (the journal is a whole-set snapshot, so
        the newest write is always the full current truth). A write
        failure must NOT fail the registration that produced it — the
        in-memory registry is the serving truth and the flip has
        already happened — so it warns LOUDLY instead (a rotting
        journal means a post-crash rehydrate serves a stale set);
        ``strict`` (attach time) re-raises."""
        if snap is None:
            return
        seq, payload, journal = snap
        with self._journal_lock:
            if seq <= self._journal_written_seq:
                return
            try:
                journal.write(payload)
                self._journal_written_seq = seq
            except Exception as e:
                if strict:
                    raise
                import warnings

                warnings.warn(
                    f"registry journal write to {journal.path!r} "
                    f"FAILED ({type(e).__name__}: {e}); the live "
                    "model set is SERVING but NOT DURABLE — a crash "
                    "now rehydrates the previous journaled set. Fix "
                    "the journal path/disk and trigger any "
                    "register/swap to re-snapshot.", stacklevel=3)

    def register(self, name: str, source) -> LoadedModel:
        """Load + validate + prepare `source`, then atomically publish
        it as `name` (version = previous + 1). The load/validate/
        prepare work runs OUTSIDE the lock — a slow or failing load
        never blocks concurrent readers of other names, and a failure
        leaves the previous version serving (and burns no version
        number). The FINAL version is assigned under the lock at
        publish time, so concurrent swaps of one name get distinct,
        monotonic versions (last publish wins the slot)."""
        entry = build_loaded(name, source,
                             self._versions.get(name, 0) + 1)
        if self._prepare is not None:
            self._prepare(entry)
        with self._lock:
            version = self._versions.get(name, 0) + 1
            entry.version = version  # provisional -> final
            prev = self._live.get(name)
            self._live[name] = entry
            self._versions[name] = version
            snap = self._journal_snapshot_locked()
        self._journal_publish(snap)
        if prev is not None and self._on_swap is not None:
            self._on_swap(prev, entry)
        return entry

    def restore(self, name: str, source: str, version: int) -> LoadedModel:
        """Journal-replay registration: register `source` as `name`
        pinned at exactly `version` (the pre-crash version), through
        the same load/validate/prepare path as a live register. The
        version counter is seeded so monotonicity continues from the
        journaled history, not from 1."""
        with self._lock:
            self._versions[name] = max(self._versions.get(name, 0),
                                       int(version) - 1)
        return self.register(name, source)

    def swap(self, name: str, source) -> LoadedModel:
        """Hot-swap an EXISTING name to a new version (register with a
        must-exist check — a typo'd name must not silently create a
        second model)."""
        if name not in self._live:
            raise KeyError(f"no model {name!r} registered "
                           f"(have {sorted(self._live)})")
        return self.register(name, source)

    def get(self, name: Optional[str] = None) -> LoadedModel:
        with self._lock:
            # Seeded lock-contention probe: an armed lock_stall holds
            # THIS lock for a bounded interval.
            faults.lock_stall()
            if name is None:
                if len(self._live) != 1:
                    raise KeyError(
                        "model name required when "
                        f"{len(self._live)} models are registered "
                        f"(have {sorted(self._live)})")
                return next(iter(self._live.values()))
            try:
                return self._live[name]
            except KeyError:
                raise KeyError(f"no model {name!r} registered "
                               f"(have {sorted(self._live)})") from None

    def unregister(self, name: str) -> LoadedModel:
        with self._lock:
            try:
                entry = self._live.pop(name)
            except KeyError:
                raise KeyError(f"no model {name!r} registered") from None
            snap = self._journal_snapshot_locked()
        self._journal_publish(snap)
        return entry

    def names(self) -> list:
        with self._lock:
            return sorted(self._live)

    def entries(self) -> list:
        with self._lock:
            return list(self._live.values())

    def __len__(self) -> int:
        return len(self._live)

    def __contains__(self, name: str) -> bool:
        return name in self._live
