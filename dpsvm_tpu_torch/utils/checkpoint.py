"""Solver-state checkpoints and resume (counterpart of
dpsvm_tpu/utils/checkpoint.py; the same file format, so a checkpoint
written by either package resumes in the other).

The solver state is {alpha, f, iteration, b_hi, b_lo} plus the config
(JSON of every SVMConfig field), stored as .npz. FORMAT_VERSION history:

* v1 -- alpha / f / iteration / b_hi / b_lo / config. ``f`` is the
  EFFECTIVE gradient f - f_err, so a compensated resume restarts its
  Kahan residual at zero.
* v2 -- adds the optional ``f_err`` residual and the block engines'
  ``rounds`` counter. With raw ``f`` and ``f_err`` both present a
  compensated resume continues the uninterrupted carry exactly; a file
  without ``f_err`` behaves like v1. The port writes v2 with raw ``f``,
  ``f_err`` when compensated, and ``rounds`` on the block engines.
  The out-of-core solver's shrunken stream (solver/ooc.py) rides three
  OPTIONAL keys on the same version: ``shrink_demoted`` (the endgame
  demotion is permanent), ``shrink_gap`` (the last cycle-start gap,
  the stall test's baseline) and ``shrink_stall`` (the count of stalled
  cycles in a row). A file without them means "not shrinking".

DURABILITY: every write goes to a tmp file that is fsynced BEFORE the
rename publishes its name, and the directory is fsynced AFTER it, so
neither a killed process nor a power loss leaves a truncated file under
the checkpoint's name.

RETENTION: ``SVMConfig.checkpoint_keep = K`` keeps K rotating
generations (``path`` newest, ``path.1`` ... ``path.(K-1)`` oldest); a
resume falls back past unloadable or non-finite generations to the
newest good one, with a warning.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import NamedTuple, Optional

import numpy as np

from dpsvm_tpu_torch.config import SVMConfig
from dpsvm_tpu_torch.testing import faults

FORMAT_VERSION = 2

#: versions load_checkpoint accepts (newer-than-known fails loudly —
#: silently dropping fields a future writer relied on could corrupt a
#: resume).
_READABLE_VERSIONS = (1, 2)


class CheckpointState(NamedTuple):
    """One loaded checkpoint. ``f_err`` is None for v1 files and
    uncompensated runs; ``rounds`` is 0 where the writer predates it."""

    alpha: np.ndarray
    f: np.ndarray
    iteration: int
    b_hi: float
    b_lo: float
    config: SVMConfig
    f_err: Optional[np.ndarray]
    rounds: int
    format_version: int
    shrink_demoted: bool = False
    shrink_gap: Optional[float] = None
    shrink_stall: int = 0


def fsync_dir(path: str) -> None:
    """fsync a DIRECTORY: after an os.replace, the rename itself lives
    in the directory entry — without this a power loss can forget the
    rename while keeping the (already-fsynced) file data. Filesystems
    that refuse directory fsync (some network mounts) are skipped:
    they provide no such durability to lose."""
    try:
        dfd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(dfd)
    except OSError:
        pass
    finally:
        os.close(dfd)


def save_checkpoint(path: str, alpha, f, iteration: int, b_hi: float,
                    b_lo: float, config: SVMConfig, *, f_err=None,
                    rounds: Optional[int] = None,
                    shrink_demoted: Optional[bool] = None,
                    shrink_gap: Optional[float] = None,
                    shrink_stall: Optional[int] = None) -> None:
    """Atomic durable write (tmp + fsync + rename + dir fsync).
    ``f_err`` / ``rounds`` and the three shrink keys are the v2 extras;
    omitted ones are absent from the file."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        payload = dict(
            format_version=FORMAT_VERSION,
            alpha=np.asarray(alpha, np.float32),
            f=np.asarray(f, np.float32),
            iteration=np.int64(iteration),
            b_hi=np.float32(b_hi),
            b_lo=np.float32(b_lo),
            config_json=json.dumps(dataclasses.asdict(config)),
        )
        if f_err is not None:
            payload["f_err"] = np.asarray(f_err, np.float32)
        if rounds is not None:
            payload["rounds"] = np.int64(rounds)
        if shrink_demoted is not None:
            payload["shrink_demoted"] = np.bool_(shrink_demoted)
        if shrink_gap is not None:
            payload["shrink_gap"] = np.float64(shrink_gap)
        if shrink_stall is not None:
            payload["shrink_stall"] = np.int64(shrink_stall)
        with os.fdopen(fd, "wb") as fh:
            np.savez_compressed(fh, **payload)
            # The tmp file's bytes must be on disk before the rename
            # publishes its name.
            fh.flush()
            os.fsync(fh.fileno())
        # The ckpt_truncate seam: a preemption after the tmp bytes exist
        # and before the rename; the previous file at `path` must stay
        # intact.
        faults.damage_checkpoint(tmp)
        os.replace(tmp, path)
        fsync_dir(d)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint_state(path: str) -> CheckpointState:
    """Load any readable checkpoint version into the v2 state shape.
    A config that sets a field the port does not run (one the JAX package
    wrote) raises NotImplementedError naming its ROADMAP item."""
    z = np.load(path, allow_pickle=False)
    version = int(z["format_version"])
    if version not in _READABLE_VERSIONS:
        raise ValueError(
            f"unsupported checkpoint version {version} (this build "
            f"reads {_READABLE_VERSIONS})")
    config = SVMConfig(**json.loads(str(z["config_json"])))
    config.check_jax_only()
    return CheckpointState(
        alpha=z["alpha"].astype(np.float32),
        f=z["f"].astype(np.float32),
        iteration=int(z["iteration"]),
        b_hi=float(z["b_hi"]),
        b_lo=float(z["b_lo"]),
        config=config,
        f_err=(z["f_err"].astype(np.float32) if "f_err" in z.files
               else None),
        rounds=int(z["rounds"]) if "rounds" in z.files else 0,
        format_version=version,
        shrink_demoted=(bool(z["shrink_demoted"])
                        if "shrink_demoted" in z.files else False),
        shrink_gap=(float(z["shrink_gap"])
                    if "shrink_gap" in z.files else None),
        shrink_stall=(int(z["shrink_stall"])
                      if "shrink_stall" in z.files else 0),
    )


def load_checkpoint(path: str):
    """Returns (alpha, f, iteration, b_hi, b_lo, config) — the v1
    caller shape, valid for every readable version."""
    st = load_checkpoint_state(path)
    return (st.alpha, st.f, st.iteration, st.b_hi, st.b_lo, st.config)


class CheckpointCorrupt(ValueError):
    """A checkpoint that cannot be trusted (unreadable file or
    non-finite state) — the class the retention fallback skips past;
    COMPATIBILITY refusals (wrong n, wrong hyper-parameters) stay
    plain ValueError and always propagate: they are a caller error an
    older generation would share."""


def _check_integrity(st: CheckpointState, path: str) -> None:
    if not (np.isfinite(st.alpha).all() and np.isfinite(st.f).all()
            and (st.f_err is None or np.isfinite(st.f_err).all())):
        raise CheckpointCorrupt(
            f"checkpoint {path} holds non-finite solver state "
            "(corrupt or hand-edited — this repo's writers never "
            "persist non-finite state); refusing to resume it")


def _validate_restore(st: CheckpointState, path: str,
                      config: SVMConfig, n: int) -> None:
    """Refuse resumes that would silently corrupt the solution (the
    restored gradient f is only valid for the kernel/C it was computed
    under, and only for the same rows)."""
    if st.alpha.shape[0] != n:
        raise ValueError(
            f"checkpoint {path} holds state for n={st.alpha.shape[0]} "
            f"rows, but the current dataset has n={n}")
    _check_integrity(st, path)
    for field in ("c", "gamma", "kernel", "degree", "coef0", "epsilon"):
        if getattr(st.config, field) != getattr(config, field):
            raise ValueError(
                f"checkpoint {path} was written with {field}="
                f"{getattr(st.config, field)!r}, current run uses "
                f"{getattr(config, field)!r}; refusing to resume")


def checkpoint_generations(path: str) -> list:
    """The on-disk retention chain for `path`, NEWEST FIRST: the bare
    path, then the rotated ``.1``/``.2``/… generations
    (PeriodicCheckpointer's keep_last suffixes). Only existing files
    are returned."""
    cands = [path] + [f"{path}.{i}" for i in range(1, 100)]
    return [p for p in cands if os.path.exists(p)]


def resume_solver_state(path: Optional[str], config: SVMConfig, n: int):
    """Load + validate a solver checkpoint for resuming.

    Returns (alpha, f, iteration, b_hi, b_lo) or None when `path` is
    unset or missing. Raises ValueError when the checkpoint belongs to
    a different dataset size or incompatible hyper-parameters."""
    st = resume_state(path, config, n)
    if st is None:
        return None
    return st.alpha, st.f, st.iteration, st.b_hi, st.b_lo


def resume_state(path: Optional[str], config: SVMConfig,
                 n: int) -> Optional[CheckpointState]:
    """The full-carry resume: the validated CheckpointState including
    the v2 ``f_err``/``rounds`` extras, or None when `path` is unset and
    no generation of it exists.

    RETENTION FALLBACK: an unreadable or
    non-finite newest generation falls back — with a LOUD warning —
    to the next rotated generation (``path.1``, ``path.2``, …); only
    when every existing generation is corrupt does the resume fail.
    Compatibility refusals (wrong n, different hyper-parameters, a
    JAX-only setting the port does not run: NotImplementedError)
    propagate immediately: an older generation of the same run would
    refuse identically."""
    import warnings

    if not path:
        return None
    cands = checkpoint_generations(path)
    if not cands:
        return None
    last_err = None
    for cand in cands:
        try:
            st = load_checkpoint_state(cand)
            _check_integrity(st, cand)
        except NotImplementedError:
            raise
        except ValueError as e:
            # CheckpointCorrupt, bad format_version, truncated npz
            # (np.load raises ValueError/OSError/BadZipFile subclasses
            # of these)…
            warnings.warn(
                f"checkpoint generation {cand!r} is UNUSABLE "
                f"({type(e).__name__}: {e}); trying the next "
                "retention generation", stacklevel=2)
            last_err = e
            continue
        except Exception as e:
            warnings.warn(
                f"checkpoint generation {cand!r} is UNREADABLE "
                f"({type(e).__name__}: {e}); trying the next "
                "retention generation", stacklevel=2)
            last_err = e
            continue
        _validate_restore(st, cand, config, n)
        if cand != path:
            warnings.warn(
                f"RESUMING FROM OLDER CHECKPOINT GENERATION {cand!r} "
                f"(newest {path!r} was missing or corrupt): up to "
                "checkpoint_every iterations of progress are being "
                "redone — expected after a fault that corrupted the "
                "newest generation, alarming otherwise", stacklevel=2)
        return st
    raise ValueError(
        f"every checkpoint generation of {path!r} is unloadable "
        f"({len(cands)} tried); refusing to silently start fresh — "
        f"remove them explicitly to do that (last error: {last_err})"
    ) from last_err


class PeriodicCheckpointer:
    """Chunk-cadence checkpoint trigger shared by all solver backends.

    ``config.checkpoint_keep = K`` (default 1: overwrite in place) keeps
    K rotating generations: each save first shifts ``path -> path.1 ->
    ... -> path.(K-1)`` and then writes the new state at ``path``, so a
    save that dies between the tmp write and the rename still leaves an
    older restorable generation for ``resume_state``'s fallback."""

    def __init__(self, path: Optional[str], config: SVMConfig, start_iter: int = 0):
        self.path = path
        self.config = config
        self.every = config.checkpoint_every
        self.keep = getattr(config, "checkpoint_keep", 1)
        self.last = start_iter

    @property
    def active(self) -> bool:
        """Whether this checkpointer can ever save (callers use this to
        skip materialising device arrays on hot paths)."""
        return bool(self.path and self.every > 0)

    def due(self, iteration: int) -> bool:
        return self.active and iteration - self.last >= self.every

    def save(self, iteration: int, alpha, f, b_hi: float, b_lo: float,
             force: bool = False, f_err=None,
             rounds: Optional[int] = None,
             shrink_demoted: Optional[bool] = None,
             shrink_gap: Optional[float] = None,
             shrink_stall: Optional[int] = None) -> bool:
        """Save when the cadence is due, or unconditionally with
        ``force`` (abort exits: the state being stopped at must not
        exist only in memory). ``f_err``/``rounds`` and the shrink keys
        (``shrink_demoted``, ``shrink_gap``, ``shrink_stall``) ride
        through to the v2 payload when the caller carries them.

        Non-finite state is never persisted: the block engines' observed
        extrema lag the fold by one round, so the round that blows up the
        gradient would otherwise write a NaN checkpoint under
        finite-looking extrema. Skipping keeps the last good one."""
        if not (self.active and (force or self.due(iteration))):
            return False
        alpha = np.asarray(alpha)
        f = np.asarray(f)
        f_err = None if f_err is None else np.asarray(f_err)
        if not (np.isfinite(alpha).all() and np.isfinite(f).all()
                and (f_err is None or np.isfinite(f_err).all())):
            import warnings

            warnings.warn(
                f"checkpoint at iteration {iteration} SKIPPED: solver "
                "state holds non-finite values (gradient blow-up); the "
                "previous checkpoint is kept as the restore point",
                stacklevel=3)
            return False
        self._rotate()
        save_checkpoint(self.path, alpha, f, iteration, b_hi, b_lo,
                        self.config, f_err=f_err, rounds=rounds,
                        shrink_demoted=shrink_demoted, shrink_gap=shrink_gap,
                        shrink_stall=shrink_stall)
        self.last = iteration
        return True

    def _rotate(self) -> None:
        """Shift the retention chain one slot older (newest last to
        move, so a crash mid-rotation still leaves a contiguous
        newest-first chain for the resume fallback), then prune
        generations past `keep` — stale suffixes left by a reduced
        keep must not become surprise fallback targets."""
        if self.keep > 1 and os.path.exists(self.path):
            for i in range(self.keep - 1, 0, -1):
                src = self.path if i == 1 else f"{self.path}.{i - 1}"
                if os.path.exists(src):
                    os.replace(src, f"{self.path}.{i}")
        i = max(self.keep, 1)
        while os.path.exists(f"{self.path}.{i}"):
            os.unlink(f"{self.path}.{i}")
            i += 1
