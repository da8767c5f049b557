"""DeviceProfile: the committed, versioned measurement artifact that
decides the solvers' auto gates (counterpart of
dpsvm_tpu/autotune/profile.py).

The autotune pass (autotune/probes.py) runs once per device kind; its
verdicts persist as one JSON file per device kind under
``dpsvm_tpu_torch/autotune/profiles/`` (committed; torch-version
stamped), and the gate helpers in solver/block.py resolve
``None``-valued config knobs from the profile for the CURRENT device
kind, with full provenance (profile file, probe ratio, threshold) in
``SolveResult.stats['autotune']`` and the run-log manifest.

The contract: the autotuner changes *decisions*, never *programs*.
With no applicable profile :func:`gate_decision` returns None and the
gates fall back to their defaults (OFF for every profile-gated knob in
the port). A profile's decision can only be True when its probe was
AUTHORITATIVE (measured on a CUDA card, where the kernels run; not the
CPU harness, where every kernel wrapper runs its plain version), so the
committed CPU profile resolves to the same OFF decisions as no profile
at all, while recording the measured ratios.

Resolution order for the active profile (first hit wins):

1. an in-process override installed via :func:`use_profile` (tests,
   A/B harnesses);
2. ``DPSVM_AUTOTUNE_PROFILE``: an explicit profile file path
   (``0``/``off`` disables profiles entirely);
3. ``<profiles dir>/<slug(device_kind)>.json`` where the profiles dir
   is ``DPSVM_AUTOTUNE_DIR`` or the committed package directory.

A profile whose stamped torch major.minor differs from the running
torch is REFUSED (warned once, treated as absent): probe verdicts are
properties of the built kernels and the library around them. A profile
without a ``torch`` stamp (the JAX package's, stamped ``jax``) is
refused the same way, and so is one measured on another device kind.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
import warnings
from typing import Optional

import torch

#: schema of the profile JSON; bump on incompatible shape changes.
#: Readers refuse NEWER schemas explicitly (the run-log discipline).
PROFILE_SCHEMA = 1

#: pays-verdict threshold per gated knob: the B variant must measure at
#: or under this fraction of the A variant's seconds before an
#: AUTHORITATIVE probe flips the knob on. Well inside the
#: solve-to-solve spread of the card, so a wash never flips a gate.
PAYS_THRESHOLD = 0.90

_MISSING = object()
_override = _MISSING  # use_profile() in-process override
_cache: dict = {}  # device_kind -> (source_key, profile_or_None)
_warned: set = set()


class ProfileError(ValueError):
    """A profile file exists but cannot be honored (bad schema, bad
    JSON shape, the honesty rule broken). Distinct from 'absent', which
    is never an error."""


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """One device kind's measured probe results and gate decisions."""

    device_kind: str
    backend: str
    n_devices: int
    torch: str
    utc: str
    git_sha: str
    seed: int
    #: probe name -> full probe record (shapes, seed, a/b seconds,
    #: ratio, threshold, authoritative, verdict, note; with several
    #: passes also passes, ratios and spread).
    probes: dict
    #: config knob -> bool (the gate resolution input). Only knobs the
    #: pass measured appear; absent knobs fall back to the defaults.
    decisions: dict
    schema: int = PROFILE_SCHEMA
    path: Optional[str] = None  # where this profile was loaded from

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("path")
        return d

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(self.to_json(), fh, indent=1, sort_keys=True)
            fh.write("\n")
        os.replace(tmp, path)  # atomic: readers never see a torn file
        return path


def slug(device_kind: str) -> str:
    """Filesystem name for a device kind:
    'NVIDIA H100 80GB HBM3' -> 'nvidia-h100-80gb-hbm3'."""
    s = "".join(c if c.isalnum() else "-" for c in device_kind.lower())
    while "--" in s:
        s = s.replace("--", "-")
    return s.strip("-") or "unknown"


def profiles_dir() -> str:
    """The profile directory: DPSVM_AUTOTUNE_DIR or the committed
    package dir (dpsvm_tpu_torch/autotune/profiles)."""
    return (os.environ.get("DPSVM_AUTOTUNE_DIR")
            or os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "profiles"))


def profile_path(device_kind: str) -> str:
    return os.path.join(profiles_dir(), f"{slug(device_kind)}.json")


def load_profile(path: str) -> DeviceProfile:
    """Parse and validate one profile file. Raises ProfileError on a
    malformed or newer-schema file, or one that breaks the honesty rule
    (a committed artifact this build cannot honor must fail loudly, not
    half-apply)."""
    with open(path) as fh:
        doc = json.load(fh)
    if not isinstance(doc, dict):
        raise ProfileError(f"{path}: profile must be a JSON object")
    try:
        schema = int(doc.get("schema", 0))
    except (TypeError, ValueError):
        raise ProfileError(f"{path}: non-integer schema") from None
    if schema > PROFILE_SCHEMA:
        raise ProfileError(
            f"{path}: profile schema {schema} is newer than this "
            f"build's {PROFILE_SCHEMA}; regenerate with autotune run")
    missing = {"device_kind", "torch", "probes", "decisions"} - doc.keys()
    if missing:
        raise ProfileError(f"{path}: missing fields {sorted(missing)}")
    if not isinstance(doc["probes"], dict) \
            or not isinstance(doc["decisions"], dict):
        raise ProfileError(f"{path}: probes/decisions must be objects")
    try:
        prof = DeviceProfile(
            device_kind=str(doc["device_kind"]),
            backend=str(doc.get("backend", "")),
            n_devices=int(doc.get("n_devices", 0)),
            torch=str(doc["torch"]),
            utc=str(doc.get("utc", "")),
            git_sha=str(doc.get("git_sha", "")),
            seed=int(doc.get("seed", 0)),
            probes=dict(doc["probes"]),
            decisions={k: bool(v) for k, v in doc["decisions"].items()},
            schema=schema,
            path=path,
        )
    except (TypeError, ValueError) as e:
        # A malformed field (e.g. "n_devices": null) surfaces as the
        # refusal contract (active_profile warns once and treats the
        # file as absent), never as a crashed solve.
        raise ProfileError(f"{path}: malformed field ({e})") from None
    # THE HONESTY RULE, enforced at LOAD: a True decision must be backed
    # by an authoritative True-verdict probe for the same knob. A
    # hand-edited or corrupted artifact that breaks it is refused whole.
    for knob, dec in prof.decisions.items():
        if not dec:
            continue
        rec = next((p for p in prof.probes.values()
                    if p.get("knob") == knob), None)
        if (rec is None or rec.get("skipped")
                or not rec.get("authoritative")
                or not rec.get("verdict")):
            raise ProfileError(
                f"{path}: decision {knob}=true is not backed by an "
                "authoritative True-verdict probe (the honesty rule); "
                "regenerate with autotune run")
        # A record of several passes (probes.py agree) pays only where
        # every pass paid.
        thr = rec.get("threshold", PAYS_THRESHOLD)
        if any(r is None or r > thr for r in rec.get("ratios", ())):
            raise ProfileError(
                f"{path}: decision {knob}=true but a pass of its probe "
                f"read ratios {rec['ratios']} against threshold {thr} "
                "(the honesty rule); regenerate with autotune run")
    return prof


def _minor(version: str) -> str:
    return ".".join(str(version).split(".")[:2])


def torch_compatible(profile: DeviceProfile) -> bool:
    """Version-skew refusal: a profile stamped by a different torch
    major.minor is stale."""
    return _minor(profile.torch) == _minor(torch.__version__)


def _warn_once(key: str, msg: str) -> None:
    if key not in _warned:
        _warned.add(key)
        warnings.warn(msg, stacklevel=3)


def device_kind_of(device) -> str:
    """THE device-kind keying rule, shared by every writer that must
    agree on the string (profile resolution here, the solvers' gate
    provenance, the run-log manifest): the card's name on CUDA
    (``torch.cuda.get_device_properties(dev).name``), "cpu" elsewhere."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).name
    return "cpu"


def current_device_kind(device=None) -> str:
    """device_kind_of the device an entry point would run on (the CUDA
    card unless `device` names another; raises without one)."""
    from dpsvm_tpu_torch.device import resolve_device

    return device_kind_of(resolve_device(device))


@contextlib.contextmanager
def use_profile(profile):
    """In-process override for tests and A/B harnesses:
    ``use_profile(None)`` forces the no-profile behavior even when a
    committed profile exists for this device kind;
    ``use_profile(DeviceProfile(...))`` or ``use_profile(path)``
    installs one regardless of device kind."""
    global _override
    prev = _override
    _override = (load_profile(profile) if isinstance(profile, str)
                 else profile)
    _cache.clear()
    try:
        yield
    finally:
        _override = prev
        _cache.clear()


def active_profile(device_kind: Optional[str] = None):
    """The profile governing gate decisions for `device_kind` (default:
    the card's), or None. Cached per device kind and invalidated when
    the source file changes: the lookup sits on the solve path and stays
    at one os.stat and a dict read."""
    if _override is not _MISSING:
        return _override
    env = os.environ.get("DPSVM_AUTOTUNE_PROFILE")
    if env is not None and env.strip().lower() in ("", "0", "off"):
        return None
    if device_kind is None:
        device_kind = current_device_kind()
    path = env or profile_path(device_kind)
    # One stat per lookup (it is what detects a freshly written
    # profile); the cache key holds the mtime (None = absent), so both
    # the loaded and the absent case hit without re-parsing.
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        mtime = None
    key = (path, mtime)
    hit = _cache.get(device_kind)
    if hit is not None and hit[0] == key:
        return hit[1]
    if mtime is None:
        _cache[device_kind] = (key, None)
        return None
    prof: Optional[DeviceProfile]
    try:
        prof = load_profile(path)
    except (ProfileError, OSError, json.JSONDecodeError) as e:
        _warn_once(f"bad:{path}", f"autotune profile {path} refused "
                                  f"({e}); gates use defaults")
        prof = None
    if prof is not None and prof.device_kind != device_kind:
        _warn_once(f"kind:{path}",
                   f"autotune profile {path} was measured on "
                   f"{prof.device_kind!r}, not {device_kind!r}; "
                   "refusing it: gates use defaults")
        prof = None
    if prof is not None and not torch_compatible(prof):
        _warn_once(f"torch:{path}",
                   f"autotune profile {path} was measured under torch "
                   f"{prof.torch}, running {torch.__version__}; refusing "
                   "it: rerun autotune run on this torch")
        prof = None
    _cache[device_kind] = (key, prof)
    return prof


def gate_decision(knob: str,
                  device_kind: Optional[str] = None) -> Optional[dict]:
    """The active profile's resolution of one auto-gated config knob:
    ``{"decision", "profile", "device_kind", "probe", "ratio",
    "threshold", "authoritative"}`` (the provenance record the solvers
    embed in SolveResult.stats), or None when no applicable profile (or
    the profile never measured this knob)."""
    prof = active_profile(device_kind)
    if prof is None or knob not in prof.decisions:
        return None
    rec = next((p for p in prof.probes.values()
                if p.get("knob") == knob), {})
    return {
        "decision": bool(prof.decisions[knob]),
        "profile": prof.path or "<in-process>",
        "device_kind": prof.device_kind,
        "probe": rec.get("probe"),
        "ratio": rec.get("ratio"),
        "threshold": rec.get("threshold"),
        "authoritative": rec.get("authoritative"),
    }


def stamp(device) -> dict:
    """The identity fields of a profile freshly measured on `device`."""
    from dpsvm_tpu_torch.obs.runlog import git_sha

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    return {
        "device_kind": device_kind_of(dev),
        "backend": "gpu" if cuda else "cpu",
        "n_devices": torch.cuda.device_count() if cuda else 1,
        "torch": torch.__version__,
        "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "git_sha": git_sha(),
    }
