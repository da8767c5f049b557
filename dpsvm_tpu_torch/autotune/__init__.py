"""dpsvm_tpu_torch.autotune: measured device profiling for the solvers'
auto gates (counterpart of dpsvm_tpu/autotune).

* :mod:`~dpsvm_tpu_torch.autotune.probe`   the shared A/B measurement
  core (salted starts, differenced whole-chunk timing);
* :mod:`~dpsvm_tpu_torch.autotune.probes`  one seeded micro-probe per
  gated knob (pipeline / fused_round / ooc_shrink / shardlocal /
  pipeline_mesh / ring / serve_buckets, plus the informational
  bf16_gram and serve_quant), each mirrored into an ``autotune`` run
  log as a ``probe`` record;
* :mod:`~dpsvm_tpu_torch.autotune.profile` the committed
  ``DeviceProfile`` JSON (one per device kind, torch-version stamped)
  and the gate-decision lookup solver/block.py's
  :func:`~dpsvm_tpu_torch.solver.block.resolve_auto_gate` consults.

CLI: ``python -m dpsvm_tpu_torch.cli autotune {run,show,diff}`` (cli.py
forwards argv verbatim to :func:`run_cli`, as it forwards ``obs``).

The contract, pinned by tests/test_torch_autotune.py: the autotuner
changes *decisions*, never *programs*. No applicable profile means every
gate takes its default, and the CPU profile (non-authoritative probes)
resolves to those same defaults while recording measured ratios and
provenance.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

from dpsvm_tpu_torch.autotune.probe import (differenced_rounds, salted,
                                            timed_loop)
from dpsvm_tpu_torch.autotune.probes import PROBE_KNOBS, PROBES, run_probes
from dpsvm_tpu_torch.autotune.profile import (DeviceProfile, ProfileError,
                                              active_profile, gate_decision,
                                              load_profile, profile_path,
                                              profiles_dir, slug,
                                              torch_compatible, use_profile)

__all__ = [
    "DeviceProfile", "ProfileError", "PROBES", "PROBE_KNOBS",
    "active_profile", "differenced_rounds", "gate_decision",
    "load_profile", "profile_path", "profiles_dir", "run_cli",
    "run_probes", "salted", "stable_view", "timed_loop", "use_profile",
]

#: probe-record fields that must be byte-stable across two passes with
#: the same seed on the same harness (the determinism contract of
#: ``autotune run --smoke``; timings legitimately jitter).
STABLE_PROBE_FIELDS = ("probe", "knob", "shapes", "seed", "a", "b",
                       "threshold", "authoritative", "skipped", "unit",
                       "n_devices", "sync_rounds", "passes")

#: passes of a full `autotune run` on the card (a verdict needs every
#: pass to agree, probes.py agree); one elsewhere, where every verdict
#: is pinned False.
CARD_PASSES = 3


def stable_view(profile: DeviceProfile) -> dict:
    """The deterministic projection of a profile: everything but the
    measured seconds and ratios and the identity timestamp."""
    return {
        "device_kind": profile.device_kind,
        "backend": profile.backend,
        "n_devices": profile.n_devices,
        "seed": profile.seed,
        "decisions": dict(profile.decisions),
        "probes": {name: {k: rec[k] for k in STABLE_PROBE_FIELDS
                          if k in rec}
                   for name, rec in profile.probes.items()},
    }


def _decision_table(profile: DeviceProfile) -> str:
    lines = [f"{'probe':<14} {'knob':<20} {'ratio':>8} {'spread':>7} "
             f"{'thr':>5} {'auth':>5} {'verdict':>7}",
             "-" * 72]
    for name, rec in profile.probes.items():
        if rec.get("skipped"):
            lines.append(f"{name:<14} {str(rec.get('knob')):<20} "
                         f"{'skipped: ' + rec['skipped']}")
            continue
        rr, sp = rec.get("ratio"), rec.get("spread")
        lines.append(
            f"{name:<14} {str(rec.get('knob')):<20} "
            f"{f'{rr:.3f}' if rr is not None else '-':>8} "
            f"{f'{sp:.3f}' if sp is not None else '-':>7} "
            f"{rec.get('threshold', 0):>5.2f} "
            f"{str(rec.get('authoritative')):>5} "
            f"{str(rec.get('verdict')):>7}")
    lines.append("")
    lines.append("decisions: " + (", ".join(
        f"{k}={v}" for k, v in sorted(profile.decisions.items()))
        or "(none)"))
    return "\n".join(lines)


def _merge_partial(fresh: DeviceProfile, path: str) -> DeviceProfile:
    """Merge a pass into the existing profile at `path`: the fresh
    probes and decisions overlay the old ones, so re-probing one knob
    cannot silently drop every OTHER measured decision of the device
    kind. Refuses to blend across device kinds or a torch skew: a stale
    base must be re-measured whole, not patched."""
    old = load_profile(path)
    if old.device_kind != fresh.device_kind:
        raise ProfileError(
            f"{path}: partial run measured {fresh.device_kind!r} but "
            f"the existing profile is for {old.device_kind!r}; refusing "
            "to merge: use --out or run the full pass")
    if not torch_compatible(old):
        raise ProfileError(
            f"{path}: existing profile was measured under torch "
            f"{old.torch}; a partial pass cannot be merged over a "
            "version-skewed base: rerun the full autotune run")
    # A SKIPPED fresh probe carries no new information: keep the old
    # MEASURED record (and its surviving decision) instead of letting
    # the skip clobber it, or a one-card pass would leave e.g.
    # ring_exchange=True backed by a skipped probe.
    overlay = {name: rec for name, rec in fresh.probes.items()
               if not (rec.get("skipped")
                       and name in old.probes
                       and not old.probes[name].get("skipped"))}
    return dataclasses.replace(
        fresh,
        probes={**old.probes, **overlay},
        decisions={**old.decisions, **fresh.decisions})


def _maybe_merge(prof: DeviceProfile, out: str,
                 partial: bool) -> DeviceProfile:
    """The save-path merge policy. EVERY pass merges over a compatible
    existing profile at `out` (a full pass on a one-card host skips the
    mesh probes, and without the merge the save would drop decisions a
    several-card host measured). An incompatible existing file (torch
    skew, another device kind) refuses a partial pass but is REPLACED
    by a full pass: complete re-measurement is the regeneration path."""
    if not os.path.exists(out):
        return prof
    try:
        merged = _merge_partial(prof, out)
    except ProfileError:
        if partial:
            raise
        print(f"[autotune] replacing incompatible existing {out} "
              "(full pass = regeneration)", file=sys.stderr)
        return prof
    retained = set(merged.probes) - set(prof.probes) | {
        n for n in prof.probes
        if prof.probes[n].get("skipped")
        and not merged.probes[n].get("skipped")}
    print(f"[autotune] merged over existing {out}"
          + (f" (previously measured records retained: "
             f"{','.join(sorted(retained))})" if retained else ""),
          file=sys.stderr)
    return merged


def _cmd_run(args) -> int:
    from dpsvm_tpu_torch.config import ObsConfig

    ocfg = ObsConfig(enabled=args.obs, runlog_dir=args.obs_dir)
    from dpsvm_tpu_torch.device import resolve_device

    knobs = ([k for k in args.knobs.split(",") if k]
             if args.knobs else None)
    passes = (CARD_PASSES if resolve_device(args.device).type == "cuda"
              and not args.smoke else 1)
    prof = run_probes(knobs=knobs, seed=args.seed, smoke=args.smoke,
                      obs_config=ocfg, device=args.device, passes=passes)
    if args.smoke:
        # Determinism contract: a second pass with the same seed must
        # give byte-identical stable fields and decisions.
        prof2 = run_probes(knobs=knobs, seed=args.seed, smoke=True,
                           obs_config=ocfg, verbose=False,
                           device=args.device, passes=passes)
        a, b = stable_view(prof), stable_view(prof2)
        if any(p.get("authoritative") for p in prof.probes.values()):
            # On the card the verdicts derive from timing ratios and may
            # straddle the threshold between two passes: the contract
            # covers the record structure there, not the measurements.
            a.pop("decisions")
            b.pop("decisions")
            print("[autotune] smoke on a CUDA card: decisions excluded "
                  "from the determinism check (timing-derived)",
                  file=sys.stderr)
        if a != b:
            print("[autotune] DETERMINISM FAIL:\n"
                  f"  first : {json.dumps(a, sort_keys=True)}\n"
                  f"  second: {json.dumps(b, sort_keys=True)}",
                  file=sys.stderr)
            return 1
        print("[autotune] smoke determinism: PASS (stable fields + "
              "decisions identical across two passes)", file=sys.stderr)
    if args.out:
        out = args.out
    elif args.smoke:
        import tempfile

        out = os.path.join(tempfile.mkdtemp(prefix="dpsvm_autotune_"),
                           f"{slug(prof.device_kind)}.json")
    else:
        out = profile_path(prof.device_kind)
    prof = _maybe_merge(prof, out, partial=knobs is not None)
    prof.save(out)
    # What was just written must load back clean (the schema and the
    # honesty rule).
    load_profile(out)
    print(_decision_table(prof))
    print(f"[autotune] wrote {out} (device_kind={prof.device_kind!r}, "
          f"torch {prof.torch})", file=sys.stderr)
    return 0


def _cmd_show(args) -> int:
    if args.path:
        prof = load_profile(args.path)
        src = args.path
    else:
        from dpsvm_tpu_torch.autotune.profile import current_device_kind

        kind = current_device_kind(args.device)
        prof = active_profile(kind)
        if prof is None:
            print(f"no active profile for device kind {kind!r} "
                  f"(looked at {profile_path(kind)}); gates use their "
                  "defaults (OFF)")
            return 1
        src = prof.path or "<in-process>"
    print(f"profile: {src}")
    print(f"device_kind={prof.device_kind!r} backend={prof.backend} "
          f"n_devices={prof.n_devices} torch={prof.torch} "
          f"utc={prof.utc} git={prof.git_sha[:12]}")
    print(_decision_table(prof))
    if args.json:
        print(json.dumps(prof.to_json(), sort_keys=True))
    return 0


def _cmd_diff(args) -> int:
    a, b = load_profile(args.a), load_profile(args.b)
    print(f"A: {args.a} ({a.device_kind!r}, torch {a.torch}, {a.utc})")
    print(f"B: {args.b} ({b.device_kind!r}, torch {b.torch}, {b.utc})")
    moved = 0
    for name in sorted(set(a.probes) | set(b.probes)):
        ra, rb = a.probes.get(name), b.probes.get(name)
        if ra is None or rb is None:
            moved += 1
            print(f"  {name:<14} only in {'B' if ra is None else 'A'}")
            continue
        va, vb = ra.get("verdict"), rb.get("verdict")
        qa, qb = ra.get("ratio"), rb.get("ratio")
        mark = " <-- verdict moved" if va != vb else ""
        if va != vb or qa != qb:
            moved += 1
            spread = ""
            if "spread" in ra or "spread" in rb:
                spread = (f" (spread {ra.get('spread')} -> "
                          f"{rb.get('spread')})")
            print(f"  {name:<14} ratio {qa} -> {qb}{spread}, "
                  f"verdict {va} -> {vb}{mark}")
    da, db = a.decisions, b.decisions
    for knob in sorted(set(da) | set(db)):
        if da.get(knob) != db.get(knob):
            print(f"  decision {knob}: {da.get(knob)} -> {db.get(knob)}")
    if not moved:
        print("  no probe drift (ratios + verdicts identical)")
    return 0


def run_cli(argv=None) -> int:
    """``cli autotune`` (argv forwarded verbatim from cli.py)."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="dpsvm-tpu-torch autotune",
        description="measured device profiling for the solvers' auto "
                    "gates (dpsvm_tpu_torch/autotune)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser(
        "run", help="run the probe registry on the device and persist a "
                    "DeviceProfile JSON (default: the committed profiles "
                    "dir; commit the diff)")
    rp.add_argument("--out", default=None,
                    help="profile path override (default: dpsvm_tpu_torch/"
                         "autotune/profiles/<device>.json; --smoke "
                         "defaults to a temp file)")
    rp.add_argument("--knobs", default=None,
                    help="comma list of probe names to run (default: all "
                         f"of {','.join(PROBES)})")
    rp.add_argument("--seed", type=int, default=0)
    rp.add_argument("--smoke", action="store_true",
                    help="tiny-shape pass: probe twice, check the stable "
                         "record fields + decisions are deterministic, "
                         "write to a temp profile")
    rp.add_argument("--obs", action="store_true",
                    help="mirror every probe record into an 'autotune' "
                         "run log (DPSVM_OBS=1 equivalent)")
    rp.add_argument("--obs-dir", default=None)
    rp.add_argument("--device", default=None,
                    help="torch device to probe (default: the CUDA card; "
                         "'cpu' runs the non-authoritative CPU harness)")

    sp = sub.add_parser(
        "show", help="print the active profile for this device kind (or "
                     "an explicit file) with its decisions")
    sp.add_argument("path", nargs="?", default=None)
    sp.add_argument("--json", action="store_true")
    sp.add_argument("--device", default=None,
                    help="whose device kind to look up (default: the CUDA "
                         "card)")

    dp = sub.add_parser(
        "diff", help="compare two profile files: ratio and verdict drift "
                     "per probe, decision flips")
    dp.add_argument("a")
    dp.add_argument("b")

    args = ap.parse_args(argv)
    try:
        if args.cmd == "run":
            return _cmd_run(args)
        if args.cmd == "show":
            return _cmd_show(args)
        return _cmd_diff(args)
    except (ProfileError, OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
