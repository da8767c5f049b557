"""Runlog analytics (counterpart of dpsvm_tpu/obs/analyze.py): turn the
run logs' records into answers. It reads the run logs of either package
(one schema, obs/runlog.py):

* :func:`load_runs` / :func:`summarize_run` — parse one or many runlog
  JSONL files (or directories of them) into per-run summaries:
  convergence diagnostics (gap trajectory, stall windows, pairs/s per
  chunk), per-phase wall-clock breakdown, compile records.
* :func:`report` — the aggregate table (text or markdown — the
  markdown mode is what CI renders into the GitHub job summary).
* :func:`diff_runs` — attribute a regression between two runs to the
  phase that moved (the Catanzaro/ThunderSVM-style per-phase
  attribution PAPERS.md describes), plus headline pairs/s and compile
  deltas.
* :func:`tail_records` — the last N records of a stream, one line per
  record (the `kubectl logs`-shaped view for live runs).

CLI surface: ``python -m dpsvm_tpu_torch.cli obs {report,diff,tail}``
(cli.py forwards argv verbatim to :func:`run_cli`).

Everything here is a pure reader of JSONL already on disk, with no
device work, so it runs anywhere the files land.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import List, Optional

from dpsvm_tpu_torch.obs.runlog import read_runlog

#: a chunk "stalls" when its gap fails to shrink by at least this
#: relative amount vs the previous chunk — consecutive stalled chunks
#: form a stall window (the diagnostic that catches working-set cycling
#: long before max_iter does).
STALL_REL_TOL = 1e-3


@dataclasses.dataclass
class Run:
    """One run's records, split by kind (stream order preserved)."""

    path: str
    run_id: str
    manifest: dict
    chunks: list
    events: list
    compiles: list
    final: Optional[dict]


def runlog_paths(paths) -> List[str]:
    """Expand files/directories/globs into a sorted runlog file list
    (directories scan for *.jsonl)."""
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(glob.glob(os.path.join(p, "*.jsonl"))))
        elif os.path.exists(p):
            out.append(p)
        else:
            # Globs can match subdirectories; only files are streams.
            hits = [h for h in sorted(glob.glob(p)) if os.path.isfile(h)]
            if not hits:
                raise FileNotFoundError(f"no runlog at {p!r}")
            out.extend(hits)
    return out


def load_runs(paths) -> List[Run]:
    """Every run found in `paths` (files, dirs or globs), in (file,
    stream) order. Runs interleaved in one file — concurrent writers
    share the per-(tool, pid) stream — are separated by run id."""
    runs: List[Run] = []
    for path in runlog_paths(paths):
        by_id: dict = {}
        order: list = []
        for rec in read_runlog(path):
            rid = rec["run"]
            if rid not in by_id:
                by_id[rid] = Run(path=path, run_id=rid, manifest={},
                                 chunks=[], events=[], compiles=[],
                                 final=None)
                order.append(rid)
            run = by_id[rid]
            kind = rec["kind"]
            if kind == "manifest":
                run.manifest = rec
            elif kind == "chunk":
                run.chunks.append(rec)
            elif kind == "event":
                run.events.append(rec)
            elif kind == "compile":
                run.compiles.append(rec)
            elif kind == "final":
                run.final = rec
        runs.extend(by_id[rid] for rid in order)
    return runs


def _stall_windows(chunks) -> dict:
    """Consecutive-chunk windows where the gap failed to shrink by
    STALL_REL_TOL relative — {count, longest} (in chunks)."""
    windows, longest, cur = 0, 0, 0
    prev_gap = None
    for c in chunks:
        gap = c.get("gap")
        if gap is None:
            continue
        if prev_gap is not None and not (
                gap <= prev_gap * (1.0 - STALL_REL_TOL)):
            cur += 1
            if cur == 1:
                windows += 1
            longest = max(longest, cur)
        else:
            cur = 0
        prev_gap = gap
    return {"count": windows, "longest": longest}


def summarize_run(run: Run) -> dict:
    """Flat JSON-able summary of one run: identity, convergence
    diagnostics, throughput, per-phase breakdown, compile accounting."""
    man, fin = run.manifest, run.final or {}
    pairs = sum(c.get("pairs_delta", 0) for c in run.chunks)
    dev_s = sum(c.get("device_seconds", 0.0) for c in run.chunks)
    pps = [c["pairs_delta"] / c["device_seconds"]
           for c in run.chunks
           if c.get("device_seconds") and c.get("pairs_delta", 0) > 0]
    gaps = [c["gap"] for c in run.chunks if "gap" in c]
    phases = fin.get("phase_seconds") or {}
    out = {
        "path": run.path,
        "run": run.run_id,
        "tool": man.get("tool", "?"),
        "utc": man.get("utc"),
        "git_sha": (man.get("git_sha") or "")[:12] or None,
        "engine": man.get("engine"),
        # Replica identity: which engine of a ReplicaFleet
        # wrote this run log; None for standalone engines and the
        # fleet's own aggregate run.
        "replica": man.get("replica"),
        "replicas": fin.get("replicas") or man.get("replicas"),
        "n": man.get("n"), "d": man.get("d"),
        "n_devices": man.get("n_devices"),
        "chunks": len(run.chunks),
        "pairs": pairs,
        "device_seconds": round(dev_s, 6),
        "pairs_per_second": round(pairs / dev_s) if dev_s else None,
        "chunk_pairs_per_second": {
            "min": round(min(pps)), "max": round(max(pps)),
        } if pps else None,
        "gap_first": gaps[0] if gaps else None,
        "gap_last": gaps[-1] if gaps else None,
        "stalls": _stall_windows(run.chunks),
        "events": [e.get("name") for e in run.events],
        "compiles": len(run.compiles),
        "compile_seconds": round(sum(c.get("seconds", 0.0)
                                     for c in run.compiles), 6),
        "converged": fin.get("converged"),
        "iterations": fin.get("iterations"),
        "wall_seconds": fin.get("wall_seconds"),
        "aborted": bool(fin.get("aborted")) if fin else None,
        "finished": run.final is not None,
        "phase_seconds": phases or None,
        # Kernel-row cache accounting. Both the per-pair LRU and the
        # ooc block cache report through the same final-record fields;
        # None when the run carried no cache.
        "cache_hit_rate": fin.get("cache_hit_rate"),
        "cache_hits": fin.get("cache_hits"),
        "cache_lookups": fin.get("cache_lookups"),
        "cache_evictions": fin.get("cache_evictions"),
        "tiles_streamed": fin.get("tiles_streamed"),
        # Shrunken-stream accounting: the ooc solver's
        # active-set shrinking — active-view fraction of n, full-stream
        # reconstructions, and the tiles/bytes the live-tile skip never
        # streamed; None/absent when the run carried no shrinking.
        "ooc_shrink": fin.get("ooc_shrink"),
        "shrink_active_fraction": fin.get("shrink_active_fraction"),
        "shrink_reconstructions": fin.get("shrink_reconstructions"),
        "shrink_demoted": fin.get("shrink_demoted"),
        "tiles_skipped": fin.get("tiles_skipped"),
        "tile_bytes_skipped": fin.get("tile_bytes_skipped"),
        # Fault-tolerance accounting: counts of
        # the fault-story event records — injected/real transient
        # faults, retry attempts, safe-config demotions, journal
        # rehydrates — so a run's recovery history reads off the
        # report table.
        "fault_events": {
            name: sum(1 for e in run.events if e.get("name") == name)
            for name in ("fault", "retry", "demotion", "rehydrate",
                         "dispatch_failed", "resume")
        },
        # Serving-engine accounting: the v2
        # engine's final record carries its scheduler counters; None
        # for solver runs (and v1 serve runs, which predate them).
        "deadline_misses": fin.get("deadline_misses"),
        "expired": fin.get("expired"),
        "hot_swaps": fin.get("hot_swaps"),
        "dispatch_failures": fin.get("dispatch_failures"),
        "serve_requests": fin.get("requests") if man.get(
            "tool") == "serve" else None,
        # Network front-door accounting: the engine
        # snapshot's "net" sub-dict (connection / frame / verdict /
        # protocol-error counters) when a ServeServer was attached.
        "net": fin.get("net"),
        # Union-storage accounting: the engine snapshot's
        # per-model storage map and quantized-union count, so a
        # quantized serving run is distinguishable in the report table.
        "union_storage": fin.get("union_storage"),
        "quantized_unions": fin.get("quantized_unions"),
        "batch_occupancy_mean": ((fin.get("batch_occupancy") or {})
                                 .get("mean")),
        # Auto-gate provenance: the manifest's autotune
        # record — which DeviceProfile (if any) resolved the solve's
        # None-valued accelerator knobs, and what each decided.
        "autotune": man.get("autotune"),
    }
    # Continuous-learning accounting: `generation` events
    # from the cli learn loop — one per refreshed model generation,
    # carrying the warm-start seed size and pairs saved vs cold.
    gens = [e for e in run.events if e.get("name") == "generation"]
    out["generations"] = len(gens) if gens else None
    out["learn_pairs_saved"] = (sum(int(e.get("pairs_saved") or 0)
                                    for e in gens if e.get("gen"))
                                if gens else None)
    out["learn_seed_sv_last"] = (int(gens[-1].get("seed_sv") or 0)
                                 if gens else None)
    out["learn_estimated"] = (any(e.get("estimated") for e in gens)
                              if gens else None)
    return out


def _phases_of(summary: dict) -> dict:
    """A run's per-phase seconds, with the chunk-sum fallback for runs
    that carry no phase clock (serve runlogs): everything attributed to
    'solve' so diffs still have one honest bucket."""
    ph = summary.get("phase_seconds")
    if ph:
        return dict(ph)
    return {"solve": summary.get("device_seconds") or 0.0}


def diff_runs(a: dict, b: dict) -> dict:
    """Attribute the wall-clock movement from run-summary `a` (baseline)
    to `b` to the phase that moved. Deltas are ``b - a`` seconds per
    phase; the attribution names the phase with the largest
    |delta| and its share of the total movement."""
    pa, pb = _phases_of(a), _phases_of(b)
    phases = sorted(set(pa) | set(pb))
    deltas = {p: round(pb.get(p, 0.0) - pa.get(p, 0.0), 6)
              for p in phases}
    total_a = sum(pa.values())
    total_b = sum(pb.values())
    total_delta = total_b - total_a
    worst = max(phases, key=lambda p: abs(deltas[p])) if phases else None
    # Share of the GROSS movement (sum of |per-phase deltas|), not the
    # net: offsetting phases (setup +2s, solve -1.5s) are exactly the
    # case attribution exists for, and a net denominator would print
    # nonsense shares over 100% there.
    gross = sum(abs(d) for d in deltas.values())
    share = (abs(deltas[worst]) / gross
             if worst is not None and gross > 1e-12 else None)
    out = {
        "a": {"path": a["path"], "run": a["run"], "tool": a["tool"]},
        "b": {"path": b["path"], "run": b["run"], "tool": b["tool"]},
        "total_seconds_a": round(total_a, 6),
        "total_seconds_b": round(total_b, 6),
        "total_delta_seconds": round(total_delta, 6),
        "phase_deltas": deltas,
        "attributed_phase": worst,
        "attributed_share": round(share, 4) if share is not None else None,
        "pairs_per_second_a": a.get("pairs_per_second"),
        "pairs_per_second_b": b.get("pairs_per_second"),
        "compile_delta": (b.get("compiles", 0) or 0)
        - (a.get("compiles", 0) or 0),
    }
    ppa, ppb = a.get("pairs_per_second"), b.get("pairs_per_second")
    if ppa and ppb:
        out["pairs_per_second_delta"] = round(ppb / ppa - 1.0, 4)
    return out


def pick_run(runs: List[Run], run_id: Optional[str] = None,
             tool: Optional[str] = None) -> Run:
    """The run a diff side means: by explicit id when given, else the
    LAST finished run (streams append; the newest complete run is the
    one being compared), else the last run at all."""
    cand = [r for r in runs if tool is None
            or r.manifest.get("tool") == tool]
    if run_id is not None:
        for r in cand:
            if r.run_id == run_id:
                return r
        raise KeyError(f"run id {run_id!r} not found "
                       f"(have {[r.run_id for r in cand]})")
    # "Last" means chronologically newest, not last in lexical file
    # order (a dir can hold solve-400.jsonl written after
    # solve-5000.jsonl): order by the manifest's utc stamp (ISO-8601,
    # sorts lexically; stable sort keeps stream order within a second).
    def _utc(r):
        return r.manifest.get("utc") or ""

    finished = sorted((r for r in cand if r.final is not None),
                      key=_utc)
    if finished:
        return finished[-1]
    if not cand:
        raise ValueError("no runs found")
    return sorted(cand, key=_utc)[-1]


# ----------------------------------------------------------- rendering

def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


_REPORT_COLS = (
    ("tool", "tool"), ("run", "run"), ("engine", "engine"),
    ("n", "n"), ("d", "d"), ("chunks", "chunks"), ("pairs", "pairs"),
    ("device_s", "device_seconds"), ("pairs/s", "pairs_per_second"),
    ("gap last", "gap_last"), ("stalls", None), ("compiles", "compiles"),
    ("cache", None), ("shrink", None), ("serve", None), ("learn", None),
    ("faults", None),
    ("profile", None), ("phases", None), ("done", None),
)

#: faults-column legend: event name -> compact tag.
_FAULT_TAGS = (("fault", "f"), ("retry", "r"), ("demotion", "d"),
               ("resume", "c"), ("rehydrate", "h"),
               ("dispatch_failed", "x"))


def _report_row(s: dict) -> list:
    ph = s.get("phase_seconds")
    ph_txt = ("/".join(f"{k[:3]}={v:.3g}" for k, v in ph.items())
              if ph else "-")
    stalls = s["stalls"]
    done = ("conv" if s.get("converged")
            else "abort" if s.get("aborted")
            else "open" if not s.get("finished") else "stop")
    hr = s.get("cache_hit_rate")
    row = []
    for head, key in _REPORT_COLS:
        if key is not None:
            row.append(_fmt(s.get(key)))
        elif head == "stalls":
            row.append(f"{stalls['count']}(max {stalls['longest']})"
                       if stalls["count"] else "0")
        elif head == "cache":
            # The cache_hit_rate line: hit rate of
            # whichever kernel-row cache the run carried (per-pair LRU
            # or the ooc block cache), "-" when none.
            row.append(f"{100 * hr:.1f}%" if hr is not None else "-")
        elif head == "shrink":
            # Shrunken-stream column: active-view fraction,
            # full-stream reconstructions, and tiles the live-tile
            # skip never streamed (with the bytes they would have
            # cost); "-" for runs without ooc shrinking. A trailing
            # "dem" tags a run the endgame demoted back to the exact
            # full stream.
            if not s.get("ooc_shrink"):
                row.append("-")
            else:
                frac = s.get("shrink_active_fraction")
                txt = (f"act={frac:.2f} " if frac is not None else "")
                txt += (f"rec={s.get('shrink_reconstructions') or 0} "
                        f"skip={s.get('tiles_skipped') or 0}t")
                gb = (s.get("tile_bytes_skipped") or 0) / 2**30
                if gb >= 0.01:
                    txt += f"/{gb:.2f}GiB"
                if s.get("shrink_demoted"):
                    txt += " dem"
                row.append(txt)
        elif head == "serve":
            # Serving-engine column: deadline
            # misses / hot swaps / mean batch occupancy for v2 serve
            # runs, "-" for everything else. fail= appears only when
            # dispatches actually failed (watchdog); rej= /
            # perr= only when the network front door rejected frames
            # or saw protocol errors.
            if s.get("deadline_misses") is None:
                row.append("-")
            else:
                occ = s.get("batch_occupancy_mean")
                net = s.get("net") or {}
                # rep= tags a ReplicaFleet member's run with its
                # replica index; a fleet-of-N aggregate
                # run shows rep=xN instead.
                rep = ""
                if s.get("replica") is not None:
                    rep = f"rep={s['replica']} "
                elif (s.get("replicas") or 1) > 1:
                    rep = f"rep=x{s['replicas']} "
                # st= tags a run whose union storage is narrower than
                # f32: one tag when every model agrees,
                # st=mixed when a multi-model engine splits.
                stores = set((s.get("union_storage") or {}).values())
                st = ""
                if stores and stores != {"f32"}:
                    st = (f"st={stores.pop()} " if len(stores) == 1
                          else "st=mixed ")
                row.append(
                    rep + st
                    + f"miss={s['deadline_misses']} "
                    f"swap={s.get('hot_swaps') or 0}"
                    + (f" fail={s['dispatch_failures']}"
                       if s.get("dispatch_failures") else "")
                    + (f" rej={net['rejected']}"
                       if net.get("rejected") else "")
                    + (f" perr={net['protocol_errors']}"
                       if net.get("protocol_errors") else "")
                    + (f" occ={occ:.2f}" if occ is not None else ""))
        elif head == "learn":
            # Continuous-learning column: generation count,
            # last seed SV size and pairs saved vs cold for cli learn
            # runs ("~" marks a rate-ESTIMATED cold baseline, not a
            # measured one); "-" for everything else.
            if s.get("generations") is None:
                row.append("-")
            else:
                est = "~" if s.get("learn_estimated") else ""
                row.append(
                    f"gen={s['generations']} "
                    f"seed={s.get('learn_seed_sv_last') or 0} "
                    f"saved={est}{s.get('learn_pairs_saved') or 0}")
        elif head == "profile":
            # Auto-gate provenance column: "-" for runs
            # that consulted no auto gate, "default" when the gates
            # fell back to the hand-measured defaults, else the
            # resolving DeviceProfile's basename — with "+knob" tags
            # for every gate the profile flipped ON.
            at = s.get("autotune")
            if not at or not at.get("gates"):
                row.append("-")
            else:
                gates = at["gates"]
                profs = {g.get("profile") for g in gates.values()
                         if g.get("source") == "profile"}
                if not profs:
                    row.append("default")
                else:
                    name = os.path.basename(next(iter(profs)))
                    on = [k for k, g in gates.items()
                          if g.get("source") == "profile"
                          and g.get("decision")]
                    row.append(name + "".join(f" +{k}" for k in on))
        elif head == "faults":
            # Fault-story column: compact tags,
            # e.g. "f=1 r=1" for one fault + one retry, "d=1" for a
            # safe-config demotion, "h=1" for a journal rehydrate;
            # "0" when the run saw no fault events.
            ev = s.get("fault_events") or {}
            parts = [f"{tag}={ev[name]}" for name, tag in _FAULT_TAGS
                     if ev.get(name)]
            row.append(" ".join(parts) if parts else "0")
        elif head == "phases":
            row.append(ph_txt)
        else:
            row.append(done)
    return row


def render_report(summaries: List[dict], md: bool = False) -> str:
    """The aggregate table over run summaries (one row per run), plus a
    one-line total. `md=True` renders GitHub-flavored markdown (the CI
    job-summary mode); default is an aligned text table."""
    heads = [h for h, _ in _REPORT_COLS]
    rows = [_report_row(s) for s in summaries]
    total_pairs = sum(s["pairs"] or 0 for s in summaries)
    total_dev = sum(s["device_seconds"] or 0 for s in summaries)
    total_compiles = sum(s["compiles"] or 0 for s in summaries)
    footer = (f"{len(summaries)} run(s): {total_pairs} pairs in "
              f"{total_dev:.3f} device-s"
              + (f" ({round(total_pairs / total_dev)}/s)"
                 if total_dev else "")
              + f", {total_compiles} compile(s)")
    if md:
        lines = ["| " + " | ".join(heads) + " |",
                 "|" + "---|" * len(heads)]
        lines += ["| " + " | ".join(r) + " |" for r in rows]
        return "\n".join(lines + ["", footer])
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(heads)]
    lines = ["  ".join(h.ljust(w) for h, w in zip(heads, widths)),
             "  ".join("-" * w for w in widths)]
    lines += ["  ".join(c.ljust(w) for c, w in zip(r, widths))
              for r in rows]
    return "\n".join(lines + [footer])


def render_diff(d: dict) -> str:
    lines = [
        f"A: {d['a']['tool']} run {d['a']['run']} ({d['a']['path']})",
        f"B: {d['b']['tool']} run {d['b']['run']} ({d['b']['path']})",
        f"total: {d['total_seconds_a']:.4g}s -> "
        f"{d['total_seconds_b']:.4g}s "
        f"({d['total_delta_seconds']:+.4g}s)",
    ]
    for p, dv in sorted(d["phase_deltas"].items()):
        mark = " <-- attributed" if p == d["attributed_phase"] else ""
        lines.append(f"  {p:<10} {dv:+.4g}s{mark}")
    if d.get("pairs_per_second_delta") is not None:
        lines.append(f"pairs/s: {d['pairs_per_second_a']} -> "
                     f"{d['pairs_per_second_b']} "
                     f"({100 * d['pairs_per_second_delta']:+.1f}%)")
    if d.get("compile_delta"):
        lines.append(f"compiles: {d['compile_delta']:+d}")
    if d["attributed_phase"] is not None:
        share = (f" ({100 * d['attributed_share']:.0f}% of the gross "
                 "movement)" if d["attributed_share"] is not None else "")
        lines.append(f"attribution: phase "
                     f"'{d['attributed_phase']}'{share}")
    return "\n".join(lines)


def tail_records(path: str, n: int = 10) -> List[str]:
    """Last `n` records of one stream, one compact line per record."""
    if n <= 0:
        return []  # [-0:] would be the WHOLE stream
    out = []
    for rec in read_runlog(path)[-n:]:
        kind = rec["kind"]
        body = {k: v for k, v in rec.items()
                if k not in ("schema", "run", "kind", "config",
                             "metrics")}
        parts = " ".join(f"{k}={_fmt(v)}" for k, v in body.items()
                         if not isinstance(v, (dict, list)))
        out.append(f"[{rec['run']}] {kind:<8} {parts}")
    return out


# ----------------------------------------------------------------- CLI

def run_cli(argv=None) -> int:
    """``cli obs`` engine: report / diff / tail (argv forwarded
    verbatim from dpsvm_tpu_torch/cli.py)."""
    import argparse
    import json

    ap = argparse.ArgumentParser(
        prog="dpsvm-tpu-torch obs",
        description="runlog analytics over the telemetry spine's JSONL "
                    "streams (dpsvm_tpu_torch/obs)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser("report", help="aggregate run summaries "
                                       "(files, dirs or globs)")
    rp.add_argument("paths", nargs="+")
    rp.add_argument("--md", action="store_true",
                    help="GitHub-flavored markdown (the CI job-summary "
                         "mode)")
    rp.add_argument("--json", action="store_true",
                    help="machine-readable summaries (one JSON line "
                         "per run)")
    rp.add_argument("--tool", default=None,
                    help="restrict to one tool's runs (solve, "
                         "solve_mesh, fleet, serve, ...)")

    dp = sub.add_parser("diff", help="attribute A->B wall-clock "
                                     "movement to the phase that moved")
    dp.add_argument("run_a", help="baseline runlog (file/dir/glob)")
    dp.add_argument("run_b", help="candidate runlog (file/dir/glob)")
    dp.add_argument("--run-id-a", default=None)
    dp.add_argument("--run-id-b", default=None)
    dp.add_argument("--tool", default=None)
    dp.add_argument("--json", action="store_true")

    tp = sub.add_parser("tail", help="last N records of one stream")
    tp.add_argument("path")
    tp.add_argument("-n", type=int, default=10)

    args = ap.parse_args(argv)
    try:
        if args.cmd == "report":
            runs = load_runs(args.paths)
            if args.tool:
                runs = [r for r in runs
                        if r.manifest.get("tool") == args.tool]
            summaries = [summarize_run(r) for r in runs]
            if args.json:
                for s in summaries:
                    print(json.dumps(s))
            else:
                print(render_report(summaries, md=args.md))
            return 0
        if args.cmd == "diff":
            a = summarize_run(pick_run(load_runs([args.run_a]),
                                       args.run_id_a, args.tool))
            b = summarize_run(pick_run(load_runs([args.run_b]),
                                       args.run_id_b, args.tool))
            d = diff_runs(a, b)
            print(json.dumps(d) if args.json else render_diff(d))
            return 0
        lines = tail_records(args.path, args.n)
        print("\n".join(lines))
        return 0
    except BrokenPipeError:
        # `obs report ... | head` closes the pipe early — a normal way
        # to read a long table, not an error. Detach stdout so the
        # interpreter's shutdown flush doesn't re-raise.
        import os
        import sys

        try:
            sys.stdout.close()
        except Exception:
            os.close(1)
        return 0
    except (OSError, KeyError, ValueError) as e:
        # OSError covers FileNotFoundError AND e.g. IsADirectoryError
        # (`obs tail obs_runs/`) — every bad-path shape gets the
        # one-line error + exit-2 contract, never a traceback.
        import sys

        print(f"error: {e}", file=sys.stderr)
        return 2
