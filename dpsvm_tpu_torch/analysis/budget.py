"""Budget IO, drift diffing, verdicts, and the lint runner (counterpart of
dpsvm_tpu/analysis/budget.py, the port's own copy).

A budget is one JSON file per manifest entry
(``dpsvm_tpu_torch/analysis/budgets/<entry>.json``) holding the entry's
full fact tree. ``--check`` re-records the facts on the CPU and diffs
them leaf by leaf, deny by default: any changed, added or removed fact
is a DRIFT naming the entrypoint and the fact's path. A budget may carry
an ``"allow"`` list of fact-path prefixes whose drifts are reported but
tolerated (empty everywhere today).

Each budget records the ``torch`` version that wrote it (the JAX
package's records ``jax``): the facts are ops of one torch build, so a
run under another version prints a NOTE and still diffs. A mix of
versions across the committed files is an error.

Regenerating after an INTENTIONAL structural change is
``python -m dpsvm_tpu_torch.cli lint --write-budgets --device cpu``; the
budget diff is the review artifact.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

BUDGET_DIR = Path(__file__).parent / "budgets"

PASS, DRIFT, MISSING, ORPHAN = ("PASS", "DRIFT", "MISSING_BUDGET",
                                "ORPHAN_BUDGET")


def gated_facts(facts: dict) -> dict:
    """An entry's facts cut to the families that hold on every device:
    ``dispatches`` and, per unit, ``kernels``, ``collectives``,
    ``transfers.host_reads`` and ``run_error``. ``ops``, ``dtypes`` and
    ``memory`` follow the code's device branches (e.g. ``mm_f32``'s bf16
    GEMM on the card), so a run off the CPU diffs only these (the card's
    ``chip_smoke.py`` [lint] gates them)."""
    units = {}
    for name, uf in facts.get("units", {}).items():
        cut = {k: uf[k] for k in ("kernels", "collectives", "run_error")
               if k in uf}
        if "transfers" in uf:
            cut["host_reads"] = uf["transfers"]["host_reads"]
        units[name] = cut
    return {"dispatches": facts.get("dispatches"), "units": units}


def budget_path(entry: str, budget_dir=None) -> Path:
    return Path(budget_dir or BUDGET_DIR) / f"{entry}.json"


def load_budget(entry: str, budget_dir=None):
    p = budget_path(entry, budget_dir)
    if not p.exists():
        return None
    with open(p) as fh:
        return json.load(fh)


def write_budget(entry: str, facts: dict, budget_dir=None) -> Path:
    p = budget_path(entry, budget_dir)
    p.parent.mkdir(parents=True, exist_ok=True)
    doc = {"entry": entry, "allow": [], "torch": torch.__version__,
           "facts": facts}
    with open(p, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return p


def budget_torch_version(budget_dir=None):
    """The torch version the committed budgets were written under (None
    when no budget records one). A MIXED set (a partial ``--write-budgets
    --entries ...`` under another torch) is an error: every consumer would
    otherwise key off whichever file sorts first."""
    seen = {}
    for p in sorted(Path(budget_dir or BUDGET_DIR).glob("*.json")):
        with open(p) as fh:
            v = json.load(fh).get("torch")
        if v:
            seen.setdefault(v, []).append(p.name)
    if len(seen) > 1:
        raise ValueError(
            "mixed torch versions across committed budgets: regenerate "
            "ALL of them under one torch (cli lint --write-budgets): "
            + "; ".join(f"{v}: {', '.join(names)}"
                        for v, names in sorted(seen.items())))
    return next(iter(seen), None)


def orphan_budgets(entries, budget_dir=None):
    """Budget files with no manifest entry: a renamed or deleted
    entrypoint whose stale budget would otherwise ship green."""
    known = set(entries)
    return [p.stem for p in sorted(Path(budget_dir or BUDGET_DIR)
                                   .glob("*.json"))
            if p.stem not in known]


def diff_facts(budgeted, observed, path=""):
    """Leaf-level [(fact_path, budgeted, observed)] differences, in
    path order. A missing or extra key is a difference too."""
    diffs = []
    if isinstance(budgeted, dict) and isinstance(observed, dict):
        for k in sorted(set(budgeted) | set(observed)):
            sub = f"{path}.{k}" if path else k
            if k not in budgeted:
                diffs.append((sub, "<absent>", observed[k]))
            elif k not in observed:
                diffs.append((sub, budgeted[k], "<absent>"))
            else:
                diffs.extend(diff_facts(budgeted[k], observed[k], sub))
    elif budgeted != observed:
        diffs.append((path, budgeted, observed))
    return diffs


def check_entry(entry: str, observed: dict, budget_dir=None,
                gated: bool = False) -> dict:
    """The entry's verdict against its budget; `gated` diffs only
    :func:`gated_facts` (a run off the CPU)."""
    doc = load_budget(entry, budget_dir)
    if doc is None:
        return {"entry": entry, "verdict": MISSING, "diffs": [],
                "allowed": []}
    allow = tuple(doc.get("allow", []))
    want = doc.get("facts", {})
    if gated:
        want, observed = gated_facts(want), gated_facts(observed)
    diffs = diff_facts(want, observed)
    denied = [d for d in diffs
              if not any(d[0].startswith(a) for a in allow)]
    allowed = [d for d in diffs
               if any(d[0].startswith(a) for a in allow)]
    return {"entry": entry, "verdict": DRIFT if denied else PASS,
            "diffs": denied, "allowed": allowed}


def drift_table(results) -> str:
    """The PASS / DRIFT summary: one row per entrypoint, then one line
    per violated fact."""
    width = max([len(r["entry"]) for r in results] + [10])
    lines = [f"{'entrypoint':<{width}}  verdict",
             f"{'-' * width}  -------"]
    for r in results:
        note = ""
        if r["allowed"]:
            note = f"  ({len(r['allowed'])} allowed drift(s))"
        lines.append(f"{r['entry']:<{width}}  {r['verdict']}{note}")
    for r in results:
        for path, want, got in r["diffs"]:
            lines.append(f"  DRIFT {r['entry']}: {path}: "
                         f"budget={want!r} observed={got!r}")
        for path, want, got in r["allowed"]:
            lines.append(f"  allow {r['entry']}: {path}: "
                         f"budget={want!r} observed={got!r}")
        if r["verdict"] == MISSING:
            lines.append(f"  DRIFT {r['entry']}: no committed budget: "
                         f"run cli lint --write-budgets")
        if r["verdict"] == ORPHAN:
            lines.append(f"  DRIFT {r['entry']}: budget file has no "
                         f"manifest entry: delete the stale JSON (or "
                         f"restore the entrypoint)")
    return "\n".join(lines)


def run_lint(argv=None) -> int:
    """The engine behind ``cli lint``.

    --check (default): record the manifest's facts and diff them against
    the committed budgets; exit 0 only if every entry PASSes.
    --write-budgets: overwrite the budget files with the recorded facts.
    --entries a,b,c: a subset. --device: where the units run (default
    cpu: the budgets are the CPU's; on another device only the families
    of :func:`gated_facts` are diffed).
    """
    import argparse

    from dpsvm_tpu_torch.analysis.extract import extract_entries
    from dpsvm_tpu_torch.analysis.manifest import MANIFEST

    ap = argparse.ArgumentParser(
        prog="lint",
        description="structural contract linter: run the hot-entrypoint "
                    "manifest one step each, record the ops, host reads, "
                    "collectives and kernel calls, and diff them against "
                    "the committed budgets")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--check", action="store_true", default=False,
                      help="diff facts against budgets (the default)")
    mode.add_argument("--write-budgets", action="store_true",
                      help="regenerate budget files from recorded facts")
    ap.add_argument("--entries", default=None,
                    help="comma-separated manifest subset (default all)")
    ap.add_argument("--budgets-dir", default=None,
                    help=f"budget directory (default {BUDGET_DIR})")
    ap.add_argument("--device", default="cpu",
                    help="device the units run on (default cpu: the "
                         "budgets are the CPU's facts; elsewhere only "
                         "kernels, collectives, dispatches and host reads "
                         "are diffed)")
    args = ap.parse_args(argv)
    gated = torch.device(args.device).type != "cpu"
    if args.write_budgets and gated:
        print("error: budgets are the CPU's facts; write them with "
              "--device cpu", file=sys.stderr)
        return 2

    names = args.entries.split(",") if args.entries else None
    observed = extract_entries(MANIFEST, names, device=args.device)

    if args.write_budgets:
        for entry, facts in observed.items():
            p = write_budget(entry, facts, args.budgets_dir)
            print(f"wrote {p}")
        if names is None:
            # A full regeneration knows the whole manifest: prune stale
            # budgets so the next --check does not fail ORPHAN on them.
            for e in orphan_budgets(MANIFEST, args.budgets_dir):
                p = budget_path(e, args.budgets_dir)
                p.unlink()
                print(f"removed stale {p} (no manifest entry)")
        return 0

    gen = budget_torch_version(args.budgets_dir)
    if gen is not None and gen != torch.__version__:
        # The facts are ops of one torch build: a version skew may show
        # as drift. The diff still runs (it is exact either way).
        print(f"NOTE: budgets were generated under torch {gen}; running "
              f"{torch.__version__}: DRIFTs below may reflect the torch "
              f"version, not a repo regression (regenerate with `cli lint "
              f"--write-budgets` under one version)")
    if gated:
        print(f"NOTE: units ran on {args.device}: diffing kernels, "
              "collectives, dispatches and host reads only")
    results = [check_entry(entry, facts, args.budgets_dir, gated=gated)
               for entry, facts in observed.items()]
    if names is None:
        results += [{"entry": e, "verdict": ORPHAN, "diffs": [],
                     "allowed": []}
                    for e in orphan_budgets(MANIFEST, args.budgets_dir)]
    print(drift_table(results))
    bad = [r for r in results if r["verdict"] != PASS]
    print(f"\nlint: {len(results) - len(bad)}/{len(results)} "
          f"entrypoints within budget")
    return 1 if bad else 0
