"""threadlint: committed concurrency contracts for the port's threaded
host layer (counterpart of dpsvm_tpu/analysis/threadlint.py, the port's
own copy).

`concurrency_facts.extract_concurrency_facts` produces four fact
families over the threaded modules; this module diffs them against the
checked-in contracts in ``dpsvm_tpu_torch/analysis/contracts/*.json``
and enforces the built-in rules:

GUARDED_BY   an attribute reachable from a thread entry point with an
             unguarded (non-``__init__``) write is a violation.
ORDER        a cycle in the acquired-while-holding graph (including a
             non-reentrant self-acquire) is a violation.
LIFECYCLE    a ``Thread(...)`` without a ``dpsvm-`` name, or neither
             daemonized nor joined, is a violation.
SEAM         a cross-thread handoff with no entry in the committed
             handoff->seam map is a violation.

Discipline is deny-by-default: ANY fact drift fails unless an ``allow``
entry covers it, and every allow entry carries a one-line ``reason``
(the committed record of why a finding is a false positive).
Regeneration (``--write-contracts``) preserves the allow lists and the
seam map, prunes entries whose subjects no longer exist, and is
byte-deterministic: run it twice, get identical files. There is no
version stamp: these facts are properties of the Python source alone.

Usage:
    python -m dpsvm_tpu_torch.cli lint --threads --check
    python -m dpsvm_tpu_torch.cli lint --threads --write-contracts
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from dpsvm_tpu_torch.analysis import concurrency_facts as _cf

CONTRACT_DIR = Path(__file__).parent / "contracts"
FAMILIES = ("guarded_by", "lock_order", "thread_lifecycle",
            "seam_coverage")

PASS = "PASS"
DRIFT = "DRIFT"
VIOLATION = "VIOLATION"
MISSING = "MISSING_CONTRACT"
ABSENT = "<absent>"


# ------------------------------------------------------------------
# contract IO
# ------------------------------------------------------------------
def contract_path(family: str, contracts_dir=None) -> Path:
    base = Path(contracts_dir) if contracts_dir else CONTRACT_DIR
    return base / f"{family}.json"


def load_contract(family: str, contracts_dir=None):
    p = contract_path(family, contracts_dir)
    if not p.exists():
        return None
    return json.loads(p.read_text())


def write_contract(family: str, contract: dict, contracts_dir=None
                   ) -> Path:
    p = contract_path(family, contracts_dir)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(contract, indent=2, sort_keys=True) + "\n")
    return p


# ------------------------------------------------------------------
# diffing (leaf-by-leaf, deny by default)
# ------------------------------------------------------------------
def diff_facts(expected, actual, prefix="") -> list:
    diffs = []
    if isinstance(expected, dict) and isinstance(actual, dict):
        for key in sorted(set(expected) | set(actual)):
            sub = f"{prefix}.{key}" if prefix else str(key)
            if key not in expected:
                diffs.append((sub, ABSENT, actual[key]))
            elif key not in actual:
                diffs.append((sub, expected[key], ABSENT))
            else:
                diffs.extend(diff_facts(expected[key], actual[key],
                                        sub))
        return diffs
    if expected != actual:
        diffs.append((prefix, expected, actual))
    return diffs


# ------------------------------------------------------------------
# built-in rules
# ------------------------------------------------------------------
def violations_for(family: str, facts: dict, contract) -> list:
    """[(path, message)] for the family's rule set. Paths share the
    allow-prefix namespace with drift paths."""
    fam = facts[family]
    out = []
    if family == "guarded_by":
        for attr, f in fam["attrs"].items():
            if f["writes_unguarded"] and f["thread_roots"]:
                out.append((
                    f"guarded_by.attrs.{attr}",
                    f"{f['writes_unguarded']} unguarded write(s); "
                    f"reachable from {', '.join(f['thread_roots'])}"))
    elif family == "lock_order":
        for cyc in fam["cycles"]:
            out.append((f"lock_order.cycles.{cyc}",
                        "acquired-while-holding cycle "
                        "(potential deadlock)"))
    elif family == "thread_lifecycle":
        for site, t in fam["threads"].items():
            if not t["named_ok"]:
                out.append((
                    f"thread_lifecycle.threads.{site}.name",
                    f"thread name {t['name']!r} lacks the mandatory "
                    "'dpsvm-' prefix"))
            if not (t["daemon"] or t["joined"]):
                out.append((
                    f"thread_lifecycle.threads.{site}.join",
                    "thread is neither daemonized nor provably "
                    "joined on a close/drain path"))
    elif family == "seam_coverage":
        seam_map = (contract or {}).get("map", {})
        seams = set(fam["seams"])
        for h in fam["handoffs"]:
            entry = seam_map.get(h)
            if entry is None:
                out.append((
                    f"seam_coverage.handoffs.{h}",
                    "cross-thread handoff with no entry in the "
                    "committed handoff->seam map"))
            elif "seam" in entry and entry["seam"] not in seams:
                out.append((
                    f"seam_coverage.map.{h}.seam",
                    f"mapped to unknown seam {entry['seam']!r} "
                    f"(known: {sorted(seams)})"))
        for h in seam_map:
            if h not in fam["handoffs"]:
                out.append((
                    f"seam_coverage.map.{h}",
                    "seam-map entry for a handoff that no longer "
                    "exists (regenerate to prune)"))
    return out


def _allowed(path: str, allow: list):
    for entry in allow:
        if path.startswith(entry.get("path", "\x00")):
            return entry
    return None


def check_family(family: str, facts: dict, contract) -> dict:
    """Verdict record for one family against its loaded contract."""
    if contract is None:
        return {"family": family, "verdict": MISSING, "denied": [],
                "allowed": [], "message":
                f"no committed contract (run --write-contracts and "
                f"commit {contract_path(family).name})"}
    allow = contract.get("allow", [])
    denied, allowed = [], []
    for path, exp, act in diff_facts(contract.get("facts", {}),
                                     facts[family]):
        rec = (f"{family}.{path}" if not path.startswith(family)
               else path, f"expected {exp!r}", f"actual {act!r}")
        entry = _allowed(rec[0], allow)
        (allowed if entry else denied).append(
            rec + ((entry.get("reason", ""),) if entry else ()))
    has_drift = bool(denied)
    for path, msg in violations_for(family, facts, contract):
        entry = _allowed(path, allow)
        if entry:
            allowed.append((path, msg, "",
                            entry.get("reason", "")))
        else:
            denied.append((path, msg, ""))
    if not denied:
        verdict = PASS
    elif has_drift:
        verdict = DRIFT
    else:
        verdict = VIOLATION
    return {"family": family, "verdict": verdict, "denied": denied,
            "allowed": allowed, "message": ""}


# ------------------------------------------------------------------
# runner
# ------------------------------------------------------------------
def _report(results, facts, verbose_allowed=False) -> list:
    lines = [f"threadlint: {len(FAMILIES)} contract families over "
             f"{len(set(_cf.THREADED_MODULES))} threaded modules "
             f"({len(facts['guarded_by']['locks'])} locks, "
             f"{len(facts['guarded_by']['attrs'])} shared attrs, "
             f"{len(facts['thread_lifecycle']['threads'])} thread "
             f"sites, {len(facts['seam_coverage']['handoffs'])} "
             "handoffs)"]
    for r in results:
        n_allow = len(r["allowed"])
        suffix = f"  ({n_allow} allow-listed)" if n_allow else ""
        lines.append(f"  {r['family']:<17} {r['verdict']}{suffix}")
        if r["message"]:
            lines.append(f"    {r['message']}")
        for rec in r["denied"]:
            lines.append(f"    FAIL {rec[0]}: "
                         + "; ".join(x for x in rec[1:] if x))
        if verbose_allowed:
            for rec in r["allowed"]:
                lines.append(f"    allow {rec[0]}: {rec[-1]}")
    return lines


def run_check(root=None, sources=None, contracts_dir=None,
              verbose_allowed=False):
    """(exit_code, report_lines, results). The API the tests drive —
    `sources` overrides module texts so deliberate mutations never
    touch the tree."""
    facts = _cf.extract_concurrency_facts(root=root, sources=sources)
    results = [check_family(f, facts,
                            load_contract(f, contracts_dir))
               for f in FAMILIES]
    code = 0 if all(r["verdict"] == PASS for r in results) else 1
    return code, _report(results, facts, verbose_allowed), results


def write_contracts(root=None, sources=None, contracts_dir=None
                    ) -> list:
    """Regenerate all four contracts from current facts. Allow lists
    and the seam map survive regeneration (pruned to subjects that
    still exist); everything else is replaced. Byte-deterministic."""
    facts = _cf.extract_concurrency_facts(root=root, sources=sources)
    written = []
    for family in FAMILIES:
        prev = load_contract(family, contracts_dir) or {}
        contract = {"facts": facts[family],
                    "allow": sorted(prev.get("allow", []),
                                    key=lambda e: e.get("path", ""))}
        if family == "seam_coverage":
            live = set(facts[family]["handoffs"])
            contract["map"] = {h: e
                               for h, e in prev.get("map", {}).items()
                               if h in live}
        written.append(write_contract(family, contract,
                                      contracts_dir))
    return written


def run_threadlint(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="dpsvm-tpu-torch lint --threads",
        description="static concurrency contracts (threadlint)")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--check", action="store_true",
                      help="diff current facts against the committed "
                           "contracts (default)")
    mode.add_argument("--write-contracts", action="store_true",
                      help="regenerate contracts from current facts "
                           "(allow lists and the seam map survive); "
                           "commit the JSON diff")
    ap.add_argument("--contracts-dir", default=None,
                    help="override the contracts directory (tests)")
    ap.add_argument("--show-allowed", action="store_true",
                    help="also print allow-listed findings with "
                         "their reasons")
    args = ap.parse_args(argv)

    if args.write_contracts:
        for p in write_contracts(contracts_dir=args.contracts_dir):
            print(f"wrote {p}")
        return 0
    code, lines, _results = run_check(
        contracts_dir=args.contracts_dir,
        verbose_allowed=args.show_allowed)
    print("\n".join(lines))
    return code


if __name__ == "__main__":
    sys.exit(run_threadlint())
