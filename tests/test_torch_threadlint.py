"""threadlint in the port (dpsvm_tpu_torch/analysis): its own copy of
the JAX package's static concurrency-contract analyser, over the port's
threaded modules and its own committed contracts.

* the port's extractor, given the JAX package's modules, gives the JAX
  package's facts (the same analyser);
* the port's tree passes its committed contracts, and regeneration is
  byte-deterministic;
* deliberate regressions trip it (a deleted ``with self._lock:``, a
  reversed nested acquire, an unnamed thread, an unmapped handoff),
  injected through ``load_sources(overrides=...)``; the tree is never
  touched.

Host-only, pure AST: no device, no torch work."""

import json
import shutil
from pathlib import Path

import pytest

from dpsvm_tpu.analysis import concurrency_facts as jcf
from dpsvm_tpu_torch.analysis import concurrency_facts as cf
from dpsvm_tpu_torch.analysis import threadlint as tl

REPO = Path(__file__).resolve().parent.parent
REGISTRY = "dpsvm_tpu_torch/serving/registry.py"
EXPORT = "dpsvm_tpu_torch/obs/export.py"
DISPATCH = "dpsvm_tpu_torch/serving/dispatch.py"


def _facts(overrides=None):
    return cf.extract_concurrency_facts(
        sources=cf.load_sources(root=REPO, overrides=overrides))


def _check(overrides=None):
    return tl.run_check(
        sources=cf.load_sources(root=REPO, overrides=overrides))


def _verdicts(results):
    return {r["family"]: r["verdict"] for r in results}


def test_port_extractor_gives_jax_facts_on_jax_sources():
    srcs = jcf.load_sources(root=REPO)
    assert cf.extract_concurrency_facts(sources=srcs) == \
        jcf.extract_concurrency_facts(sources=srcs)


def test_threaded_modules_hold_the_ports_own_locks():
    mods = set(cf.THREADED_MODULES)
    assert {"dpsvm_tpu_torch/ops/_build.py",
            "dpsvm_tpu_torch/obs/runlog.py"} <= mods
    assert cf.FAULTS_MODULE == "dpsvm_tpu_torch/testing/faults.py"
    assert cf.FAULTS_MODULE in mods
    # Every JAX threaded module has its twin in the port.
    assert {m.replace("dpsvm_tpu/", "dpsvm_tpu_torch/")
            for m in jcf.THREADED_MODULES} <= mods
    locks = _facts()["guarded_by"]["locks"]
    assert locks["_build._lock"]["module"] == "dpsvm_tpu_torch/ops/_build.py"
    assert locks["RunLog._lock"]["module"] == "dpsvm_tpu_torch/obs/runlog.py"
    for lock in ("Scheduler._lock", "ServeServer._life",
                 "ServeServer._rep_lock", "ModelRegistry._lock",
                 "MetricsExporter._close_lock", "faults._plan_lock",
                 "_NetStats.lock"):
        assert lock in locks, f"extractor lost {lock}"
    assert locks["ServeServer._life"]["kind"] == "RLock"


def test_thread_inventory_and_seams():
    facts = _facts()
    threads = facts["thread_lifecycle"]["threads"]
    assert sorted(t["name"] for t in threads.values()) == [
        "dpsvm-dispatch-watchdog", "dpsvm-metrics-*", "dpsvm-net-accept",
        "dpsvm-net-pump*", "dpsvm-net-writer-*"]
    for site, t in threads.items():
        assert t["named_ok"] and (t["daemon"] or t["joined"]), site
    sc = facts["seam_coverage"]
    assert "lock_stall" in sc["seams"] and "ooc_tile_put" in sc["seams"]
    assert ("dpsvm_tpu_torch/serving/server.py::ServeServer._read_loop::"
            "_inbox.put") in sc["handoffs"]


def test_tree_passes_its_committed_contracts():
    code, lines, results = _check()
    assert code == 0, "\n".join(lines)
    assert set(_verdicts(results).values()) == {tl.PASS}
    # The one cycle is the allow-listed false edge, with its reason.
    lo = next(r for r in results if r["family"] == "lock_order")
    assert [a[0] for a in lo["allowed"]] == [
        "lock_order.cycles.RunLog._lock -> RunLog._lock"]
    assert "false edge" in lo["allowed"][0][-1]


def test_regeneration_is_deterministic_and_drift_free(tmp_path):
    work = tmp_path / "contracts"
    shutil.copytree(tl.CONTRACT_DIR, work)
    srcs = cf.load_sources(root=REPO)
    tl.write_contracts(sources=srcs, contracts_dir=work)
    first = {p.name: p.read_bytes() for p in sorted(work.iterdir())}
    tl.write_contracts(sources=srcs, contracts_dir=work)
    second = {p.name: p.read_bytes() for p in sorted(work.iterdir())}
    assert first == second
    for fam in tl.FAMILIES:
        assert first[f"{fam}.json"] == \
            (tl.CONTRACT_DIR / f"{fam}.json").read_bytes(), fam


def test_missing_contract_fails_closed(tmp_path):
    code, _, results = tl.run_check(sources=cf.load_sources(root=REPO),
                                    contracts_dir=tmp_path / "nowhere")
    assert code == 1
    assert set(_verdicts(results).values()) == {tl.MISSING}


# ------------------------------------------------------------ mutations

def _mutation(kind):
    if kind == "deleted_lock":
        src = (REPO / REGISTRY).read_text()
        assert src.count("with self._lock:") >= 5
        return {REGISTRY: src.replace("with self._lock:", "if True:", 1)}
    if kind == "reversed_nesting":
        src = (REPO / REGISTRY).read_text()
        anchor = "def __len__(self) -> int:"
        assert src.count(anchor) == 1
        mutant = ("def _tl_forward(self):\n"
                  "        with self._lock:\n"
                  "            with self._journal_lock:\n"
                  "                pass\n\n"
                  "    def _tl_backward(self):\n"
                  "        with self._journal_lock:\n"
                  "            with self._lock:\n"
                  "                pass\n\n"
                  "    " + anchor)
        return {REGISTRY: src.replace(anchor, mutant, 1)}
    if kind == "unnamed_thread":
        src = (REPO / EXPORT).read_text()
        victim = 'name=f"dpsvm-metrics-{self.port}", daemon=True'
        assert victim in src
        return {EXPORT: src.replace(victim, "daemon=True", 1)}
    if kind == "deleted_ladder_lock":
        src = (REPO / DISPATCH).read_text()
        victim = ("        with self._prep_lock:\n"
                  "            if self._preparing:\n"
                  "                return None\n"
                  "            self._bucket_ladder = ")
        assert src.count(victim) == 1
        return {DISPATCH: src.replace(
            victim, victim.replace("with self._prep_lock:", "if True:"), 1)}
    raise AssertionError(kind)


@pytest.mark.parametrize("kind,family,needle", [
    ("deleted_ladder_lock", "guarded_by", "ServingEngine._bucket_ladder"),
    ("deleted_lock", "guarded_by", "ModelRegistry._journal"),
    ("reversed_nesting", "lock_order", "cycles"),
    ("unnamed_thread", "thread_lifecycle", "MetricsExporter.__init__"),
])
def test_mutation_fails_its_check(kind, family, needle):
    """A deleted `with self._lock:` (the indentation-preserving `if
    True:` swap) turns the registry's journal writes unguarded; two
    methods taking _lock and _journal_lock in opposing order make a
    cycle; the exporter thread without its dpsvm- name breaks the
    naming rule; the bucket-ladder swap without _prep_lock (it must not
    race a swap preparation) drifts from its contract. Each fails its
    family."""
    code, lines, results = _check(_mutation(kind))
    assert code == 1
    r = next(r for r in results if r["family"] == family)
    assert r["verdict"] != tl.PASS
    assert any(needle in rec[0] for rec in r["denied"]), r["denied"]
    if kind == "reversed_nesting":
        cycles = _facts(_mutation(kind))["lock_order"]["cycles"]
        assert any("ModelRegistry._lock" in c
                   and "ModelRegistry._journal_lock" in c for c in cycles)
    if kind == "unnamed_thread":
        assert any(rec[0].endswith(".name") for rec in r["denied"])


def test_unmapped_handoff_is_denied(tmp_path):
    work = tmp_path / "contracts"
    shutil.copytree(tl.CONTRACT_DIR, work)
    p = work / "seam_coverage.json"
    c = json.loads(p.read_text())
    victim = ("dpsvm_tpu_torch/serving/server.py::ServeServer._read_loop::"
              "_inbox.put")
    del c["map"][victim]
    p.write_text(json.dumps(c, indent=2, sort_keys=True) + "\n")
    code, _, results = tl.run_check(sources=cf.load_sources(root=REPO),
                                    contracts_dir=work)
    assert code == 1
    seam = next(r for r in results if r["family"] == "seam_coverage")
    assert seam["verdict"] == tl.VIOLATION
    assert any(victim in rec[0] for rec in seam["denied"])


def test_allow_is_prefix_matched_and_deny_by_default():
    facts = {"guarded_by": {"locks": {}, "attrs": {}}}
    contract = {"facts": {"locks": {}, "attrs": {"X.y": 1}}, "allow": []}
    r = tl.check_family("guarded_by", facts, contract)
    assert r["verdict"] == tl.DRIFT and len(r["denied"]) == 1
    contract["allow"] = [{"path": "guarded_by.attrs.X.", "reason": "test"}]
    r = tl.check_family("guarded_by", facts, contract)
    assert r["verdict"] == tl.PASS and len(r["allowed"]) == 1
