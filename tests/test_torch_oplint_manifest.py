"""The structural linter's manifest (dpsvm_tpu_torch/analysis/manifest.py)
against its committed budgets, its mutation variants and injected faults
(each must DRIFT naming its entry and fact), the out-of-core tile's
n-independence, and the mesh entries' collectives and dispatches held
against the JAX package's facts lowered live (dpsvm_tpu.analysis) on
conftest's eight host devices.

The JAX facts are compared where the two packages mean the same thing:
per step, each collective kind's count and payload bytes, the dispatches,
f64 presence. Where XLA's combiner or the port's packed exchanges
(Mesh.all_gather_many / psum_many) make a count differ by design, PINNED
holds both numbers (ROADMAP C.43)."""

import functools
import json
import shutil

import pytest
import torch

from dpsvm_tpu_torch.analysis import budget, manifest
from dpsvm_tpu_torch.analysis.extract import entry_facts, extract_entries
from dpsvm_tpu_torch.analysis.manifest import MANIFEST, N

CROSS = ("mesh_chunk", "pipelined_chunk", "shardlocal_chunk",
         "ooc_mesh_fold", "mesh_predict", "serve_mesh_bucket")

#: (entry, unit, kind): ((JAX count, total bytes), (port count, total
#: bytes)) where the two differ by design. The port gathers a
#: selection's candidate values and ids in ONE exchange
#: (all_gather_many), with int64 ids (XLA: two all-gathers, int32 ids);
#: XLA's combiner merges the pipelined round's (q, 2) handoff psum with
#: the next prefetch's psum into one all-reduce, the port exchanges them
#: apart (the handoff is on the round's critical path, the prefetch is
#: not). Payload lists agree wherever the counts do.
PINNED = {
    ("mesh_chunk", "chunk", "all-gather"): ((2, 4096), (1, 6144)),
    ("pipelined_chunk", "chunk", "all-gather"): ((4, 8192), (2, 12288)),
    ("pipelined_chunk", "chunk", "all-reduce"): ((2, 14336), (3, 14336)),
    ("ooc_mesh_fold", "select", "all-gather"): ((2, 4096), (1, 6144)),
}
#: The JAX unit each port unit is held against.
UNIT_OF = {"pull_obs": "pack_obs"}


@pytest.fixture(scope="module")
def port_facts():
    return extract_entries(MANIFEST)


@pytest.fixture(scope="module")
def jax_facts():
    from dpsvm_tpu.analysis.extract import extract_entries as jax_extract
    from dpsvm_tpu.analysis.manifest import MANIFEST as JAX_MANIFEST
    from dpsvm_tpu.analysis.manifest import require_devices

    require_devices()
    return jax_extract(JAX_MANIFEST, list(CROSS))


def _jax_budgets():
    import dpsvm_tpu.analysis.budget as jb

    return {p.stem: json.loads(p.read_text())
            for p in jb.BUDGET_DIR.glob("*.json")}


# ------------------------------------------- the committed budgets

def test_manifest_passes_committed_budgets(port_facts, monkeypatch, capsys):
    results = [budget.check_entry(e, f) for e, f in port_facts.items()]
    bad = [r for r in results if r["verdict"] != budget.PASS]
    assert not bad, "\n" + budget.drift_table(results)
    assert budget.orphan_budgets(MANIFEST) == []
    assert budget.budget_torch_version() == torch.__version__
    # The runner over the same facts: exit 0 and the summary line.
    monkeypatch.setattr("dpsvm_tpu_torch.analysis.extract.extract_entries",
                        lambda *a, **k: port_facts)
    assert budget.run_lint(["--check"]) == 0
    assert "25/25 entrypoints within budget" in capsys.readouterr().out


def test_budgets_are_the_jax_entries():
    names = {p.stem for p in budget.BUDGET_DIR.glob("*.json")}
    assert names == set(MANIFEST) == set(_jax_budgets())
    assert len(names) == 25


@pytest.mark.parametrize("entry", sorted(MANIFEST))
def test_dispatches_are_the_jax_entrys(entry, port_facts):
    """Each entry runs the host steps its JAX counterpart dispatches (a
    chunk runner and its observation pull are two)."""
    assert (port_facts[entry]["dispatches"]
            == _jax_budgets()[entry]["facts"]["dispatches"])


@pytest.mark.parametrize("case", ["missing", "orphan"])
def test_missing_and_orphan_budgets_fail(case, port_facts, tmp_path,
                                         monkeypatch, capsys):
    dst = tmp_path / "budgets"
    shutil.copytree(budget.BUDGET_DIR, dst)
    monkeypatch.setattr(
        "dpsvm_tpu_torch.analysis.extract.extract_entries",
        lambda m, names=None, **k: {n: port_facts[n]
                                    for n in (names or m)})
    if case == "missing":
        (dst / "block_chunk_single.json").unlink()
        argv = ["--check", "--entries", "block_chunk_single"]
        want = "block_chunk_single  MISSING_BUDGET"
    else:
        shutil.copy(dst / "mesh_chunk.json", dst / "stale_entry.json")
        argv = ["--check"]
        want = "stale_entry             ORPHAN_BUDGET"
    assert budget.run_lint(argv + ["--budgets-dir", str(dst)]) == 1
    out = capsys.readouterr().out
    assert want in out, out
    assert "DRIFT " + want.split()[0] in out


# ------------------------------------------- variants and injected faults

def _inject_item(monkeypatch):
    from dpsvm_tpu_torch.solver import block

    fold = block.fold_block

    def leaky(*a, **k):
        out = fold(*a, **k)
        out[1].sum().item()  # a per-round host round trip
        return out

    monkeypatch.setattr(block, "fold_block", leaky)


def _inject_f64(monkeypatch):
    from dpsvm_tpu_torch.solver import block

    fold = block.fold_block

    def leaky(*a, **k):
        alpha, f, f_err = fold(*a, **k)
        return alpha, (f.double() + 0.0).float(), f_err

    monkeypatch.setattr(block, "fold_block", leaky)


def _inject_psum(monkeypatch):
    from dpsvm_tpu_torch.parallel import dist_block

    gather = dist_block._gather_ws

    def chatty(mesh, x, scal_cols, sel):
        out = gather(mesh, x, scal_cols, sel)
        mesh.psum([c[0][:1] for c in scal_cols])  # a stray exchange
        return out

    monkeypatch.setattr(dist_block, "_gather_ws", chatty)


FAULTS = {
    # case: (entry, builder patch or code injection, a drifted fact path)
    "extra_pass": ("block_chunk_fusedround",
                   functools.partial(manifest.block_chunk_fusedround,
                                     extra_pass=True),
                   "units.chunk.dots.count"),
    "masked": ("ooc_fold_tile_shrink",
               functools.partial(manifest.ooc_fold_tile_shrink,
                                 masked=True),
               "units.fold_tile.memory.argument_bytes"),
    "extra_psum": ("ooc_mesh_fold",
                   functools.partial(manifest.ooc_mesh_fold,
                                     extra_psum=True),
                   "units.fold.collectives.all-reduce.count"),
    "item": ("block_chunk_single", _inject_item,
             "units.chunk.transfers.host_reads"),
    "f64": ("block_chunk_single", _inject_f64,
            "units.chunk.dtypes.f64_present"),
    "mesh_psum": ("mesh_chunk", _inject_psum,
                  "units.chunk.collectives.all-reduce.count"),
}


@pytest.mark.parametrize("case", sorted(FAULTS))
def test_fault_drifts_naming_entry_and_fact(case, monkeypatch, capsys):
    """Each mutation variant (the JAX manifest's) and each injected fault
    (a host read, a float64 op, an extra Mesh.psum in the hot path)
    fails `lint --check` with a DRIFT naming its entry and fact."""
    entry, change, path = FAULTS[case]
    if isinstance(change, functools.partial):
        monkeypatch.setitem(MANIFEST, entry, change)
    else:
        change(monkeypatch)
    assert budget.run_lint(["--check", "--entries", entry]) == 1
    out = capsys.readouterr().out
    assert f"DRIFT {entry}: {path}:" in out, out


# ------------------------------------------------- out of core

@pytest.mark.parametrize("entry", ["ooc_fold_tile", "ooc_fold_tile_shrink",
                                   "warm_f_rebuild"])
def test_tile_facts_independent_of_n(entry):
    """The out-of-core contract: a tile's program is a function of
    (T_TILE, D, Q); n_total reaches only the tile clamp. At 16 times the
    rows every fact (memory included) is the same."""
    build = getattr(manifest, entry)
    base = entry_facts([u for u in build("cpu", n_total=N)
                        if u.name == "fold_tile"])
    big = entry_facts([u for u in build("cpu", n_total=16 * N)
                       if u.name == "fold_tile"])
    assert base == big
    u = base["units"]["fold_tile"]
    assert all(v["count"] == 0 for v in u["collectives"].values())
    assert all(v == 0 for v in u["transfers"].values())


def test_masked_tile_program_grows_with_n():
    """The rejected masked stream is n-sized: the property the budget's
    n-independence pin would lose."""
    small = entry_facts(manifest.ooc_fold_tile_shrink("cpu", N, masked=True))
    big = entry_facts(manifest.ooc_fold_tile_shrink("cpu", 2 * N,
                                                    masked=True))
    mem = [f["units"]["fold_tile"]["memory"]["argument_bytes"]
           for f in (small, big)]
    assert mem[1] > mem[0]


# ------------------------------------------- against the JAX package

def _coll(unit_facts):
    return {k: (v["count"], v["total_bytes"], v["payload_bytes"])
            for k, v in unit_facts["collectives"].items()}


@pytest.mark.parametrize("entry", CROSS)
def test_collectives_and_dispatches_match_jax(entry, port_facts, jax_facts):
    port, jx = port_facts[entry], jax_facts[entry]
    assert port["dispatches"] == jx["dispatches"]
    assert len(port["units"]) == len(jx["units"])
    for unit, pf in port["units"].items():
        jf = jx["units"][UNIT_OF.get(unit, unit)]
        assert pf["dtypes"]["f64_present"] == jf["dtypes"]["f64_present"]
        pc, jc = _coll(pf), _coll(jf)
        for kind in pc:
            pinned = PINNED.get((entry, unit, kind))
            if pinned is None:
                assert pc[kind] == jc[kind], (entry, unit, kind)
            else:
                assert jc[kind][:2] == pinned[0], (entry, unit, kind, "jax")
                assert pc[kind][:2] == pinned[1], (entry, unit, kind, "port")
