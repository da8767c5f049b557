"""The port's structural linter (dpsvm_tpu_torch/analysis): the recorder's
fact families on tiny hand-built functions with KNOWN facts, each fault
detected and its clean variant quiet, and the budget diff and verdicts.
One counterpart each of tests/test_tpulint.py's extractor and budget
tests; the manifest's (its committed budgets, the mutation variants,
the cross-package check) are in tests/test_torch_oplint_manifest.py."""

import json

import numpy as np
import pytest
import torch

from dpsvm_tpu_torch.analysis import budget
from dpsvm_tpu_torch.analysis.extract import Unit, entry_facts, unit_facts
from dpsvm_tpu_torch.analysis.op_facts import record
from dpsvm_tpu_torch.parallel.mesh import Mesh


def _facts(fn, *args, state=()):
    return record(fn, *args, state=state)[1]


# ------------------------------------------------------ collectives

def test_collective_facts_detect_psum():
    mesh = Mesh(["cpu"] * 8)
    parts = [torch.full((8, 16), float(r)) for r in range(8)]

    def shard_fn(parts):
        return mesh.psum([p.sum(0, keepdim=True) for p in parts])

    facts = _facts(shard_fn, parts)["collectives"]
    assert facts["all-reduce"]["count"] == 1
    # Per-device result payload: (1, 16) f32.
    assert facts["all-reduce"]["payload_bytes"] == [64]
    assert facts["all-gather"]["count"] == 0
    assert facts["collective-permute"]["count"] == 0
    # psum's own ops (the rank-order sum) are the collective, not ops.
    assert _facts(shard_fn, parts)["ops"]["by_name"] == {"sum": 8}


def test_packed_gather_is_one_exchange_and_one_rank_is_none():
    mesh = Mesh(["cpu"] * 4)
    vs = [torch.ones(2, 8) for _ in range(4)]
    ids = [torch.zeros(2, 8, dtype=torch.int64) for _ in range(4)]
    got = _facts(lambda: mesh.all_gather_many(vs, ids))["collectives"]
    assert got["all-gather"]["count"] == 1
    assert got["all-gather"]["payload_bytes"] == [4 * 64, 4 * 128]
    one = Mesh(["cpu"])
    quiet = _facts(lambda: one.psum([torch.ones(3)]))["collectives"]
    assert all(v["count"] == 0 for v in quiet.values())


def test_clean_function_is_quiet():
    facts = _facts(lambda a, b: a @ b, torch.ones(16, 8), torch.ones(8, 4))
    assert all(v["count"] == 0 for v in facts["collectives"].values())
    assert all(v == 0 for v in facts["transfers"].values())
    dt = facts["dtypes"]
    assert not dt["f64_present"] and dt["f32_to_bf16_converts"] == 0
    assert facts["dots"] == {"count": 1, "max_result_rank": 2,
                             "batched_rank3plus": 0}
    assert facts["kernels"] == {f"B{i}": 0 for i in range(1, 9)}


# ---------------------------------------------------- host round trips

@pytest.mark.parametrize("read", ["item", "bool", "int", "cpu_numpy",
                                  "tolist", "asarray"])
def test_host_read_detected(read):
    """Every form of a device-to-host read is ONE host read: a per-row
    round trip smuggled into a step cannot hide in a Python branch, a
    scalar or a NumPy view."""
    def f(x):
        y = x + 1
        if read == "item":
            y.sum().item()
        elif read == "bool":
            if y.sum() > 0:  # a Python branch on a device value
                pass
        elif read == "int":
            int(y[0])
        elif read == "cpu_numpy":
            y.cpu().numpy()
        elif read == "tolist":
            y.tolist()
        else:
            np.asarray(y)
        return y

    assert _facts(f, torch.ones(8))["transfers"]["host_reads"] == 1
    clean = _facts(lambda x: torch.where(x.sum() > 0, x, -x), torch.ones(8))
    assert clean["transfers"]["host_reads"] == 0


def test_host_write_detected_and_scalar_operand_quiet():
    host = np.arange(8, dtype=np.float32)
    writes = _facts(lambda x: (x + torch.from_numpy(host),
                               x * torch.tensor([2.0]),
                               x + torch.as_tensor(host)), torch.ones(8))
    assert writes["transfers"]["host_writes"] == 3
    # A Python scalar operand (and a tensor passed to as_tensor) brings
    # no host array in.
    quiet = _facts(lambda x: torch.as_tensor(x * 2.0) + 1, torch.ones(8))
    assert quiet["transfers"]["host_writes"] == 0


def test_run_error_is_a_fact_not_a_crash():
    def branchy():
        raise RuntimeError("a unit that cannot run")

    facts = unit_facts(Unit("bad", branchy))
    assert facts == {"run_error": "RuntimeError"}
    ok = unit_facts(Unit("good", lambda: torch.ones(2) + 1))
    assert "run_error" not in ok


def test_implicit_sync_detected():
    """Ops whose output shape depends on device data (a boolean index,
    nonzero) are hidden host round trips on the card."""
    x = torch.arange(8.0)
    assert _facts(lambda: x[x > 3])["transfers"]["implicit_syncs"] == 1
    assert _facts(lambda: torch.nonzero(x))["transfers"][
        "implicit_syncs"] == 1
    assert _facts(lambda: torch.where(x > 3, x, 0.0))["transfers"][
        "implicit_syncs"] == 0


# ------------------------------------------------------- dtype leaks

def test_f64_leak_detected_and_clean_variant_quiet():
    leaky = _facts(lambda x: (x.to(torch.float64) * 2.0).sum(),
                   torch.ones(32))["dtypes"]
    assert leaky["f64_present"]
    assert leaky["f32_to_f64_converts"] >= 1
    assert leaky["f64_result_ops"] >= 1
    clean = _facts(lambda x: (x * 2.0).sum(), torch.ones(32))["dtypes"]
    assert not clean["f64_present"] and clean["f64_result_ops"] == 0


def test_bf16_convert_counting():
    from dpsvm_tpu_torch.ops.kernels import mm_f32

    def quantizing(q, sv):
        qc = q.to(sv.dtype)  # the serving engine's one rounding
        return mm_f32(qc, sv.t())

    facts = _facts(quantizing, torch.ones(8, 4),
                   torch.ones(16, 4, dtype=torch.bfloat16))
    assert facts["dtypes"]["f32_to_bf16_converts"] == 1
    assert "f32_to_int8_converts" not in facts["dtypes"]


def test_int8_keys_only_where_int8_appears():
    q = torch.randn(8, 4)
    facts = _facts(lambda q: torch.clamp(torch.round(q * 10), -127, 127)
                   .to(torch.int8).to(torch.int32), q)["dtypes"]
    assert facts["f32_to_int8_converts"] == 1
    assert facts["int8_to_i32_converts"] == 1


# ------------------------------------------------ state in place

def test_reallocated_state_detected_and_inplace_variant_quiet():
    carry, delta = torch.zeros(128), torch.ones(128)
    plain = _facts(lambda c, d: c + d, carry, delta,
                   state=[carry])["inplace"]
    # The carry could be updated in place; it is allocated anew.
    assert plain == {"donatable": 1, "aliased_outputs": 0, "missed": 1}
    donated = _facts(lambda c, d: c.add_(d), carry, delta,
                     state=[carry])["inplace"]
    assert donated == {"donatable": 1, "aliased_outputs": 1, "missed": 0}
    # Written in place and not returned (a stream step's slice update)
    # is in place too.
    def step(c, d):
        c[:64].copy_(d[:64])

    sliced = _facts(step, carry, delta, state=[carry])["inplace"]
    assert sliced["aliased_outputs"] == 1


# ------------------------------------------------- rank-3 products

def test_rank3_batched_product_detected():
    facts = _facts(torch.matmul, torch.ones(4, 8, 16), torch.ones(4, 16, 8))
    assert facts["dots"]["batched_rank3plus"] >= 1
    assert facts["dots"]["max_result_rank"] == 3


# ------------------------------------------------------- kernels

def test_kernel_wrapper_calls_counted_not_their_plain_ops():
    """A kernel wrapper is one fact however many ops its plain version
    runs on the CPU (B1's is a Python loop)."""
    from dpsvm_tpu_torch.ops.subproblem import solve_subproblem

    q = 8
    rng = np.random.default_rng(0)
    a = rng.standard_normal((q, 3)).astype(np.float32)
    kb = torch.from_numpy(np.exp(-((a[:, None] - a[None]) ** 2).sum(-1)))
    y = torch.tensor([1.0, -1.0] * (q // 2))
    args = (kb, torch.zeros(q), y, -y, torch.ones(q), torch.ones(q),
            torch.tensor(64, dtype=torch.int32), (1.0, 1.0), 1e-3, 1e-12)
    facts = _facts(lambda: solve_subproblem(*args))
    assert facts["kernels"]["B1"] == 1
    assert facts["ops"]["count"] == 0
    assert facts["transfers"]["host_reads"] == 0


# ------------------------------------------------ budget diff/verdict

def test_budget_check_names_entry_and_fact(tmp_path):
    facts = {"dispatches": 1,
             "units": {"chunk": {"collectives": {
                 "all-reduce": {"count": 0}}}}}
    budget.write_budget("toy_entry", facts, tmp_path)
    assert budget.check_entry("toy_entry", facts,
                              tmp_path)["verdict"] == budget.PASS

    drifted = {"dispatches": 1,
               "units": {"chunk": {"collectives": {
                   "all-reduce": {"count": 3}}}}}
    res = budget.check_entry("toy_entry", drifted, tmp_path)
    assert res["verdict"] == budget.DRIFT
    (path, want, got), = res["diffs"]
    assert path == "units.chunk.collectives.all-reduce.count"
    assert (want, got) == (0, 3)
    table = budget.drift_table([res])
    assert "toy_entry" in table and "all-reduce.count" in table

    # The explicit allowlist tolerates (but still reports) the drift.
    doc = json.loads(budget.budget_path("toy_entry", tmp_path).read_text())
    doc["allow"] = ["units.chunk.collectives"]
    budget.budget_path("toy_entry", tmp_path).write_text(json.dumps(doc))
    res2 = budget.check_entry("toy_entry", drifted, tmp_path)
    assert res2["verdict"] == budget.PASS and res2["allowed"]

    # A missing budget is a failure, not a silent skip.
    assert budget.check_entry("other", facts,
                              tmp_path)["verdict"] == budget.MISSING

    # ... and so is a budget whose entrypoint left the manifest.
    assert budget.orphan_budgets(["toy_entry"], tmp_path) == []
    assert budget.orphan_budgets(["renamed_entry"],
                                 tmp_path) == ["toy_entry"]
    table = budget.drift_table([{"entry": "toy_entry",
                                 "verdict": budget.ORPHAN,
                                 "diffs": [], "allowed": []}])
    assert "no manifest entry" in table

    # write_budget records the torch version the facts came from.
    assert budget.budget_torch_version(tmp_path) == torch.__version__

    # A partial regeneration under another torch is an error.
    doc["torch"] = "0.0.0-other"
    budget.budget_path("zz_mixed", tmp_path).write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="mixed torch versions"):
        budget.budget_torch_version(tmp_path)


def test_gated_facts_keep_what_holds_on_every_device():
    facts = {"dispatches": 2, "units": {
        "chunk": {"kernels": {"B1": 1}, "collectives": {},
                  "transfers": {"host_reads": 1, "host_writes": 3},
                  "ops": {"count": 9}, "memory": {"temp_bytes": 4}},
        "pull": {"run_error": "OSError"}}}
    assert budget.gated_facts(facts) == {"dispatches": 2, "units": {
        "chunk": {"kernels": {"B1": 1}, "collectives": {}, "host_reads": 1},
        "pull": {"run_error": "OSError"}}}


def test_entry_facts_counts_dispatches():
    a = torch.ones(8)
    units = [Unit("one", lambda: a + 1), Unit("two", lambda: a * 2)]
    facts = entry_facts(units)
    assert facts["dispatches"] == 2
    assert set(facts["units"]) == {"one", "two"}


# ------------------------------------------------- memory accounting

def test_memory_facts_present_and_deterministic():
    x = torch.ones(64, 32)

    def build():
        return unit_facts(Unit("m", lambda: (x @ x.T).sum(0),
                               args=lambda: (x,)))

    f1, f2 = build(), build()
    mem = f1["memory"]
    assert set(mem) == {"argument_bytes", "output_bytes", "temp_bytes",
                        "alias_bytes"}
    assert mem["argument_bytes"] == 64 * 32 * 4
    assert mem["output_bytes"] == 64 * 4
    # The (64, 64) product is a temporary; the (64,) sum is the output.
    assert mem["temp_bytes"] == 64 * 64 * 4
    assert all(isinstance(v, int) and v >= 0 for v in mem.values())
    assert f1["memory"] == f2["memory"]  # zero drift on re-recording


def test_memory_facts_see_inplace_state_as_alias_bytes():
    x = torch.ones(256)
    inplace = unit_facts(Unit("d", lambda: x.mul_(2.0), args=lambda: (x,)))
    plain = unit_facts(Unit("p", lambda: x * 2.0, args=lambda: (x,)))
    assert inplace["memory"]["alias_bytes"] == 256 * 4
    assert plain["memory"]["alias_bytes"] == 0
