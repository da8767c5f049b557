"""The eight span readers (metrics/entry.*_ms, block.*_ms through
lib/spans.py) on a synthetic span table of the program: a job is the
table's own ``train`` count, a round its ``block/select`` count; None
where the run has no slice, the program keeps no table, a span is
absent, untimed on the device, or lost device events."""

import os

import pytest

from benchmark.lib import cells
from dpsvm_tpu_torch.obs import trace

RUN = {"kind": "train", "slice": {"window_s": 11.0, "busy_s": 10.0}}


def _ent(count, host_s, device_s=None, dropped=0):
    return {"count": count, "host_s": host_s, "device_s": device_s,
            "dropped": dropped}


# Two jobs of 100 rounds each; the loop condition read 102 times.
TABLE = {
    "train": _ent(2, 11.0),
    "solver/upload": _ent(2, 2.5, 2.4),
    "solver/chunk": _ent(2, 8.0),
    "model/assemble": _ent(2, 0.1),
    "block/select": _ent(200, 0.2, 0.3),
    "block/gather": _ent(200, 0.1, 0.04),
    "block/subproblem": _ent(200, 0.1, 0.05),
    "block/fold": _ent(200, 0.4, 6.0),
    "block/read": _ent(202, 5.0),
}

EXPECTED = {
    "entry.upload_ms": 1e3 * 2.4 / 2,
    "entry.model_ms": 1e3 * 0.1 / 2,
    "entry.rest_ms": 1e3 * (11.0 - 8.0 - 2.5 - 0.1) / 2,
    "block.select_ms": 1e3 * 0.3 / 200,
    "block.gather_ms": 1e3 * 0.04 / 200,
    "block.subproblem_ms": 1e3 * 0.05 / 200,
    "block.fold_ms": 1e3 * 6.0 / 200,
    "block.read_ms": 1e3 * 5.0 / 200,
}


def _table(monkeypatch, tab):
    monkeypatch.setattr(trace, "span_totals", lambda: tab)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_divides_by_jobs_or_rounds(monkeypatch, name):
    _table(monkeypatch, TABLE)
    assert cells.reader(name)(RUN) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_is_none_without_its_spans(monkeypatch, name):
    _table(monkeypatch, {})
    assert cells.reader(name)(RUN) is None
    _table(monkeypatch, TABLE)
    assert cells.reader(name)({**RUN, "slice": None}) is None
    assert cells.reader(name)({**RUN, "kind": "serve"}) is None
    monkeypatch.delattr(trace, "span_totals")  # an earlier program
    assert cells.reader(name)(RUN) is None


@pytest.mark.parametrize("name", ["entry.upload_ms", "block.fold_ms"])
def test_device_reader_is_none_when_untimed_or_dropped(monkeypatch, name):
    span = {"entry.upload_ms": "solver/upload",
            "block.fold_ms": "block/fold"}[name]
    ent = TABLE[span]
    _table(monkeypatch, {**TABLE, span: {**ent, "device_s": None}})
    assert cells.reader(name)(RUN) is None
    _table(monkeypatch, {**TABLE, span: {**ent, "dropped": 1}})
    assert cells.reader(name)(RUN) is None


def test_rest_counts_an_absent_child_as_zero(monkeypatch):
    tab = {k: v for k, v in TABLE.items() if k != "solver/upload"}
    _table(monkeypatch, tab)
    assert cells.reader("entry.rest_ms")(RUN) == pytest.approx(
        1e3 * (11.0 - 8.0 - 0.1) / 2)


def test_readers_are_in_the_benchmark():
    spec = cells.load_spec(os.path.dirname(cells.BENCH_DIR))
    mine = {m["name"]: m for m in spec["per_layer"] if m["name"] in EXPECTED}
    assert set(mine) == set(EXPECTED)
    assert all(m["source"] == "program_span" and m["moves"] == "train_s"
               and m["workloads"] == ["mnist8m.block"]
               for m in mine.values())
