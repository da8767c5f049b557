"""Cells, configurations, mixes, metrics and limits are found by name
from files alone; a new cell is new files and new entries."""

import json
import os
import shutil

from benchmark import run as bench_run
from benchmark.lib import cells

from conftest import ROOT


def test_every_cell_resolves():
    spec = cells.load_spec(ROOT)
    for w in spec["workloads"]:
        cell = cells.find_cell(ROOT, w["name"])
        assert cell.config["name"] == w["config"]
        for fn in ("setup", "window", "check", "close"):
            assert callable(getattr(cell.driver, fn))
        assert cell.limits, f"{w['name']} has no limits file"
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cells.reader(m["name"]))
    for m in spec["end_to_end"] + spec["per_layer"]:
        for wl in m.get("workloads", []):
            assert wl in {w["name"] for w in spec["workloads"]}


def test_every_kept_file_resolves():
    # Every mix names a driver that exists; every reader loads.
    bench = cells.BENCH_DIR
    for f in os.listdir(os.path.join(bench, "traffic")):
        tr = json.load(open(os.path.join(bench, "traffic", f)))
        assert os.path.exists(os.path.join(bench, "drivers",
                                           f"{tr['driver']}.py"))
    for f in os.listdir(os.path.join(bench, "metrics")):
        if f.endswith(".py"):
            assert callable(cells.reader(f[:-3]))


FIXTURE_DRIVER = '''
def setup(cell, seed, device, svm_overrides=None):
    return {"seed": seed, "t": cell.traffic["work"]}

def window(state, seconds, trace):
    return {"kind": "fixture", "t0": 0.0, "window_s": seconds,
            "attempted": 3, "failed": 0, "work": state["t"] * state["seed"]}

def check(state, run):
    return [("same", 0.0, 0.0)]

def close(state):
    pass
'''


def test_a_cell_made_of_new_files_only(tmp_path):
    """A cell with its own configuration, mix, driver and metric, added
    as new files and entries beside the committed ones."""
    bench = tmp_path / "benchmark"
    shutil.copytree(cells.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (bench / "configs" / "fixture.json").write_text(json.dumps(
        {"name": "fixture", "generator": "mnist_like"}))
    (bench / "traffic" / "fixture-mix.json").write_text(json.dumps(
        {"driver": "fixture_driver", "work": 3}))
    (bench / "drivers" / "fixture_driver.py").write_text(FIXTURE_DRIVER)
    (bench / "metrics" / "fixture.work.py").write_text(
        "def read(run):\n    return run['work'] * 1.0\n")
    (bench / "limits" / "fixture.cell.json").write_text('{"same": 0}')
    spec = cells.load_spec(ROOT)
    spec["configs"].append({"name": "fixture", "source": "a test",
                            "file": "benchmark/configs/fixture.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "fixture.cell", "config": "fixture",
                              "traffic": "fixture-mix", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "fixture.work", "unit": "units",
                              "better": "higher", "source": "host_clock",
                              "layer": "fixture", "moves": "setup_s",
                              "workloads": ["fixture.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = cells.find_cell(str(tmp_path), "fixture.cell", str(bench))
    assert cell.traffic["work"] == 3
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["fixture.work"]
    run, checks = bench_run.measure(cell, 5, 1.0, False, "cpu",
                                    t_start=-2.0)
    line = bench_run.result_line(cell, run, checks, True, "cpu", "none")
    assert line["metrics"] == {"fixture.work": {"value": 15.0,
                                                "unit": "units"}}
    assert line["correct"] is True
    assert list(line)[-1] == "checks"
    line = bench_run.result_line(cell, run, checks, False, "cpu", "none")
    assert line["metrics"]["setup_s"]["value"] == 2.0
