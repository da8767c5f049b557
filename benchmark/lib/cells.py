"""Find a cell and everything it names from files alone.

``BENCHMARK.json`` lists configurations, cells (``workloads``) and
metrics by name. A cell's pieces are files found by those names:

- the configuration: the ``file`` its entry gives (``configs/<name>.json``);
- the traffic mix: ``traffic/<traffic>.json``, whose ``driver`` names a
  general driver in ``drivers/<driver>.py``;
- each metric: a reader in ``metrics/<metric>.py`` with ``read(run)``;
- the limits of the cell's output checks: ``limits/<workload>.json``.

A later cell, mix or metric is new files and new entries; no file here
changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    driver: object
    end_to_end: list
    per_layer: list
    limits: dict
    bench_dir: str = BENCH_DIR


def load_spec(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def load_module(path: str, name: str):
    """Import the Python file at `path` under a private module name (file
    names follow metric and traffic names, which may hold '.' and '-')."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def applies(metric: dict, cell: str) -> bool:
    """A metric with a ``workloads`` list reports in those cells; one
    without reports in every cell."""
    return "workloads" not in metric or cell in metric["workloads"]


def reader(metric_name: str, bench_dir: str = BENCH_DIR):
    """The ``read(run)`` function of a metric's reader file."""
    path = os.path.join(bench_dir, "metrics", f"{metric_name}.py")
    return load_module(path, f"bench_metric_{metric_name}").read


def find_cell(root: str, name: str, bench_dir: str = BENCH_DIR) -> Cell:
    spec = load_spec(root)
    cells = [w for w in spec["workloads"] if w["name"] == name]
    if not cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[0]
    conf = [c for c in spec["configs"] if c["name"] == cell["config"]][0]
    traffic = _read_json(os.path.join(bench_dir, "traffic",
                                      f"{cell['traffic']}.json"))
    driver = load_module(
        os.path.join(bench_dir, "drivers", f"{traffic['driver']}.py"),
        f"bench_driver_{traffic['driver']}")
    limits_path = os.path.join(bench_dir, "limits", f"{name}.json")
    return Cell(
        name=name, chips=int(cell["chips"]),
        config=_read_json(os.path.join(root, conf["file"])),
        traffic=traffic, driver=driver,
        end_to_end=[m for m in spec["end_to_end"] if applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if applies(m, name)],
        limits=_read_json(limits_path) if os.path.exists(limits_path)
        else {}, bench_dir=bench_dir)
