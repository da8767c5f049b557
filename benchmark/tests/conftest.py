"""Fixtures of the harness's tests: the checkout on sys.path, cells cut
to a size the CPU runs in seconds, and the look for a card."""

from __future__ import annotations

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.lib import cells  # noqa: E402


def make_cell(name: str, config: str, traffic: str, rows: int = 1500,
              q: int = 64, **traffic_over) -> cells.Cell:
    """A cell of the committed configuration and mix files, cut to a
    tiny size (rows, working set), with the committed limits of
    `name`."""
    bench = cells.BENCH_DIR
    conf = cells._read_json(os.path.join(bench, "configs", f"{config}.json"))
    conf = copy.deepcopy(conf)
    conf["data"]["rows"] = rows
    conf["svm"]["working_set_size"] = q
    tr = {**cells._read_json(os.path.join(bench, "traffic",
                                          f"{traffic}.json")),
          **traffic_over}
    driver = cells.load_module(
        os.path.join(bench, "drivers", f"{tr['driver']}.py"),
        f"bench_driver_{tr['driver']}")
    spec = cells.load_spec(ROOT)
    return cells.Cell(
        name=name, chips=1, config=conf, traffic=tr, driver=driver,
        end_to_end=spec["end_to_end"], per_layer=spec["per_layer"],
        limits=cells._read_json(os.path.join(bench, "limits",
                                             f"{name}.json")))


@pytest.fixture
def card():
    """The CUDA card; skips without one (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
