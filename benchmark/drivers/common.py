"""Pieces the drivers share: the configuration's generator and the
program's solver settings."""

from __future__ import annotations

import os

from benchmark.lib.cells import BENCH_DIR, load_module


def generator(config: dict):
    """The data generator module the configuration names
    (``data/<generator>.py``)."""
    name = config["generator"]
    return load_module(os.path.join(BENCH_DIR, "data", f"{name}.py"),
                       f"bench_data_{name}")


def svm_config(config: dict, overrides=None):
    """The port's SVMConfig with the fields the configuration pins; every
    other field keeps its default (the None gates resolve from the
    card's committed profile, as a user's would)."""
    from dpsvm_tpu_torch.config import SVMConfig

    return SVMConfig(**{**config["svm"], **(overrides or {})})


def failed_check(name: str, limit: float) -> tuple:
    """A check that found nothing to compare fails: its value is inf."""
    return (name, float("inf"), limit)
