"""Nothing under benchmark/ imports JAX or the JAX package, comparing
top-level names whole (dpsvm_tpu_torch begins with dpsvm_tpu); the
reference imports nothing of the port; nothing reads the JAX package's
benchmark files."""

import ast
import os
import re
import sys
import types

from benchmark import run as bench_run
from benchmark.lib import cells

BANNED = {"jax", "jaxlib", "flax", "dpsvm_tpu"}


def _sources(sub=""):
    top = os.path.join(cells.BENCH_DIR, sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_anywhere():
    for path in _sources():
        assert not set(_imports(path)) & BANNED, path


def test_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        assert "dpsvm_tpu_torch" not in set(_imports(path)), path


def test_nothing_reads_the_jax_packages_benchmark_files():
    names = re.compile(r"\bbench\.py\b|\btools/|BENCH_\w*\.json")
    for path in _sources():
        if os.sep + "tests" + os.sep in path:
            continue
        assert not names.search(open(path).read()), path


def test_the_run_names_loaded_jax_modules_by_whole_name():
    assert bench_run.banned_modules() == []
    sys.modules["dpsvm_tpu"] = types.ModuleType("dpsvm_tpu")
    try:
        assert bench_run.banned_modules() == ["dpsvm_tpu"]
    finally:
        del sys.modules["dpsvm_tpu"]
