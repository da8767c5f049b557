"""The public names of the JAX package and their counterparts in the port
(dpsvm_tpu_torch): the converters (the MNIST even/odd relabel and the
module's CLI, byte for byte), the process-default metrics registry
(get_registry / enable under DPSVM_OBS, the NULL instrument), the build
seconds of compilelog, utils/native.py build_all, the console-script
entries of cli.py, the serving bf16 warning and the package exports,
each against the JAX one on the same inputs. Then two diffs of the
names themselves: every name in the __all__ of dpsvm_tpu and its ops,
solver, obs and data packages exists in the port, and every public
function and class a JAX module defines exists in the port's module of
the same path, but for the explicit JAX-only and moved names below, so
that a future gap fails here."""

import importlib
import importlib.util
import inspect
import os
import subprocess
import sys
import types
import warnings

import numpy as np
import pytest

import dpsvm_tpu
from dpsvm_tpu import cli as jcli
from dpsvm_tpu import serve as jserve
from dpsvm_tpu.data import converters as jconv
from dpsvm_tpu.obs import compilelog as jcompilelog
from dpsvm_tpu.obs import metrics as jmetrics
from dpsvm_tpu.ops.kernels import KernelParams as JaxKernelParams
from dpsvm_tpu.utils import native as jnative
import dpsvm_tpu_torch
from dpsvm_tpu_torch import cli as tcli
from dpsvm_tpu_torch import serve as tserve
from dpsvm_tpu_torch.data import converters as tconv
from dpsvm_tpu_torch.obs import compilelog as tcompilelog
from dpsvm_tpu_torch.obs import metrics as tmetrics
from dpsvm_tpu_torch.ops.kernels import KernelParams
from dpsvm_tpu_torch.utils import native as tnative

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The JAX package's own names, by design without a counterpart (ROADMAP
# A.15's list): the TPU auto-gates (the port's engines are gated by the
# H100 autotune profile), the donated jitted runners (eager torch has no
# buffer donation), the shard_map and XLA-program builders (the port's
# mesh runs eager per-rank code: parallel/mesh.py, dist_block.py
# ooc_mesh_*), the ring's Pallas tiling helper, the jax-version and
# jax-device helpers (the port records a torch version:
# analysis/budget.py budget_torch_version; its mesh entries run on
# logical shards, so it needs no forced host devices; hostenv's
# child_env), and compilelog's jax monitoring hook (the port's builds
# record themselves: ops/_build.py). Modules: the Pallas kernels (their
# counterparts are csrc/*.cu behind ops/*.py) and the HLO reader (the
# port's analysis/op_facts.py).
JAX_ONLY = {
    "dpsvm_tpu.solver.block": {
        "fused_fold_pays", "shardlocal_pays", "ring_pays",
        "fused_round_pays", "pipeline_pays", "ooc_shrink_pays",
        "run_chunk_block_donated", "run_chunk_block_fused_donated",
        "run_chunk_block_pipelined_donated",
        "run_chunk_block_active_donated",
        "run_chunk_block_fusedround_donated"},
    "dpsvm_tpu.parallel.mesh": {"mesh_shard_map"},
    "dpsvm_tpu.parallel.dist_block": {"make_ooc_mesh_programs"},
    "dpsvm_tpu.ops.ring": {"fold_tile_rows"},
    "dpsvm_tpu.autotune.profile": {"jax_compatible"},
    "dpsvm_tpu.utils.hostenv": {"cleaned_cpu_env"},
    "dpsvm_tpu.analysis.budget": {"budget_jax_version"},
    "dpsvm_tpu.analysis.manifest": {"require_devices"},
    "dpsvm_tpu.obs.compilelog": {"install"},
}
JAX_ONLY_MODULES = {
    "dpsvm_tpu.ops.pallas_subproblem", "dpsvm_tpu.ops.pallas_fold_select",
    "dpsvm_tpu.ops.pallas_round", "dpsvm_tpu.ops.pallas_fused",
    "dpsvm_tpu.analysis.hlo_facts"}
# Names the port defines in another module: JAX module -> {name: the
# port's module}.
MOVED = {
    "dpsvm_tpu.solver.smo": {
        "solve": "dpsvm_tpu_torch.solver.solve",
        "NonFiniteTrajectory": "dpsvm_tpu_torch.solver.chunks",
        "check_obs_finite": "dpsvm_tpu_torch.solver.chunks",
        "assert_finite_state": "dpsvm_tpu_torch.solver.chunks"},
}


# ---- the converters --------------------------------------------------


def test_mnist_relabel_is_jaxs():
    rng = np.random.default_rng(0)
    digits = rng.integers(0, 10, 50)
    x = rng.uniform(0, 255, (50, 12))
    for scale in (255.0, 16.0):
        xt, yt = tconv.mnist_to_odd_even(x, digits, scale=scale)
        xj, yj = jconv.mnist_to_odd_even(x, digits, scale=scale)
        assert xt.dtype == xj.dtype == np.float32
        assert yt.dtype == yj.dtype == np.int32
        np.testing.assert_array_equal(xt, xj)
        np.testing.assert_array_equal(yt, yj)


def test_converters_cli_writes_jaxs_bytes(tmp_path, capsys):
    """Both subcommands of the module's CLI write the JAX CLI's file byte
    for byte (JAX's tests/test_converters.py:46-64 inputs and a wider
    one), and print the same line."""
    src = tmp_path / "a.libsvm"
    src.write_text("+1 1:0.5 3:1\n-1 2:2\n+1 4:0.125 2:3\n")
    msrc = tmp_path / "digits.csv"
    rng = np.random.default_rng(1)
    rows = ["0,127.5,0", "3,255,255"] + [
        f"{d}," + ",".join(str(int(v)) for v in rng.integers(0, 256, 2))
        for d in rng.integers(0, 10, 20)]
    msrc.write_text("\n".join(rows) + "\n")
    for argv, extra in ((["adult", str(src)], ["--num-features", "6"]),
                        (["adult", str(src)], []),
                        (["mnist_even_odd", str(msrc)], [])):
        out = {}
        for name, main in (("port", tconv.main), ("jax", jconv.main)):
            dst = str(tmp_path / f"{name}.csv")
            assert main(argv + [dst] + extra) == 0
            said = capsys.readouterr().out.replace(dst, "DST")
            with open(dst, "rb") as fh:
                out[name] = (fh.read(), said)
        assert out["port"] == out["jax"]
    assert out["port"][0].startswith(b"1,0.5,0.0\n-1,1.0,1.0\n")


def test_converters_module_runs(tmp_path):
    """`python -m dpsvm_tpu_torch.data.converters` is runnable."""
    src = tmp_path / "a.libsvm"
    src.write_text("+1 1:1 3:1\n-1 2:1\n")
    dst = tmp_path / "a.csv"
    proc = subprocess.run(
        [sys.executable, "-m", "dpsvm_tpu_torch.data.converters", "adult",
         str(src), str(dst)], capture_output=True, text=True, cwd=ROOT,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "2 rows x 3 features" in proc.stdout
    assert dst.read_text() == "1,1.0,0.0,1.0\n-1,0.0,1.0,0.0\n"


# ---- obs: the default registry and the build seconds -----------------


@pytest.mark.parametrize("env,on", [("1", True), ("0", False), ("", False),
                                    (None, False)])
def test_default_registry_follows_dpsvm_obs(monkeypatch, env, on):
    """get_registry reads DPSVM_OBS once, when it first makes the
    default (JAX's tests/test_obs.py:98 resets it the same way); enable
    switches it; a disabled registry hands out NULL, which does
    nothing, as JAX's does."""
    for mod in (tmetrics, jmetrics):
        if env is None:
            monkeypatch.delenv("DPSVM_OBS", raising=False)
        else:
            monkeypatch.setenv("DPSVM_OBS", env)
        monkeypatch.setattr(mod, "_DEFAULT", None)
    reg_t, reg_j = tmetrics.get_registry(), jmetrics.get_registry()
    assert reg_t.enabled == reg_j.enabled == on
    assert tmetrics.get_registry() is reg_t
    monkeypatch.setenv("DPSVM_OBS", "0" if on else "1")
    assert tmetrics.get_registry().enabled == on  # read once
    for mod, reg in ((tmetrics, reg_t), (jmetrics, reg_j)):
        assert mod.enable(not on) is reg and reg.enabled == (not on)
        assert mod.enable() is reg and reg.enabled
        c = reg.counter("x")
        c.add(3)
        assert c.value == 3 and reg.snapshot() == {"x": 3}
        mod.enable(False)
        null = reg.counter("y")
        assert null is mod.NULL and reg.histogram("z") is mod.NULL
        null.add(5)
        null.observe(1.0)
        null.set(2)
    for attr in ("name", "value", "count"):
        assert getattr(tmetrics.NULL, attr) == getattr(jmetrics.NULL, attr)
    assert tmetrics.NULL.snapshot() is jmetrics.NULL.snapshot() is None
    assert tmetrics.NULL.percentiles() == jmetrics.NULL.percentiles() == {}
    assert len(tmetrics.NULL) == len(jmetrics.NULL) == 0
    assert tmetrics.NULL.window_values().shape == (0,)
    import dpsvm_tpu_torch.obs as tobs
    import dpsvm_tpu.obs as jobs

    assert tobs.get_registry is tmetrics.get_registry
    assert tobs.enable is tmetrics.enable
    assert {"enable", "get_registry"} <= set(tobs.__all__) & set(
        jobs.__all__)


def test_compile_seconds_total_counts_recorded_builds(monkeypatch):
    """A float >= 0 (JAX's rounding: six places) that a recorded build
    raises by its seconds, beside compiles_total."""
    monkeypatch.setattr(tcompilelog, "_compiles", 0)
    monkeypatch.setattr(tcompilelog, "_seconds", 0.0)
    total = tcompilelog.compile_seconds_total()
    assert isinstance(total, float) and total == 0.0
    assert isinstance(jcompilelog.compile_seconds_total(), float)
    tcompilelog.record("build/probe", 0.25)
    tcompilelog.record("graph/probe", 1.0000004)
    assert tcompilelog.compiles_total() == 2
    assert tcompilelog.compile_seconds_total() == round(1.2500004, 6)


# ---- the native build -------------------------------------------------


def test_build_all_raises_with_the_compiler_diagnostic(monkeypatch,
                                                       tmp_path):
    """A compiler forced to fail (a flag g++ refuses): build_all raises
    RuntimeError naming each component and carrying the compiler's
    message, as the JAX package's does. Into a fresh directory, so no
    earlier build is reused."""
    bad = "-fdpsvm-no-such-flag"
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "port"))
    monkeypatch.setattr(tnative, "CXX_FLAGS", (*tnative.CXX_FLAGS, bad))
    monkeypatch.setattr(tnative, "build_errors", {})
    monkeypatch.setattr(jnative, "_BUILD_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(jnative, "_CXX_FLAGS", [*jnative._CXX_FLAGS, bad])
    monkeypatch.setattr(jnative, "_build_errors", {})
    said = {}
    for name, fn in (("port", tnative.build_all), ("jax", jnative.build_all)):
        with pytest.raises(RuntimeError) as err:
            fn()
        said[name] = str(err.value)
    for text in said.values():
        assert text.startswith("native build failed:")
        assert "[fastcsv]" in text and "[seqsmo]" in text
        assert bad in text
    assert not any(f.endswith(".so") for _, _, fs in os.walk(tmp_path)
                   for f in fs)


def test_build_all_builds_both(monkeypatch, tmp_path):
    """With the real flags: both libraries built and loadable."""
    import ctypes

    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tnative, "build_errors", {})
    try:
        built = tnative.build_all()
    except RuntimeError as e:
        if "No such file" in str(e) or "not found" in str(e):
            pytest.skip(f"no C++ compiler here: {e}")
        raise
    assert [os.path.basename(p) for p in built] == ["fastcsv.so",
                                                    "seqsmo.so"]
    for p in built:
        ctypes.CDLL(p)


# ---- the console entries and the serving warning ----------------------


@pytest.mark.parametrize("entry,command", [("train_main", "train"),
                                           ("test_main", "test"),
                                           ("serve_main", "serve")])
def test_console_entries_pass_argv_through(monkeypatch, entry, command):
    argv = ["svm" + command, "-f", "train.csv", "-m", "model.txt"]
    monkeypatch.setattr(sys, "argv", argv)
    seen = {}
    for name, mod in (("port", tcli), ("jax", jcli)):
        monkeypatch.setattr(mod, "main",
                            lambda a, _n=name: seen.setdefault(_n, a) and 7)
        assert getattr(mod, entry)() == 7
    assert seen["port"] == seen["jax"] == [command] + argv[1:]


def _ensemble(scale: float):
    rng = np.random.default_rng(5)
    return types.SimpleNamespace(
        sv_union=rng.normal(size=(300, 16)).astype(np.float32),
        coef=(scale * rng.normal(size=(300, 2))).astype(np.float32))


@pytest.mark.parametrize("scale,kind", [(1e4, "rbf"), (1e-4, "rbf"),
                                        (1e4, "linear"),
                                        (1e4, "precomputed")])
def test_bf16_serving_warning_is_jaxs(scale, kind):
    """warn_if_bf16_serving_risky warns exactly where the JAX one does:
    a large-coefficient ensemble under rbf or linear, not a small one,
    never for a precomputed kernel."""
    ens = _ensemble(scale)
    said = {}
    for name, mod, kp in (("port", tserve, KernelParams(kind, 0.5)),
                          ("jax", jserve, JaxKernelParams(kind, 0.5))):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            assert mod.warn_if_bf16_serving_risky(ens, kp) is None
        said[name] = [str(w.message).split(":")[0] for w in caught]
    assert said["port"] == said["jax"]
    assert bool(said["port"]) == (scale > 1 and kind != "precomputed")


def test_package_exports_are_jaxs():
    assert dpsvm_tpu_torch.__version__ == dpsvm_tpu.__version__ == "0.1.0"
    assert dpsvm_tpu_torch.data.load_csv is not None
    assert dpsvm_tpu_torch.decision_risk.__module__ == \
        "dpsvm_tpu_torch.predict"
    from dpsvm_tpu_torch import ops, solver
    from dpsvm_tpu_torch.solver.solve import solve

    assert solver.solve_single_chip is solve
    assert ops.row_dots.__module__ == "dpsvm_tpu_torch.ops.kernels"
    assert ops.up_mask.__module__ == "dpsvm_tpu_torch.ops.select"


# ---- the name diffs -----------------------------------------------------


@pytest.mark.parametrize("package", ["dpsvm_tpu", "dpsvm_tpu.ops",
                                     "dpsvm_tpu.solver", "dpsvm_tpu.obs",
                                     "dpsvm_tpu.data"])
def test_every_exported_name_has_a_counterpart(package):
    jax_mod = importlib.import_module(package)
    port = importlib.import_module(
        package.replace("dpsvm_tpu", "dpsvm_tpu_torch", 1))
    missing = [n for n in jax_mod.__all__ if not hasattr(port, n)]
    assert not missing, f"{package}: {missing}"
    assert set(jax_mod.__all__) <= set(port.__all__)


def _jax_modules() -> list:
    out = []
    pkg = os.path.join(ROOT, "dpsvm_tpu")
    for root, _, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), ROOT)[:-3]
                name = rel.replace(os.sep, ".")
                out.append(name[:-len(".__init__")]
                           if name.endswith(".__init__") else name)
    return sorted(out)


def _defined(mod) -> set:
    """The public functions and classes `mod` defines (a jitted function
    by the function it wraps)."""
    names = set()
    for n, v in vars(mod).items():
        target = getattr(v, "__wrapped__", v)
        if not n.startswith("_") \
                and (inspect.isfunction(target) or inspect.isclass(target)) \
                and getattr(target, "__module__", None) == mod.__name__:
            names.add(n)
    return names


def test_every_public_name_of_a_jax_module_has_a_counterpart():
    gaps = {}
    for name in _jax_modules():
        port_name = name.replace("dpsvm_tpu", "dpsvm_tpu_torch", 1)
        if name in JAX_ONLY_MODULES:
            assert importlib.util.find_spec(port_name) is None, port_name
            continue
        port = importlib.import_module(port_name)
        jax_mod = importlib.import_module(name)
        moved = MOVED.get(name, {})
        for n in sorted(_defined(jax_mod)):
            if n in JAX_ONLY.get(name, ()):
                assert not hasattr(port, n), f"{port_name}.{n} exists"
            elif n in moved:
                assert hasattr(importlib.import_module(moved[n]), n), n
            elif not hasattr(port, n):
                gaps.setdefault(name, []).append(n)
    assert not gaps, gaps
    # The lists name what the JAX package has.
    for name, names in {**JAX_ONLY, **MOVED}.items():
        assert set(names) <= _defined(importlib.import_module(name)), name
