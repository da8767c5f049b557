"""The port stands alone: no module of dpsvm_tpu_torch (nor chip_smoke.py,
nor tools/obs_idle_share.py) imports jax or the JAX package, and its
entry points refuse to fall back to the CPU when no CUDA device is
there.

The check is an AST scan of the import statements: this container may
import jax at interpreter start, so sys.modules proves nothing. The
top-level name is compared exactly, because "dpsvm_tpu_torch" starts
with "dpsvm_tpu"."""

import ast
import os

import numpy as np
import pytest
import torch

import dpsvm_tpu_torch
from dpsvm_tpu_torch import (SVMConfig, SVMModel, accuracy,
                             decision_function, predict, solve, train)
from dpsvm_tpu_torch import cli
from dpsvm_tpu_torch.ops.kernels import KernelParams

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(dpsvm_tpu_torch.__file__)


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "tools", "obs_idle_share.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(top: str) -> bool:
    return top == "dpsvm_tpu" or top == "jax" or top.startswith("jax")


def _imported_tops(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_scan_covers_the_package():
    srcs = _sources()
    assert len(srcs) >= 15
    names = {os.path.relpath(p, ROOT) for p in srcs}
    assert "chip_smoke.py" in names
    for mod in (("ops", "subproblem.py"), ("ops", "fused_update.py"),
                ("solver", "cache.py"), ("solver", "smo.py"),
                ("ops", "ring.py"), ("parallel", "__init__.py"),
                ("parallel", "mesh.py"), ("parallel", "dist_block.py"),
                ("parallel", "dist_smo.py"), ("data", "converters.py"),
                ("data", "loader.py"), ("data", "synth.py"),
                ("utils", "__init__.py"), ("utils", "native.py"),
                ("utils", "checkpoint.py"), ("solver", "chunks.py"),
                ("solver", "reference.py"), ("solver", "reconstruct.py"),
                ("solver", "fleet.py"), ("models", "multiclass.py"),
                ("models", "platt.py"), ("models", "precomputed.py"),
                ("estimators.py",), ("serve.py",),
                ("serving", "__init__.py"), ("serving", "registry.py"),
                ("serving", "scheduler.py"), ("serving", "engine_core.py"),
                ("serving", "dispatch.py"), ("serving", "wire.py"),
                ("serving", "server.py"), ("serving", "client.py"),
                ("serving", "replicas.py"), ("obs", "metrics.py"),
                ("obs", "export.py"), ("obs", "trace.py"),
                ("testing", "faults.py"), ("ops", "ooc.py"),
                ("solver", "ooc.py"), ("solver", "warmstart.py"),
                ("solver", "cascade.py"), ("learn.py",),
                ("obs", "__init__.py"), ("obs", "runlog.py"),
                ("obs", "compilelog.py"), ("obs", "analyze.py"),
                ("utils", "metrics.py"), ("autotune", "__init__.py"),
                ("autotune", "probe.py"), ("autotune", "probes.py"),
                ("autotune", "profile.py"), ("analysis", "__init__.py"),
                ("analysis", "concurrency_facts.py"),
                ("analysis", "threadlint.py")):
        assert os.path.join("dpsvm_tpu_torch", *mod) in names


def test_native_sources_are_the_ports_own():
    """The host parser and SeqSMO build from the port's copies into
    build/torch_native/, never from (or into) the JAX side's native/."""
    from dpsvm_tpu_torch.utils import native

    assert native.SRC_DIR == os.path.join(PKG, "native")
    assert native.BUILD_DIR == os.path.join(ROOT, "build", "torch_native")
    for stem in ("fastcsv", "seqsmo"):
        assert os.path.exists(os.path.join(native.SRC_DIR, f"{stem}.cpp"))
    for path in _sources():
        text = open(path).read()
        assert "native/_build" not in text and '"_build")' not in text, path


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    bad = [(t, ln) for t, ln in _imported_tops(path) if _forbidden(t)]
    assert not bad, f"{path} imports {bad}"


def test_scan_matches_names_exactly():
    assert _forbidden("dpsvm_tpu") and _forbidden("jax")
    assert _forbidden("jaxlib")
    assert not _forbidden("dpsvm_tpu_torch")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _data():
    x = np.random.default_rng(0).random((8, 3)).astype(np.float32)
    y = np.array([1, -1] * 4, np.int32)
    return x, y


def test_default_device_raises_without_cuda(no_cuda, tmp_path):
    x, y = _data()
    cfg = SVMConfig(engine="block", working_set_size=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve(x, y, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(x, y, cfg)
    model = SVMModel(x[:2], np.ones(2, np.float32), y[:2], 0.0,
                     KernelParams("rbf", 0.5))
    for fn in (decision_function, predict):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(model, x)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        accuracy(model, x, y)
    csv = tmp_path / "t.csv"
    csv.write_text("".join(f"{int(b)},{a[0]},{a[1]},{a[2]}\n"
                           for a, b in zip(x, y)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["train", "-f", str(csv), "-m", str(tmp_path / "m.txt"),
                  "--engine", "block", "--working-set-size", "4"])


@pytest.mark.parametrize("fn", [decision_function, predict, accuracy])
@pytest.mark.parametrize("precision", ["float64", "auto"])
def test_host_precision_paths_raise_without_cuda(no_cuda, fn, precision):
    """The float64 host path (taken by 'auto' when decision_risk is
    high, as with these large coefficients) also refuses device=None."""
    x, y = _data()
    model = SVMModel(x[:2], np.full(2, 1e7, np.float32), y[:2], 0.0,
                     KernelParams("rbf", 0.5))
    args = (model, x, y) if fn is accuracy else (model, x)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn(*args, precision=precision)
    out = fn(*args, precision=precision, device="cpu")
    assert np.all(np.isfinite(out))


def test_explicit_cpu_runs(no_cuda):
    x, y = _data()
    res = solve(x, y, SVMConfig(engine="block", working_set_size=4),
                device="cpu")
    assert res.stats["device"] == "cpu"
    assert res.iterations > 0


def test_new_entry_points_raise_without_cuda(no_cuda):
    """The fleet, the multiclass trainer and predictor, the precomputed
    model and the estimators refuse device=None without a card, and run
    on device="cpu"."""
    from dpsvm_tpu_torch.estimators import SVC
    from dpsvm_tpu_torch.models.multiclass import (predict_multiclass,
                                                   train_multiclass)
    from dpsvm_tpu_torch.models.precomputed import PrecomputedSVCModel
    from dpsvm_tpu_torch.solver.fleet import FleetProblem, solve_fleet

    x, y = _data()
    y3 = np.arange(8) % 3
    cfg = SVMConfig(gamma=0.5)
    calls = (
        lambda **d: solve_fleet(x, [FleetProblem(y=y)], cfg, **d),
        lambda **d: train_multiclass(x, y3, cfg, **d),
        lambda **d: PrecomputedSVCModel([0, 1], [1.0, -1.0], 0.0,
                                        3).decision_function(x, **d),
        lambda **d: SVC(gamma=0.5, **d).fit(x, y),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        call(device="cpu")
    mc, _ = train_multiclass(x, y3, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        predict_multiclass(mc, x)


def test_serving_entry_points_raise_without_cuda(no_cuda):
    """PredictServer, ServingEngine and ReplicaFleet refuse device=None
    without a card, and serve on device="cpu"."""
    from dpsvm_tpu_torch import PredictServer, ServeConfig
    from dpsvm_tpu_torch.serving import ReplicaFleet, ServingEngine

    x, y = _data()
    model = SVMModel(x[:2], np.ones(2, np.float32), y[:2], 0.0,
                     KernelParams("rbf", 0.5))
    fleet_cfg = ServeConfig(buckets=(16,), listen="127.0.0.1:0",
                            replicas=2)
    calls = (
        lambda **d: PredictServer(model, ServeConfig(buckets=(16,)), **d),
        lambda **d: ServingEngine(ServeConfig(buckets=(16,)), **d),
        lambda **d: ReplicaFleet(fleet_cfg, **d),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        obj = call(device="cpu")
        if hasattr(obj, "close"):
            obj.close()
    srv = PredictServer(model, ServeConfig(buckets=(16,)), device="cpu")
    np.testing.assert_array_equal(
        srv.predict(x), predict(model, x, precision="float32",
                                device="cpu"))


def test_out_of_core_and_warm_entry_points_raise_without_cuda(no_cuda,
                                                              tmp_path):
    """solve with ooc or a warm start, the warm rebuild, the cascade, the
    warm C sweep, the learning loop and `cli learn` refuse device=None
    without a card, and run on device="cpu"."""
    from dpsvm_tpu_torch.estimators import svc_c_sweep
    from dpsvm_tpu_torch.learn import run_learn, synthetic_stream
    from dpsvm_tpu_torch.solver.cascade import cascade_solve
    from dpsvm_tpu_torch.solver.warmstart import WarmStart, warm_f_rebuild

    x, y = _data()
    cfg = SVMConfig(engine="block", working_set_size=4, gamma=0.5)
    ooc = cfg.replace(ooc=True, ooc_tile_rows=8)
    seed = WarmStart(alpha=np.full(8, 0.5))
    kp = KernelParams("rbf", 0.5)
    calls = (
        lambda **d: solve(x, y, ooc, **d),
        lambda **d: solve(x, y, cfg, warm_start=seed, **d),
        lambda **d: warm_f_rebuild(x, y, np.full(8, 0.5), kp, **d),
        lambda **d: cascade_solve(x, y, cfg, seed=seed, block_rows=4, **d),
        lambda **d: svc_c_sweep(x, y, [0.5, 1.0], warm=True, gamma=0.5,
                                backend="single", **d),
        lambda **d: run_learn(synthetic_stream(0, 3, 24, 2, 0.1),
                              SVMConfig(gamma=0.5), str(tmp_path / "m"),
                              kp, **d),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        call(device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["learn", "--smoke", "--model-dir", str(tmp_path / "l")])


def test_obs_and_mesh_stream_entry_points_raise_without_cuda(no_cuda,
                                                             tmp_path):
    """The out-of-core mesh stream with no mesh, a run log asking for a
    device trace, and `cli train --obs` refuse device=None without a
    card and run on the CPU; `cli obs` reads files and needs no device."""
    from dpsvm_tpu_torch import Mesh, solve_mesh
    from dpsvm_tpu_torch.config import ObsConfig
    from dpsvm_tpu_torch.obs import run_obs
    from dpsvm_tpu_torch.solver.ooc import solve_ooc_mesh

    x, y = _data()
    ooc = SVMConfig(engine="block", working_set_size=4, gamma=0.5,
                    ooc=True, ooc_tile_rows=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_ooc_mesh(x, y, ooc)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_mesh(x, y, ooc)
    assert solve_mesh(x, y, ooc, mesh=Mesh(["cpu"] * 2)).stats["ooc_mesh"]
    traced = SVMConfig(obs=ObsConfig(enabled=True,
                                     runlog_dir=str(tmp_path / "runs"),
                                     trace_dir=str(tmp_path / "trace")))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_obs("solve", traced)
    run_obs("solve", traced, device="cpu").finish()
    csv = tmp_path / "t.csv"
    csv.write_text("".join(f"{int(b)},{a[0]},{a[1]},{a[2]}\n"
                           for a, b in zip(x, y)))
    argv = ["train", "-f", str(csv), "-m", str(tmp_path / "m.txt"),
            "--engine", "block", "--working-set-size", "4", "--obs",
            "--obs-dir", str(tmp_path / "runs"), "--trace-dir",
            str(tmp_path / "trace")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv)
    assert cli.main(argv + ["--device", "cpu", "-q"]) == 0
    assert cli.main(["obs", "report", str(tmp_path / "runs")]) == 0


def test_autotune_entry_points_raise_without_cuda(no_cuda):
    """A probe pass and `autotune show` look at the CUDA card unless told
    otherwise: no silent CPU profile."""
    from dpsvm_tpu_torch.autotune import run_probes

    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_probes(knobs=["pipeline"], smoke=True, verbose=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["autotune", "show"])
    assert cli.main(["autotune", "show", "--device", "cpu"]) == 0
