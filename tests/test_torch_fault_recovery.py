"""Fault recovery in the port (solver/smo.py run_with_fault_retry and
_solve_with_degradation, solver/block.py demote_to_safe, the solver's
fault seams of testing/faults.py) against the JAX package's, on the CPU.

Every fault is injected through a seam (``dispatch``, ``ooc_tile_put``,
``ckpt_truncate``, ``nonfinite_obs``), and each test asserts that it
fired (``plan.fired``). The one monkeypatch left is the classifier's:
the seams only raise the transient class, so the non-transient and the
CUDA device-fault cases inject their own error.

Contracts held here:
* a transient fault is retried, resuming from the checkpoint this run
  wrote (the result equals the uninterrupted run's), or restarting when
  there is none; a stale checkpoint is never resumed; the budget runs
  out; a non-transient error propagates unretried; a CUDA device fault
  propagates with the relaunch advice;
* the retry works on the mesh and on both out-of-core solvers;
* ckpt_truncate keeps the previous checkpoint generation intact;
* nonfinite_obs demotes a bf16 fused-fold configuration once (to the
  safe configuration's exact result) and raises on a safe one;
  demote_to_safe's knob inventory is the JAX package's;
* fault, retry and demotion events reach the run log.
"""

import os
import warnings

import numpy as np
import pytest

from dpsvm_tpu.config import SVMConfig as JaxConfig
from dpsvm_tpu.solver import block as jblock
from dpsvm_tpu.solver import smo as jsmo
from dpsvm_tpu.testing import faults as jfaults
from dpsvm_tpu_torch import Mesh, SVMConfig, solve, solve_mesh
from dpsvm_tpu_torch.config import ObsConfig
from dpsvm_tpu_torch.data.synth import make_blobs_binary
from dpsvm_tpu_torch.obs import analyze
from dpsvm_tpu_torch.obs.runlog import read_runlog, records_for
from dpsvm_tpu_torch.solver import block as tblock
from dpsvm_tpu_torch.solver import chunks
from dpsvm_tpu_torch.solver import smo as tsmo
from dpsvm_tpu_torch.solver.chunks import NonFiniteTrajectory
from dpsvm_tpu_torch.testing import faults

CFG = SVMConfig(c=1.0, gamma=0.1, epsilon=1e-3, max_iter=100_000,
                engine="block", working_set_size=32, chunk_iters=64,
                checkpoint_every=64, retry_faults=2)


@pytest.fixture(scope="module")
def blobs():
    return make_blobs_binary(n=300, d=10, seed=3, sep=1.2)


@pytest.fixture(autouse=True)
def no_backoff(monkeypatch):
    monkeypatch.setattr(tsmo, "_RETRY_BACKOFF_S", ())
    for var in ("DPSVM_OBS", "DPSVM_FAULTS"):
        monkeypatch.delenv(var, raising=False)


def cpu_solve(x, y, cfg, **kw):
    return solve(x, y, cfg, device="cpu", **kw)


def _same(a, b):
    np.testing.assert_array_equal(a.alpha, b.alpha)
    assert (a.iterations, a.b) == (b.iterations, b.b)


# ------------------------------------------------------------- the retry

def test_retry_resumes_from_this_runs_checkpoint(blobs, tmp_path):
    """The 3rd chunk faults; the retry resumes the checkpoint written by
    chunks 1-2 and lands on the uninterrupted run's optimum."""
    x, y = blobs
    full = cpu_solve(x, y, CFG.replace(retry_faults=0))
    with faults.install(faults.FaultPlan.parse("dispatch@3")) as plan:
        res = cpu_solve(x, y, CFG, checkpoint_path=str(tmp_path / "c.npz"))
    assert plan.fired["dispatch"] == 1
    assert res.converged
    np.testing.assert_allclose(res.alpha, full.alpha, atol=1e-5)
    assert res.b == pytest.approx(full.b, abs=1e-5)


def test_retry_without_checkpoint_restarts(blobs):
    """An unobserved solve is one chunk: fault it, and the retry
    restarts (chunked by the no-op observer) and converges."""
    x, y = blobs
    with faults.install(faults.FaultPlan.parse("dispatch@1")) as plan:
        res = cpu_solve(x, y, CFG.replace(checkpoint_every=0))
    assert plan.fired["dispatch"] == 1
    assert res.converged and res.stats["chunks"] > 1


def test_retry_never_resumes_a_stale_checkpoint(blobs, tmp_path):
    from dpsvm_tpu_torch.utils.checkpoint import save_checkpoint

    x, y = blobs
    p = str(tmp_path / "stale.npz")
    cfg = CFG.replace(checkpoint_every=0)
    prev = cpu_solve(x, y, cfg.replace(retry_faults=0))
    save_checkpoint(p, prev.alpha, prev.stats["f"], prev.iterations - 1,
                    prev.b_hi, prev.b_lo, cfg)
    with faults.install(faults.FaultPlan.parse("dispatch@1")) as plan:
        res = cpu_solve(x, y, cfg, checkpoint_path=p)
    assert plan.fired["dispatch"] == 1
    assert res.converged and "resumed_from" not in res.stats
    assert res.iterations == prev.iterations


def test_retry_budget_runs_out(blobs, tmp_path):
    x, y = blobs
    with faults.install(faults.FaultPlan.parse("dispatch@1x64")) as plan:
        with pytest.raises(RuntimeError, match="UNAVAILABLE"):
            cpu_solve(x, y, CFG, checkpoint_path=str(tmp_path / "c.npz"))
    assert plan.fired["dispatch"] == CFG.retry_faults + 1


@pytest.mark.parametrize("error,retried", [
    ("INVALID_ARGUMENT: a real bug", False),
    ("INTERNAL ASSERT FAILED at some.cpp", False),
    ("UNAVAILABLE: the runtime went away", True),
    ("connection reset by peer", True),
    ("CUDA error: an illegal memory access was encountered", False),
])
def test_classifier_reads_jax_markers(blobs, monkeypatch, error, retried):
    """The transient classifier is the JAX package's on its status words;
    a CUDA device fault is never retried in the process and propagates
    with the relaunch advice."""
    calls = {"n": 0}
    orig = tblock.run_chunk_block

    def faulty(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError(error)
        return orig(*a, **kw)

    monkeypatch.setattr(tblock, "run_chunk_block", faulty)
    x, y = blobs
    if retried:
        assert cpu_solve(x, y, CFG.replace(checkpoint_every=0)).converged
        assert calls["n"] >= 2  # the retry runs chunked
        assert jsmo._is_transient_fault(RuntimeError(error))
        return
    with pytest.raises(RuntimeError) as err:
        cpu_solve(x, y, CFG.replace(checkpoint_every=0))
    assert calls["n"] == 1
    assert error in str(err.value)
    assert ("--resume --checkpoint" in str(err.value)) == ("CUDA" in error)


def test_retry_perturbs_the_config_as_jax_does(monkeypatch):
    """Attempt k runs chunk_iters + k and tau (1 + k 1e-6), resuming
    only a checkpoint of its own, in both packages."""
    import jax

    monkeypatch.setattr(jsmo, "_RETRY_BACKOFF_S", ())
    seen = {"port": [], "jax": []}

    def attempt_of(store, err):
        def attempt(cfg_k, res_k, k):
            store.append((cfg_k.chunk_iters, cfg_k.tau, res_k))
            if k < 2:
                raise err("UNAVAILABLE: injected")
            return "ok"
        return attempt

    assert tsmo.run_with_fault_retry(
        CFG, None, False, attempt_of(seen["port"], RuntimeError)) == "ok"
    assert jsmo.run_with_fault_retry(
        JaxConfig(chunk_iters=64, retry_faults=2), None, False,
        attempt_of(seen["jax"], jax.errors.JaxRuntimeError)) == "ok"
    assert seen["port"] == seen["jax"]
    assert [s[0] for s in seen["port"]] == [64, 65, 66]


# ------------------------------------------ the mesh and the ooc solvers

def test_mesh_retry_resumes(blobs, tmp_path):
    x, y = blobs
    full = solve_mesh(x, y, CFG.replace(retry_faults=0),
                      mesh=Mesh(["cpu"] * 2))
    with faults.install(faults.FaultPlan.parse("dispatch@3")) as plan:
        res = solve_mesh(x, y, CFG, mesh=Mesh(["cpu"] * 2),
                         checkpoint_path=str(tmp_path / "c.npz"))
    assert plan.fired["dispatch"] == 1
    assert res.converged
    np.testing.assert_allclose(res.alpha, full.alpha, atol=1e-5)


@pytest.mark.parametrize("mesh", [False, True])
def test_ooc_tile_put_retries_from_the_checkpoint(blobs, tmp_path, mesh):
    """An upload fault mid-stream (the 9th tile or step upload, after
    checkpoints exist) is retried from this run's checkpoint; the resume
    is bitwise, so the result is the uninterrupted run's."""
    x, y = blobs
    cfg = CFG.replace(ooc=True, ooc_tile_rows=64, checkpoint_every=1)
    run = ((lambda c, **kw: solve_mesh(x, y, c, mesh=Mesh(["cpu"] * 2),
                                       **kw)) if mesh
           else (lambda c, **kw: cpu_solve(x, y, c, **kw)))
    full = run(cfg.replace(retry_faults=0))
    with faults.install(faults.FaultPlan.parse("ooc_tile_put@9")) as plan:
        res = run(cfg, checkpoint_path=str(tmp_path / "c.npz"))
    assert plan.fired["ooc_tile_put"] == 1
    assert res.stats["resumed_from"] > 0
    _same(res, full)


@pytest.mark.parametrize("mesh", [False, True])
def test_ooc_dispatch_seam_retries(blobs, mesh):
    x, y = blobs
    cfg = CFG.replace(ooc=True, ooc_tile_rows=64, checkpoint_every=0)
    with faults.install(faults.FaultPlan.parse("dispatch@2")) as plan:
        res = (solve_mesh(x, y, cfg, mesh=Mesh(["cpu"] * 2)) if mesh
               else cpu_solve(x, y, cfg))
    assert plan.fired["dispatch"] == 1 and res.converged


# ------------------------------------------------------ checkpoint writes

def test_truncated_write_keeps_the_previous_generation(tmp_path):
    from dpsvm_tpu_torch.utils.checkpoint import (load_checkpoint_state,
                                                  save_checkpoint)

    cfg = SVMConfig(c=1.0, gamma=0.1)
    p = str(tmp_path / "ck.npz")
    alpha = np.arange(6, dtype=np.float32)
    save_checkpoint(p, alpha, -alpha, 100, -0.5, 0.5, cfg)
    before = open(p, "rb").read()
    with faults.install(faults.FaultPlan.parse("ckpt_truncate")) as plan:
        with pytest.raises(faults.FaultInjected, match="preemption"):
            save_checkpoint(p, alpha * 2, -alpha, 200, 0.0, 0.0, cfg)
    assert plan.fired["ckpt_truncate"] == 1
    assert open(p, "rb").read() == before
    assert not [t for t in os.listdir(tmp_path) if t.endswith(".tmp")]
    assert load_checkpoint_state(p).iteration == 100


def test_truncated_write_mid_solve_leaves_a_resumable_file(blobs, tmp_path):
    """The 3rd checkpoint write of a solve dies mid-save: the solve
    fails (not a device fault), the file holds the 2nd write, and a
    resume from it reaches the uninterrupted optimum."""
    x, y = blobs
    cfg = CFG.replace(retry_faults=0)
    p = str(tmp_path / "ck.npz")
    full = cpu_solve(x, y, cfg)
    with faults.install(faults.FaultPlan.parse("ckpt_truncate@3")) as plan:
        with pytest.raises(faults.FaultInjected):
            cpu_solve(x, y, cfg, checkpoint_path=p)
    assert plan.fired["ckpt_truncate"] == 1
    res = cpu_solve(x, y, cfg, checkpoint_path=p, resume=True)
    assert res.stats.get("chunks") and res.converged
    np.testing.assert_allclose(res.alpha, full.alpha, atol=1e-5)


# ------------------------------------------------- non-finite -> demotion

def test_nonfinite_obs_demotes_a_bf16_fused_fold_config(blobs):
    x, y = blobs
    cfg = CFG.replace(checkpoint_every=0, dtype="bfloat16",
                      fused_fold=True)
    cb = lambda *a: None  # noqa: E731
    safe, _ = tblock.demote_to_safe(cfg)
    ref = cpu_solve(x, y, safe, callback=cb)
    with faults.install(faults.FaultPlan.parse("nonfinite_obs@2")) as plan, \
            warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res = cpu_solve(x, y, cfg, callback=cb)
    assert plan.fired["nonfinite_obs"] == 1
    assert res.stats["demoted_faults"] == 1
    assert res.stats["demotion"]["dropped"] == ["dtype=bfloat16",
                                                "fused_fold"]
    assert any("DEMOTING" in str(m.message) for m in w)
    assert res.converged
    _same(res, ref)


@pytest.mark.parametrize("where", ["single", "mesh", "ooc"])
def test_nonfinite_obs_on_a_safe_config_raises(blobs, where):
    x, y = blobs
    cfg = CFG.replace(checkpoint_every=0)
    if where == "ooc":
        cfg = cfg.replace(ooc=True, ooc_tile_rows=64)
    with faults.install(faults.FaultPlan.parse("nonfinite_obs@1")) as plan:
        with pytest.raises(NonFiniteTrajectory, match="non-finite"):
            if where == "mesh":
                solve_mesh(x, y, cfg, mesh=Mesh(["cpu"] * 2),
                           callback=lambda *a: None)
            else:
                cpu_solve(x, y, cfg, callback=lambda *a: None)
    assert plan.fired["nonfinite_obs"] == 1


def test_mesh_nonfinite_obs_demotes(blobs):
    x, y = blobs
    cfg = CFG.replace(checkpoint_every=0, dtype="bfloat16")
    cb = lambda *a: None  # noqa: E731
    ref = solve_mesh(x, y, cfg.replace(dtype="float32"),
                     mesh=Mesh(["cpu"] * 2), callback=cb)
    with faults.install(faults.FaultPlan.parse("nonfinite_obs@2")) as plan, \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = solve_mesh(x, y, cfg, mesh=Mesh(["cpu"] * 2), callback=cb)
    assert plan.fired["nonfinite_obs"] == 1
    assert res.stats["demoted_faults"] == 1
    _same(res, ref)


@pytest.mark.parametrize("kw", [
    dict(), dict(dtype="bfloat16"), dict(fused_fold=True),
    dict(dtype="bfloat16", fused_fold=True, pipeline_rounds=True),
    dict(fused_round=True, bf16_gram=True), dict(fused_round=None),
])
def test_demote_to_safe_is_jaxs(kw):
    assert tblock._SAFE_KNOBS == jblock._SAFE_KNOBS
    t_cfg, t_drop = tblock.demote_to_safe(SVMConfig(engine="block", **kw))
    j_cfg, j_drop = jblock.demote_to_safe(JaxConfig(engine="block", **kw))
    assert t_drop == j_drop
    assert (t_cfg is None) == (j_cfg is None)
    if t_cfg is not None:
        for knob, _ in tblock._SAFE_KNOBS:
            assert getattr(t_cfg, knob) == getattr(j_cfg, knob)


def test_sentinel_sign_convention():
    inf = float("inf")
    chunks.check_obs_finite(-1.0, 1.0, 0, True, "t")
    chunks.check_obs_finite(inf, -inf, 0, True, "t")
    for bad in ((float("nan"), 1.0), (-1.0, float("nan")), (-inf, 1.0),
                (-1.0, inf)):
        with pytest.raises(NonFiniteTrajectory):
            chunks.check_obs_finite(bad[0], bad[1], 0, True, "t")
        with pytest.raises(jsmo.NonFiniteTrajectory):
            jsmo.check_obs_finite(bad[0], bad[1], 0, "t")


# ------------------------------------------------------- the event trail

def test_fault_retry_and_demotion_events_reach_the_run_log(blobs, tmp_path):
    x, y = blobs
    obs = ObsConfig(enabled=True, runlog_dir=str(tmp_path))
    cb = lambda *a: None  # noqa: E731
    with faults.install(faults.FaultPlan.parse("dispatch@2")) as plan:
        res = cpu_solve(x, y, CFG.replace(obs=obs, checkpoint_every=0),
                        callback=cb)
    assert plan.fired["dispatch"] == 1
    events = records_for(read_runlog(res.stats["obs_runlog"]),
                         res.stats["obs_run_id"], "event")
    assert [e["name"] for e in events] == ["fault", "retry"]
    assert "injected fault" in events[0]["error"]
    with faults.install(faults.FaultPlan.parse("nonfinite_obs@1")), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dem = cpu_solve(x, y, CFG.replace(obs=obs, checkpoint_every=0,
                                          dtype="bfloat16"), callback=cb)
    names = [e["name"] for e in records_for(
        read_runlog(dem.stats["obs_runlog"]), dem.stats["obs_run_id"],
        "event")]
    assert names == ["demotion"]
    runs = analyze.load_runs([str(tmp_path)])
    aborted = [r for r in runs if r.final and r.final.get("aborted")]
    assert len(aborted) == 2  # the faulted and the non-finite attempt
    table = analyze.render_report([analyze.summarize_run(r) for r in runs])
    assert "f=1 r=1" in table and "d=1" in table


def test_seams_fire_identically_in_both_packages():
    """The plan grammar and the firing counts are the JAX package's."""
    for mod in (faults, jfaults):
        plan = mod.FaultPlan.parse("dispatch@2x2,ooc_tile_put@1")
        hits = [plan.arrive("dispatch") for _ in range(4)]
        assert hits == [False, True, True, False]
        assert plan.arrive("ooc_tile_put") and plan.fired["dispatch"] == 2
    with faults.install(faults.FaultPlan.parse("nonfinite_obs")) as plan:
        b_hi, b_lo = faults.poison_obs(-1.0, 1.0)
        assert b_hi != b_hi and b_lo != b_lo
        assert faults.poison_obs(-1.0, 1.0) == (-1.0, 1.0)
    assert plan.fired["nonfinite_obs"] == 1
