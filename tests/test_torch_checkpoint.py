"""Checkpoints, resume and the observed chunk loop of the port, held
against the JAX package: the cases of tests/test_checkpoint.py on the
port (round trip, v1 reading, interrupted equals uninterrupted, refusing
a mismatched config, periodic writes, abort forcing a checkpoint, fsync
order, rotation, falling back past corrupt generations), both
cross-package directions, and the JAX-only config keys."""

import dataclasses
import json
import os
import stat

import numpy as np
import pytest

from dpsvm_tpu.config import SVMConfig as JaxConfig
from dpsvm_tpu.solver.smo import solve as jsolve
from dpsvm_tpu.utils import checkpoint as jck
from dpsvm_tpu_torch import Mesh, SVMConfig, solve, solve_mesh
from dpsvm_tpu_torch.models import train_oneclass, train_svr
from dpsvm_tpu_torch.solver import chunks
from dpsvm_tpu_torch.utils import checkpoint as tck
from dpsvm_tpu_torch.utils.checkpoint import (PeriodicCheckpointer,
                                              checkpoint_generations,
                                              load_checkpoint,
                                              load_checkpoint_state,
                                              resume_state, save_checkpoint)

KW = dict(c=1.0, gamma=0.1, epsilon=1e-3, max_iter=100_000,
          cache_lines=16, chunk_iters=64, checkpoint_every=64)
CFG = SVMConfig(**KW)
BLOCK = CFG.replace(engine="block", working_set_size=16, cache_lines=0,
                    chunk_iters=128)  # inner 32: 4 rounds a chunk


def cpu_solve(x, y, cfg, **kw):
    return solve(x, y, cfg, device="cpu", **kw)


def _same(a, b):
    np.testing.assert_array_equal(a.alpha, b.alpha)
    np.testing.assert_array_equal(a.stats["f"], b.stats["f"])
    assert (a.iterations, a.b_hi, a.b_lo) == (b.iterations, b.b_hi, b.b_lo)


def test_checkpoint_roundtrip(tmp_path):
    p = str(tmp_path / "ck.npz")
    alpha = np.arange(5, dtype=np.float32)
    save_checkpoint(p, alpha, -alpha, 123, -0.5, 0.7, CFG)
    a2, f2, it, bh, bl, cfg = load_checkpoint(p)
    np.testing.assert_array_equal(a2, alpha)
    np.testing.assert_array_equal(f2, -alpha)
    assert it == 123 and bh == pytest.approx(-0.5) and bl == pytest.approx(0.7)
    assert cfg == CFG


def test_checkpoint_v2_full_carry_roundtrip(tmp_path):
    p = str(tmp_path / "ck2.npz")
    alpha = np.arange(5, dtype=np.float32)
    save_checkpoint(p, alpha, -alpha, 99, -0.1, 0.2, CFG,
                    f_err=alpha * 1e-7, rounds=17)
    st = load_checkpoint_state(p)
    assert st.format_version == tck.FORMAT_VERSION == 2
    np.testing.assert_array_equal(st.f_err, alpha * 1e-7)
    assert st.rounds == 17 and st.iteration == 99
    save_checkpoint(p, alpha, -alpha, 99, -0.1, 0.2, CFG)
    st = load_checkpoint_state(p)
    assert st.f_err is None and st.rounds == 0


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_file_format_is_the_jax_packages(tmp_path, writer):
    """The same arrays saved by either package: the other reads them
    bit for bit, and the configs are equal field by field."""
    alpha = np.linspace(0, 1, 7, dtype=np.float32)
    args = (alpha, -alpha, 42, -0.25, 0.5)
    p = str(tmp_path / f"{writer}.npz")
    if writer == "port":
        save_checkpoint(p, *args, CFG, f_err=alpha * 1e-8, rounds=3)
        st = jck.load_checkpoint_state(p)
    else:
        jck.save_checkpoint(p, *args, JaxConfig(**KW), f_err=alpha * 1e-8,
                            rounds=3)
        st = load_checkpoint_state(p)
    np.testing.assert_array_equal(st.alpha, alpha)
    np.testing.assert_array_equal(st.f_err, alpha * 1e-8)
    assert (st.iteration, st.rounds, st.format_version) == (42, 3, 2)
    with np.load(p) as z:
        cfg = json.loads(str(z["config_json"]))
    want = dataclasses.asdict(JaxConfig(**KW))
    assert cfg == json.loads(json.dumps(want))


def test_v1_checkpoint_loads_and_resumes(blobs_small, tmp_path):
    x, y = blobs_small
    full = cpu_solve(x, y, CFG)
    part = cpu_solve(x, y, CFG.replace(max_iter=128))
    p = str(tmp_path / "v1.npz")
    np.savez_compressed(
        p, format_version=1, alpha=part.alpha, f=part.stats["f"],
        iteration=np.int64(part.iterations), b_hi=np.float32(part.b_hi),
        b_lo=np.float32(part.b_lo),
        config_json=json.dumps(dataclasses.asdict(CFG)))
    st = load_checkpoint_state(p)
    assert st.format_version == 1 and st.f_err is None and st.rounds == 0
    res = cpu_solve(x, y, CFG, checkpoint_path=p, resume=True)
    assert res.converged and res.iterations == full.iterations
    np.testing.assert_allclose(res.alpha, full.alpha, atol=1e-4)
    np.savez_compressed(str(tmp_path / "v9.npz"), format_version=9,
                        alpha=np.zeros(3, np.float32),
                        f=np.zeros(3, np.float32), iteration=np.int64(0),
                        b_hi=np.float32(0), b_lo=np.float32(0),
                        config_json=json.dumps(dataclasses.asdict(CFG)))
    with pytest.raises(ValueError, match="unsupported checkpoint"):
        load_checkpoint_state(str(tmp_path / "v9.npz"))


@pytest.mark.parametrize("cfg", [
    CFG.replace(cache_lines=0),
    CFG.replace(cache_lines=0, selection="second_order"),
    CFG.replace(cache_lines=0, compensated=True),
    BLOCK,
    BLOCK.replace(compensated=True, selection="second_order"),
], ids=["xla", "xla-wss2", "xla-kahan", "block", "block-kahan-wss2"])
def test_interrupted_run_resumes_bitwise(blobs_small, tmp_path, cfg):
    """The plain round and the per-pair engines without the row cache
    resume bit for bit against the uninterrupted run (raw f and f_err
    ride the file)."""
    x, y = blobs_small
    p = str(tmp_path / "solver.npz")
    full = cpu_solve(x, y, cfg)
    part = cpu_solve(x, y, cfg, checkpoint_path=p,
                     callback=lambda it, bh, bl, st: it >= 128)
    assert not part.converged and part.iterations >= 128
    assert load_checkpoint_state(p).iteration == part.iterations
    res = cpu_solve(x, y, cfg, checkpoint_path=p, resume=True)
    assert res.converged
    _same(res, full)
    if cfg.engine == "block":
        assert res.stats["outer_rounds"] == full.stats["outer_rounds"]


def test_cached_per_pair_resume_meets_the_contract(blobs_small, tmp_path):
    """The row cache is not in the checkpoint, and a cached dot row's
    float32 value depends on the product that filled it (both pair rows
    in one (2, d) product, or one row alone), so a resumed cached solve
    is not bitwise the uninterrupted one (ROADMAP.md C, recorded
    difference 21): it meets the JAX test's tolerance."""
    x, y = blobs_small
    p = str(tmp_path / "c.npz")
    full = cpu_solve(x, y, CFG)
    cpu_solve(x, y, CFG, checkpoint_path=p, callback=lambda it, *_: it >= 128)
    start = load_checkpoint_state(p).iteration
    res = cpu_solve(x, y, CFG, checkpoint_path=p, resume=True)
    assert res.converged and abs(res.iterations - full.iterations) <= 2
    np.testing.assert_allclose(res.alpha, full.alpha, atol=1e-4)
    # Lookups count this run's pairs only.
    assert res.stats["cache_lookups"] == 2 * (res.iterations - start)


def test_unobserved_solve_is_one_chunk(blobs_small):
    x, y = blobs_small
    for cfg in (CFG.replace(checkpoint_every=0), BLOCK):
        res = cpu_solve(x, y, cfg)
        assert res.stats["chunks"] == 1
        assert set(res.stats["phase_seconds"]) == {"setup", "solve",
                                                   "observe", "finalize"}
        assert res.stats["phase_seconds"]["solve"] == res.train_seconds


def test_observed_block_chunks_are_rounds(blobs_small):
    """A block chunk is max(1, chunk_iters // inner) rounds: the
    callback sees every 4th round's pair count, and the observed run is
    bitwise the unobserved one (the plain round re-seeds nothing)."""
    x, y = blobs_small
    seen = []
    plain = cpu_solve(x, y, BLOCK)
    obs = cpu_solve(x, y, BLOCK, callback=lambda *a: seen.append(a[:3]))
    _same(obs, plain)
    rounds = plain.stats["outer_rounds"]
    assert obs.stats["chunks"] == len(seen) == -(-rounds // 4)
    assert seen[-1] == (obs.iterations, obs.b_hi, obs.b_lo)


@pytest.mark.parametrize("knob", ["fused_fold", "fused_round",
                                  "pipeline_rounds"])
def test_fused_engines_resume_within_the_contract(blobs_small, tmp_path,
                                                  knob):
    """The fused and pipelined runners re-seed at every chunk, as in the
    JAX package: a resumed run is held to the whole-solve contract."""
    x, y = blobs_small
    cfg = BLOCK.replace(**{knob: True})
    p = str(tmp_path / "f.npz")
    full = cpu_solve(x, y, cfg)
    part = cpu_solve(x, y, cfg, checkpoint_path=p,
                     callback=lambda it, *_: it >= 96)
    res = cpu_solve(x, y, cfg, checkpoint_path=p, resume=True)
    assert full.converged and res.converged and not part.converged
    assert res.stats[knob if knob != "pipeline_rounds" else "pipelined"]
    np.testing.assert_allclose(res.alpha, full.alpha, atol=2e-2)
    assert abs(res.n_sv - full.n_sv) <= 0.1 * full.n_sv


def test_pallas_engine_resumes(blobs_small, tmp_path):
    x, y = blobs_small
    cfg = CFG.replace(engine="pallas")
    p = str(tmp_path / "p.npz")
    full = cpu_solve(x, y, cfg)
    cpu_solve(x, y, cfg, checkpoint_path=p, callback=lambda it, *_: it >= 64)
    res = cpu_solve(x, y, cfg, checkpoint_path=p, resume=True)
    assert res.converged
    np.testing.assert_allclose(res.alpha, full.alpha, atol=1e-4)


def test_mesh_resumes_from_one_device_checkpoint(blobs_small, tmp_path):
    x, y = blobs_small
    p = str(tmp_path / "solver.npz")
    part = cpu_solve(x, y, BLOCK.replace(max_iter=128))
    save_checkpoint(p, part.alpha, part.stats["f"], part.iterations,
                    part.b_hi, part.b_lo, BLOCK)
    full = cpu_solve(x, y, BLOCK)
    for ring in (False, True):
        res = solve_mesh(x, y, BLOCK.replace(ring_exchange=ring),
                         mesh=Mesh(["cpu"] * 4), checkpoint_path=p,
                         resume=True)
        assert res.converged and res.iterations > 128
        np.testing.assert_allclose(res.alpha, full.alpha, atol=2e-2)
        assert res.b == pytest.approx(full.b, abs=5e-3)


def test_mesh_checkpoint_resumes_on_one_device(blobs_small, tmp_path):
    x, y = blobs_small
    p = str(tmp_path / "mesh.npz")
    part = solve_mesh(x, y, BLOCK, mesh=Mesh(["cpu"] * 2),
                      checkpoint_path=p, callback=lambda it, *_: it >= 96)
    assert not part.converged
    st = load_checkpoint_state(p)
    assert st.iteration == part.iterations and st.rounds > 0
    res = cpu_solve(x, y, BLOCK, checkpoint_path=p, resume=True)
    full = cpu_solve(x, y, BLOCK)
    assert res.converged
    np.testing.assert_allclose(res.alpha, full.alpha, atol=2e-2)


def _abort_after(chunks: int):
    """A callback that stops the solve at its `chunks`-th boundary."""
    seen = []

    def cb(*_):
        seen.append(1)
        return len(seen) >= chunks

    return cb


def test_shardlocal_checkpoint_is_refused(blobs_small, tmp_path):
    """Checkpoints of the shard-local runner, which the port once
    refused: stopped after its second chunk with a file written every
    chunk and resumed in a fresh call, it converges to the uninterrupted
    run's optimum (the endgame demotion included)."""
    x, y = blobs_small
    cfg = BLOCK.replace(local_working_sets=2, sync_rounds=2, chunk_iters=64,
                        checkpoint_every=1)
    p = str(tmp_path / "s.npz")
    part = solve_mesh(x, y, cfg, mesh=Mesh(["cpu"] * 2), checkpoint_path=p,
                      callback=_abort_after(2))
    assert not part.converged
    st = load_checkpoint_state(p)
    assert st.iteration == part.iterations and st.rounds % 2 == 0
    res = solve_mesh(x, y, cfg, mesh=Mesh(["cpu"] * 2), checkpoint_path=p,
                     resume=True)
    full = solve_mesh(x, y, cfg.replace(checkpoint_every=0),
                      mesh=Mesh(["cpu"] * 2))
    assert res.converged and res.stats["shardlocal_demoted"]
    assert abs(res.n_sv - full.n_sv) <= max(2, 0.02 * full.n_sv)
    assert abs(res.b - full.b) <= 5e-3
    seen = []
    res = solve_mesh(x, y, cfg, mesh=Mesh(["cpu"] * 2),
                     callback=lambda *a: seen.append(a[0]))
    assert res.converged and seen[-1] == res.iterations


def test_resume_refuses_mismatched_config(blobs_small, tmp_path):
    x, y = blobs_small
    p = str(tmp_path / "ck.npz")
    part = cpu_solve(x, y, CFG.replace(max_iter=64))
    save_checkpoint(p, part.alpha, part.stats["f"], part.iterations,
                    part.b_hi, part.b_lo, CFG)
    with pytest.raises(ValueError, match="gamma"):
        cpu_solve(x, y, CFG.replace(gamma=0.5), checkpoint_path=p,
                  resume=True)
    with pytest.raises(ValueError, match="n="):
        cpu_solve(x[:100], y[:100], CFG, checkpoint_path=p, resume=True)


def test_periodic_checkpoint_written_during_solve(blobs_small, tmp_path):
    x, y = blobs_small
    p = str(tmp_path / "auto.npz")
    cpu_solve(x, y, CFG.replace(max_iter=200), checkpoint_path=p)
    a, f, it, *_ = load_checkpoint(p)
    assert 0 < it <= 200 and a.shape == (x.shape[0],)


def test_callback_abort_forces_checkpoint(blobs_small, tmp_path):
    x, y = blobs_small
    path = str(tmp_path / "abort.npz")
    cfg = SVMConfig(c=1.0, gamma=0.1, max_iter=100_000, chunk_iters=64,
                    checkpoint_every=1_000_000)  # cadence never due
    res = cpu_solve(x, y, cfg, callback=lambda it, bh, bl, st: it >= 128,
                    checkpoint_path=path)
    assert not res.converged and res.iterations < 100_000
    alpha, f, it, b_hi, b_lo, _ = load_checkpoint(path)
    assert it == res.iterations
    np.testing.assert_array_equal(alpha, res.alpha)


def test_on_start_gets_the_resumed_pair_count(blobs_small, tmp_path):
    x, y = blobs_small
    p = str(tmp_path / "s.npz")
    cpu_solve(x, y, CFG, checkpoint_path=p, callback=lambda it, *_: it >= 64)
    starts = []

    class Cb:
        def __call__(self, *a):
            return None

        def on_start(self, it):
            starts.append(it)

    start = load_checkpoint_state(p).iteration
    cpu_solve(x, y, CFG, callback=Cb(), checkpoint_path=p, resume=True)
    assert starts == [start] != [0]


def test_verbose_and_check_numerics(blobs_small, capsys):
    x, y = blobs_small
    res = cpu_solve(x, y, BLOCK.replace(verbose=True, check_numerics=True,
                                        checkpoint_every=0))
    out = capsys.readouterr().out
    assert out.count("[single-device] iter=") == res.stats["chunks"] > 1
    bad = torch_nan_state()
    with pytest.raises(FloatingPointError, match="non-finite solver state"):
        chunks.assert_finite_state(bad, 7, "single-device")
    with pytest.raises(FloatingPointError, match="non-finite optimality"):
        chunks.check_obs_finite(float("nan"), 0.0, 3, True, "x")
    chunks.check_obs_finite(-np.inf, np.inf, 0, False, "x")  # start state


def torch_nan_state():
    import torch

    return (torch.tensor([0.0, float("nan")]),), (torch.zeros(2),)


# ----------------------------------------------------- durability, retention

def test_fsync_before_rename_ordering(tmp_path, monkeypatch):
    calls = []
    real_fsync, real_replace = os.fsync, os.replace
    monkeypatch.setattr(os, "fsync", lambda fd: (
        calls.append(("fsync", "dir" if stat.S_ISDIR(os.fstat(fd).st_mode)
                      else "file")), real_fsync(fd))[1])
    monkeypatch.setattr(os, "replace", lambda a, b: (
        calls.append(("replace", None)), real_replace(a, b))[1])
    save_checkpoint(str(tmp_path / "ck.npz"), np.zeros(3, np.float32),
                    np.zeros(3, np.float32), 1, 0.0, 0.0, CFG)
    assert calls.index(("fsync", "file")) < calls.index(("replace", None)) \
        < calls.index(("fsync", "dir")), calls


def test_retention_rotates_and_survives_mid_save_fault(tmp_path,
                                                       monkeypatch):
    n = 4
    cfg = CFG.replace(checkpoint_every=1, checkpoint_keep=3)
    p = str(tmp_path / "ck.npz")
    ck = PeriodicCheckpointer(p, cfg)
    for it in (10, 20, 30, 40):
        assert ck.save(it, np.full(n, it, np.float32),
                       np.zeros(n, np.float32), 1.0, -1.0)
    gens = checkpoint_generations(p)
    assert [os.path.basename(g) for g in gens] == \
        ["ck.npz", "ck.npz.1", "ck.npz.2"]
    assert [load_checkpoint_state(g).iteration for g in gens] == [40, 30, 20]
    # A save that dies between the tmp write and its rename, after the
    # rotation moved the newest aside.
    real_replace = os.replace

    def dying_replace(a, b):
        if a.endswith(".npz.tmp"):
            raise OSError("killed mid-save")
        return real_replace(a, b)

    monkeypatch.setattr(os, "replace", dying_replace)
    with pytest.raises(OSError, match="killed mid-save"):
        ck.save(50, np.full(n, 50, np.float32), np.zeros(n, np.float32),
                1.0, -1.0)
    monkeypatch.setattr(os, "replace", real_replace)
    assert not os.path.exists(p)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    with pytest.warns(UserWarning, match="OLDER CHECKPOINT GENERATION"):
        st = resume_state(p, cfg, n)
    assert st.iteration == 40
    ck2 = PeriodicCheckpointer(p, cfg.replace(checkpoint_keep=2))
    ck2.save(60, np.full(n, 60, np.float32), np.zeros(n, np.float32),
             1.0, -1.0)
    assert [os.path.basename(g) for g in checkpoint_generations(p)] == \
        ["ck.npz", "ck.npz.1"]


def test_resume_falls_back_past_corrupt_generations(tmp_path):
    n = 4
    cfg = CFG.replace(checkpoint_every=1, checkpoint_keep=3)
    p = str(tmp_path / "ck.npz")
    ck = PeriodicCheckpointer(p, cfg)
    for it in (10, 20, 30):
        ck.save(it, np.full(n, it, np.float32), np.zeros(n, np.float32),
                1.0, -1.0)
    for path in (p, p + ".1"):
        with open(path, "wb") as fh:
            fh.write(b"not an npz")
    with pytest.warns(UserWarning,
                      match="UNUSABLE|UNREADABLE|OLDER CHECKPOINT"):
        st = resume_state(p, cfg, n)
    assert st.iteration == 10
    with pytest.warns(UserWarning):
        with pytest.raises(ValueError, match="refusing to resume"):
            resume_state(p, cfg.replace(c=999.0), n)
    with open(p + ".2", "wb") as fh:
        fh.write(b"junk")
    with pytest.warns(UserWarning):
        with pytest.raises(ValueError, match="unloadable"):
            resume_state(p, cfg, n)


def test_non_finite_state_is_never_saved(tmp_path):
    p = str(tmp_path / "nf.npz")
    ck = PeriodicCheckpointer(p, CFG.replace(checkpoint_every=1))
    with pytest.warns(UserWarning, match="SKIPPED"):
        assert not ck.save(5, np.array([np.nan], np.float32),
                           np.zeros(1, np.float32), 0.0, 0.0)
    assert not os.path.exists(p)


# ------------------------------------------------------ across the packages

def test_jax_checkpoint_resumes_in_the_port(blobs_small, tmp_path):
    x, y = blobs_small
    p = str(tmp_path / "jax.npz")
    jpart = jsolve(x, y, JaxConfig(**KW), checkpoint_path=p,
                   callback=lambda it, *_: it >= 128)
    assert not jpart.converged
    jfull = jsolve(x, y, JaxConfig(**KW))
    res = cpu_solve(x, y, CFG, checkpoint_path=p, resume=True)
    assert res.converged and res.iterations > jpart.iterations
    np.testing.assert_allclose(res.alpha, jfull.alpha, atol=1e-4)
    assert res.b == pytest.approx(jfull.b, abs=1e-4)


def test_port_checkpoint_resumes_in_jax(blobs_small, tmp_path):
    x, y = blobs_small
    p = str(tmp_path / "port.npz")
    part = cpu_solve(x, y, CFG, checkpoint_path=p,
                     callback=lambda it, *_: it >= 128)
    assert not part.converged
    jres = jsolve(x, y, JaxConfig(**KW), checkpoint_path=p, resume=True)
    jfull = jsolve(x, y, JaxConfig(**KW))
    assert jres.converged and jres.iterations > part.iterations
    np.testing.assert_allclose(jres.alpha, jfull.alpha, atol=1e-4)


def test_port_block_checkpoint_resumes_in_jax(blobs_small, tmp_path):
    x, y = blobs_small
    p = str(tmp_path / "blk.npz")
    cpu_solve(x, y, BLOCK, checkpoint_path=p, callback=lambda it, *_: it >= 96)
    jcfg = JaxConfig(**{**KW, "engine": "block", "working_set_size": 16,
                        "cache_lines": 0, "chunk_iters": 128})
    jres = jsolve(x, y, jcfg, checkpoint_path=p, resume=True)
    full = cpu_solve(x, y, BLOCK)
    assert jres.converged
    np.testing.assert_allclose(jres.alpha, full.alpha, atol=2e-2)


@pytest.mark.parametrize("kw", [dict(fleet_size=4), dict(fleet_size=64)])
def test_fleet_size_off_default_loads_and_resumes(blobs_small, tmp_path,
                                                  kw):
    """fleet_size is ported: a JAX checkpoint carrying it off its default
    loads, and a per-pair solve resumes from it to convergence."""
    x, y = blobs_small
    cfg = CFG.replace(cache_lines=0, **kw)
    p = str(tmp_path / "f.npz")
    part = jsolve(x, y, JaxConfig(**{**KW, "cache_lines": 0, **kw}),
                  checkpoint_path=p, callback=lambda it, *_: it >= 64)
    assert not part.converged
    assert load_checkpoint_state(p).config.fleet_size == kw["fleet_size"]
    res = cpu_solve(x, y, cfg, checkpoint_path=p, resume=True)
    assert res.converged


def test_jax_only_keys_at_defaults_load(tmp_path):
    p = str(tmp_path / "d.npz")
    jck.save_checkpoint(p, np.zeros(3, np.float32), np.zeros(3, np.float32),
                        1, 0.0, 0.0, JaxConfig(retry_faults=0, verbose=True))
    st = load_checkpoint_state(p)
    assert st.config.retry_faults == 0 and st.config.verbose


@pytest.mark.parametrize("kw,item", [
    # The active-set engines are ported: the file loads (item None).
    (dict(reconcile_rounds=3), None),
    # ooc is ported (item 8): the file loads (item None).
    (dict(ooc=True, engine="block", ooc_tile_rows=64), None),
    # obs is ported (item 11): the file loads (item None).
    (dict(obs={"enabled": True, "trace_dir": None, "runlog_dir": "r"}),
     None),
])
def test_jax_only_keys_off_default_refuse(tmp_path, kw, item):
    p = str(tmp_path / "j.npz")
    jck.save_checkpoint(p, np.zeros(3, np.float32), np.zeros(3, np.float32),
                        1, 0.0, 0.0, JaxConfig(**kw))
    if item is None:
        st = load_checkpoint_state(p)
        for key, value in kw.items():
            got = getattr(st.config, key)
            if key == "obs":
                got = dataclasses.asdict(got)
            assert got == value
        return
    with pytest.raises(NotImplementedError, match=item):
        load_checkpoint_state(p)


@pytest.mark.parametrize("kw,item", [
    # The active-set engines are ported: a solve resumes the file (item
    # None).
    (dict(reconcile_rounds=3), None),
    # ooc is ported (item 8): an ooc solve resumes the file (item None).
    (dict(ooc=True, engine="block", ooc_tile_rows=64), None),
])
def test_jax_only_keys_off_default_refuse_resume(tmp_path, kw, item):
    """Resuming such a file refuses at once, naming the item; it is not
    read as a corrupt generation (no fallback, no "unloadable" error)."""
    import warnings

    p = str(tmp_path / "j.npz")
    jck.save_checkpoint(p, np.zeros(3, np.float32), np.zeros(3, np.float32),
                        1, 0.0, 0.0, JaxConfig(**kw))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        if item is None:
            res = cpu_solve(np.zeros((3, 2), np.float32),
                            np.array([1, -1, 1]), SVMConfig(**kw),
                            checkpoint_path=p, resume=True)
            assert res.stats.get("ooc", False) == kw.get("ooc", False)
            assert res.iterations >= 1 and res.converged
            return
        with pytest.raises(NotImplementedError, match=item):
            cpu_solve(np.zeros((3, 2), np.float32), np.array([1, -1, 1]),
                      CFG, checkpoint_path=p, resume=True)


# ------------------------------------------------------------ the trainers

def test_trainers_checkpoint_and_resume(tmp_path):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(120, 4)).astype(np.float32)
    z = (np.sin(x[:, 0]) + 0.1 * rng.normal(size=120)).astype(np.float32)
    cfg = SVMConfig(c=10.0, gamma=0.5, epsilon=1e-3, chunk_iters=64,
                    checkpoint_every=64, cache_lines=0)
    p = str(tmp_path / "svr.npz")
    m0, r0 = train_svr(x, z, cfg, device="cpu")
    _, part = train_svr(x, z, cfg, device="cpu", checkpoint_path=p,
                        callback=lambda it, *_: it >= 64)
    assert not part.converged
    assert load_checkpoint_state(p).alpha.shape == (240,)  # the 2n dual
    m1, r1 = train_svr(x, z, cfg, device="cpu", checkpoint_path=p,
                       resume=True)
    np.testing.assert_array_equal(r1.alpha, r0.alpha)
    q = str(tmp_path / "oc.npz")
    _, r2 = train_oneclass(x, nu=0.2, config=cfg, device="cpu",
                           checkpoint_path=q,
                           callback=lambda it, *_: it >= 32)
    _, r3 = train_oneclass(x, nu=0.2, config=cfg, device="cpu",
                           checkpoint_path=q, resume=True)
    _, r4 = train_oneclass(x, nu=0.2, config=cfg, device="cpu")
    assert r3.converged and not r2.converged
    np.testing.assert_array_equal(r3.alpha, r4.alpha)


def _trainer_pair(kind):
    """(port trainer, JAX trainer, targets) of a model family: each
    trainer is f(x, target, cfg, **state_kw) -> (model, result)."""
    from dpsvm_tpu.models import nusvm as jnusvm
    from dpsvm_tpu.models import oneclass as joneclass
    from dpsvm_tpu.models import svr as jsvr
    from dpsvm_tpu_torch.models import train_nusvc

    if kind == "svr":
        return (lambda x, t, c, **kw: train_svr(x, t, c, svr_epsilon=0.1,
                                                device="cpu", **kw),
                lambda x, t, c, **kw: jsvr.train_svr(
                    x, t, c, svr_epsilon=0.1, backend="single", **kw))
    if kind == "nusvc":
        return (lambda x, t, c, **kw: train_nusvc(x, t, nu=0.3, config=c,
                                                  device="cpu", **kw),
                lambda x, t, c, **kw: jnusvm.train_nusvc(
                    x, t, nu=0.3, config=c, backend="single", **kw))
    return (lambda x, t, c, **kw: train_oneclass(x, nu=0.2, config=c,
                                                 device="cpu", **kw),
            lambda x, t, c, **kw: joneclass.train_oneclass(
                x, nu=0.2, config=c, backend="single", **kw))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("kind", ["svr", "nusvc", "oneclass"])
def test_trainers_resume_across_packages(tmp_path, kind, direction):
    """A train_svr / train_nusvc / train_oneclass checkpoint written by
    one package and resumed by the other converges within the whole-solve
    contract of a fresh run: n_sv within 2%, b (or rho) and every
    decision within 5e-3."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(120, 4)).astype(np.float32)
    target = {"svr": (np.sin(x[:, 0]) + 0.1 * rng.normal(size=120)),
              "nusvc": np.where(x[:, 0] + 0.3 * x[:, 1] > 0, 1, -1),
              "oneclass": None}[kind]
    if target is not None:
        target = target.astype(np.float32 if kind == "svr" else np.int32)
    kw = dict(c=10.0 if kind == "svr" else 1.0, gamma=0.5, epsilon=1e-3,
              chunk_iters=32, checkpoint_every=32, cache_lines=0)
    port, jax = _trainer_pair(kind)
    write, read = (jax, port) if direction == "jax_to_port" else (port, jax)
    wcfg, rcfg = ((JaxConfig(**kw), SVMConfig(**kw))
                  if direction == "jax_to_port"
                  else (SVMConfig(**kw), JaxConfig(**kw)))
    args = (x,) if kind == "oneclass" else (x, target)

    def call(fn, cfg, **state):
        if kind == "oneclass":
            return fn(x, None, cfg, **state)
        return fn(*args, cfg, **state)

    p = str(tmp_path / f"{kind}.npz")
    _, part = call(write, wcfg, checkpoint_path=p,
                   callback=lambda it, *_: it >= 32)
    assert not part.converged
    m1, r1 = call(read, rcfg, checkpoint_path=p, resume=True)
    m0, r0 = call(port, SVMConfig(**kw))
    assert r1.converged and r0.converged
    assert abs(r1.n_sv - r0.n_sv) <= max(1, 0.02 * r0.n_sv)
    off = "rho" if kind == "oneclass" else "b"
    assert abs(getattr(m1, off) - getattr(m0, off)) <= 5e-3
    q = x[:40]
    read_pkg = "port" if direction == "jax_to_port" else "jax"
    np.testing.assert_allclose(_decisions(m1, q, kind, read_pkg),
                               _decisions(m0, q, kind, "port"), rtol=0,
                               atol=5e-3)


def _decisions(model, q, kind, pkg):
    """A trained model's decision values (SVR: predictions) at q, on the
    CPU, through its own package."""
    dev = {"device": "cpu"} if pkg == "port" else {}
    if kind == "svr":
        out = model.predict(q, **dev)
    elif kind == "oneclass":
        out = model.decision_function(q, **dev)
    elif pkg == "port":
        out = tdecision(model, q, device="cpu")
    else:
        out = jax_decision(model, q)
    return np.asarray(out, np.float64)


def jax_decision(model, q):
    from dpsvm_tpu.predict import decision_function

    return decision_function(model, q)


def tdecision(model, q, device):
    from dpsvm_tpu_torch.predict import decision_function

    return decision_function(model, q, device=device)
