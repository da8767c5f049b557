"""The observability spine in the port (dpsvm_tpu_torch/obs) against the
JAX package's dpsvm_tpu/obs, on the CPU.

Contracts held here:
* off, it is free: the null span and NULL_OBS are shared objects;
* an observed solve (block, per-pair, mesh, out of core and the mesh
  stream) is bitwise the unobserved one, with the same chunk count, and
  its run log reconciles with the SolveResult (chunk deltas sum to the
  pairs, the final record carries the result);
* the run log is the JAX package's schema: a file written by either
  package reads in the other's reader, and both packages' summarize_run
  give the same summary of it;
* the reader skips future-schema, garbage and corrupted records;
  interleaved runs separate; spans attribute to the innermost session;
  an aborted run closes its log and leaves the trace stack; in-memory
  span records are capped;
* a trace directory gives a torch.profiler trace holding the spans;
  kernel builds and graph captures are compile records.
"""

import json
import os

import numpy as np
import pytest

from dpsvm_tpu.obs import analyze as janalyze
from dpsvm_tpu.obs.runlog import RunLog as JaxRunLog
from dpsvm_tpu.obs.runlog import read_runlog as jax_read_runlog
from dpsvm_tpu_torch import Mesh, SVMConfig, solve, solve_mesh
from dpsvm_tpu_torch.config import ObsConfig
from dpsvm_tpu_torch.data.synth import make_blobs_binary
from dpsvm_tpu_torch.obs import (NULL_OBS, RunObs, analyze, compilelog,
                                 run_obs, trace)
from dpsvm_tpu_torch.obs import metrics as obs_metrics
from dpsvm_tpu_torch.obs.runlog import (SCHEMA_VERSION, RunLog, git_sha,
                                        read_runlog, records_for)


@pytest.fixture(autouse=True)
def _isolated_obs(monkeypatch):
    """Every test controls obs itself: no ambient opt-in."""
    for var in ("DPSVM_OBS", "DPSVM_OBS_DIR", "DPSVM_TRACE_DIR"):
        monkeypatch.delenv(var, raising=False)
    yield


@pytest.fixture(scope="module")
def blobs():
    return make_blobs_binary(n=300, d=8, seed=3, sep=1.2)


def _on(cfg, tmp_path, **kw):
    return cfg.replace(obs=ObsConfig(enabled=True,
                                     runlog_dir=str(tmp_path / "runs"),
                                     **kw))


# ------------------------------------------------------------- off: free

def test_disabled_span_and_run_obs_are_shared_nulls(tmp_path):
    assert trace.span("a") is trace.span("b")
    assert run_obs("solve", SVMConfig()) is NULL_OBS
    assert run_obs("solve", None) is NULL_OBS
    assert NULL_OBS.span("solver/chunk") is trace.span("x")
    reg = obs_metrics.Registry()
    reg.gauge("g").set(2.5)
    reg.counter("c").add(3)
    assert reg.snapshot() == {"c": 3, "g": 2.5}
    assert not os.path.exists(tmp_path / "runs")


def test_env_opt_in_enables_run_obs(tmp_path, monkeypatch):
    monkeypatch.setenv("DPSVM_OBS", "1")
    monkeypatch.setenv("DPSVM_OBS_DIR", str(tmp_path))
    o = run_obs("solve", SVMConfig(), device="cpu")
    assert o.live and o.path.startswith(str(tmp_path))
    o.finish()


# -------------------------------------------- observed == unobserved

SOLVES = {
    "block": dict(engine="block", working_set_size=32, chunk_iters=128),
    "block_fused": dict(engine="block", working_set_size=32,
                        fused_fold=True),
    "per_pair": dict(engine="xla", chunk_iters=256, cache_lines=64),
    "ooc": dict(engine="block", working_set_size=32, ooc=True,
                ooc_tile_rows=128),
}


@pytest.mark.parametrize("name", sorted(SOLVES))
@pytest.mark.parametrize("observed", [False, True])
def test_observed_solve_is_bitwise_the_unobserved(blobs, tmp_path, name,
                                                   observed):
    """obs on changes nothing: same pairs, chunks and alpha bits. With
    `observed` a callback chunks the solve, so the run log has several
    chunk records; their deltas sum to the pairs run."""
    x, y = blobs
    cfg = SVMConfig(c=4.0, gamma=0.1, **SOLVES[name])
    cb = (lambda *a: None) if observed else None
    off = solve(x, y, cfg, device="cpu", callback=cb)
    on = solve(x, y, _on(cfg, tmp_path), device="cpu", callback=cb)
    np.testing.assert_array_equal(off.alpha, on.alpha)
    assert (off.iterations, off.b) == (on.iterations, on.b)
    assert off.stats.get("chunks") == on.stats.get("chunks")
    assert "obs_run_id" not in off.stats
    recs = read_runlog(on.stats["obs_runlog"])
    mine = records_for(recs, on.stats["obs_run_id"])
    chunks = [r for r in mine if r["kind"] == "chunk"]
    final = mine[-1]
    assert mine[0]["kind"] == "manifest" and final["kind"] == "final"
    assert sum(c["pairs_delta"] for c in chunks) == on.iterations
    assert final["iterations"] == on.iterations
    assert final["converged"] == on.converged
    assert final["n_sv"] == on.n_sv
    if name != "ooc":
        assert final["dispatches"] == len(chunks) == on.stats["chunks"]
    else:
        # The ooc solver's last dispatch is the selection that finds the
        # gap closed: it runs no round, so it has no chunk record.
        assert final["dispatches"] == len(chunks) + 1
        assert len(chunks) == on.stats["outer_rounds"]
    assert (len(chunks) > 1) == (observed or name == "ooc")


@pytest.mark.parametrize("engine", ["block", "xla"])
def test_observed_mesh_solve_is_bitwise(blobs, tmp_path, engine):
    x, y = blobs
    cfg = SVMConfig(c=4.0, gamma=0.1, engine=engine, working_set_size=32,
                    chunk_iters=128)
    cb = lambda *a: None  # noqa: E731
    off = solve_mesh(x, y, cfg, mesh=Mesh(["cpu"] * 2), callback=cb)
    on = solve_mesh(x, y, _on(cfg, tmp_path), mesh=Mesh(["cpu"] * 2),
                    callback=cb)
    np.testing.assert_array_equal(off.alpha, on.alpha)
    assert off.stats["chunks"] == on.stats["chunks"]
    recs = read_runlog(on.stats["obs_runlog"])
    man = recs[0]
    assert man["tool"] == "solve_mesh" and man["n_devices"] == 2
    chunks = [r for r in recs if r["kind"] == "chunk"]
    assert sum(c["pairs_delta"] for c in chunks) == on.iterations


def test_observed_ooc_mesh_stream_is_bitwise(blobs, tmp_path):
    x, y = blobs
    cfg = SVMConfig(c=4.0, gamma=0.1, engine="block", working_set_size=32,
                    ooc=True, ooc_tile_rows=64)
    off = solve_mesh(x, y, cfg, mesh=Mesh(["cpu"] * 2))
    on = solve_mesh(x, y, _on(cfg, tmp_path), mesh=Mesh(["cpu"] * 2))
    np.testing.assert_array_equal(off.alpha, on.alpha)
    recs = read_runlog(on.stats["obs_runlog"])
    assert recs[0]["ooc_mesh"] is True and recs[0]["devices"] == 2
    spans = {r["name"] for r in recs if r["kind"] == "span"}
    assert {"solver/ooc_setup_stream", "solver/ooc_round"} <= spans
    chunks = [r for r in recs if r["kind"] == "chunk"]
    assert len(chunks) == on.stats["outer_rounds"]
    assert sum(c["tiles"] for c in chunks) == on.stats["tiles_streamed"]


def test_ooc_resume_and_shrink_events(blobs, tmp_path):
    x, y = blobs
    cfg = _on(SVMConfig(c=4.0, gamma=0.1, engine="block",
                        working_set_size=32, ooc=True, ooc_tile_rows=64,
                        active_set_size=64, checkpoint_every=1),
              tmp_path)
    p = str(tmp_path / "ck.npz")
    solve(x, y, cfg, device="cpu", checkpoint_path=p,
          callback=lambda it, *_: it >= 200)
    res = solve(x, y, cfg, device="cpu", checkpoint_path=p, resume=True)
    recs = records_for(read_runlog(res.stats["obs_runlog"]),
                       res.stats["obs_run_id"])
    names = [r["name"] for r in recs if r["kind"] == "event"]
    assert names[0] == "resume"
    assert "shrink_reconstruct" in names or "shrink_demote" in names


# ------------------------------------------------------- the run log

def test_runlog_schema_round_trip_in_both_readers(tmp_path):
    cfg = SVMConfig(c=3.0, engine="block")
    path = str(tmp_path / "solve-test.jsonl")
    log = RunLog(path, "solve", config=cfg, meta={"n": 100, "d": 4})
    log.record("chunk", pairs=10, pairs_delta=10, b_hi=-1.0, b_lo=1.0,
               gap=2.0, device_seconds=0.5, dispatch=1,
               rows=np.int64(3))
    log.record("event", name="demotion", gap=0.1)
    log.span_sink({"kind": "span", "name": "solver/chunk", "t": 1.0,
                   "dur": 0.5})
    log.finish(iterations=10, converged=True)
    log.finish()  # idempotent
    for recs in (read_runlog(path), jax_read_runlog(path)):
        assert [r["kind"] for r in recs] == ["manifest", "chunk", "event",
                                             "span", "final"]
        assert all(r["schema"] == SCHEMA_VERSION == 1 for r in recs)
        man = recs[0]
        assert man["config"]["c"] == 3.0
        assert man["config"]["obs"] == {"enabled": False, "trace_dir": None,
                                        "runlog_dir": None}
        assert {"git_sha", "torch", "backend", "device_kind",
                "n_devices"} <= man.keys()
        assert recs[1]["rows"] == 3


def test_reader_skips_future_schema_garbage_and_corrupt_records(tmp_path):
    p = tmp_path / "x.jsonl"
    a = {"schema": SCHEMA_VERSION, "run": "1-1", "kind": "chunk",
         "pairs": 1}
    b = {"schema": SCHEMA_VERSION, "run": "1-1", "kind": "chunk",
         "pairs": 2}
    future = {"schema": SCHEMA_VERSION + 1, "run": "1-1", "kind": "chunk"}
    corrupt = json.dumps(b)[:17] + "\x00\x00garbage"
    p.write_text("\n".join([json.dumps(a), json.dumps(future), "not json",
                            corrupt, json.dumps({"no": "keys"}),
                            json.dumps(b)]) + "\n"
                 + '{"schema": 1, "run": "t", "ki')  # truncated tail
    assert read_runlog(str(p)) == [a, b] == jax_read_runlog(str(p))


def test_interleaved_runs_separate(tmp_path):
    path = str(tmp_path / "solve-interleaved.jsonl")
    l1 = RunLog(path, "solve")
    l2 = RunLog(path, "solve")
    for i in range(3):
        l1.record("chunk", pairs=10 * (i + 1), pairs_delta=10,
                  gap=1.0 / (i + 1), device_seconds=0.1, dispatch=i + 1)
        l2.record("chunk", pairs=5 * (i + 1), pairs_delta=5,
                  gap=2.0 / (i + 1), device_seconds=0.2, dispatch=i + 1)
    l2.finish(iterations=15, converged=False)
    l1.finish(iterations=30, converged=True)
    recs = read_runlog(path)
    assert [c["pairs"] for c in records_for(recs, l1.run_id, "chunk")] \
        == [10, 20, 30]
    runs = analyze.load_runs([path])
    assert [r.run_id for r in runs] == [l1.run_id, l2.run_id]
    assert [len(r.chunks) for r in runs] == [3, 3]


def test_git_sha_follows_gitdir_pointer(tmp_path):
    sha = "deadbeef" * 5
    gd = tmp_path / "parent" / ".git" / "worktrees" / "wt"
    gd.mkdir(parents=True)
    (gd / "HEAD").write_text("ref: refs/heads/topic\n")
    (gd / "commondir").write_text("../..\n")
    common = tmp_path / "parent" / ".git"
    (common / "refs" / "heads").mkdir(parents=True)
    (common / "refs" / "heads" / "topic").write_text(sha + "\n")
    wt = tmp_path / "wt"
    wt.mkdir()
    (wt / ".git").write_text(f"gitdir: {gd}\n")
    assert git_sha(str(wt)) == sha
    (wt / ".git").write_text("gitdir: ../parent/.git/worktrees/wt\n")
    assert git_sha(str(wt)) == sha


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_summaries_agree_across_packages(blobs, tmp_path, writer):
    """A run log written by either package is summarized to the same
    dict by both packages' summarize_run."""
    x, y = blobs
    if writer == "port":
        res = solve(x, y, _on(SVMConfig(c=4.0, gamma=0.1, engine="block",
                                        working_set_size=32,
                                        chunk_iters=128), tmp_path),
                    device="cpu", callback=lambda *a: None)
        path = res.stats["obs_runlog"]
    else:
        path = str(tmp_path / "solve-jax.jsonl")
        log = JaxRunLog(path, "solve", meta={"n": 300, "d": 8,
                                             "engine": "block"})
        for i, pairs in enumerate((100, 180, 220)):
            log.record("chunk", pairs=pairs, pairs_delta=pairs - (
                0, 100, 180)[i], b_hi=-1.0 / (i + 1), b_lo=1.0 / (i + 1),
                gap=2.0 / (i + 1), device_seconds=0.01, dispatch=i + 1)
        log.record("event", name="retry", attempt=1)
        log.finish(iterations=220, converged=True,
                   phase_seconds={"setup": 0.1, "solve": 0.03})
    mine = [analyze.summarize_run(r) for r in analyze.load_runs([path])]
    theirs = [janalyze.summarize_run(r)
              for r in janalyze.load_runs([path])]
    assert mine == theirs and len(mine) == 1
    assert mine[0]["pairs"] > 0
    assert analyze.render_report(mine) == janalyze.render_report(theirs)


# ----------------------------------------------------------- sessions

def test_trace_session_host_timeline_and_innermost_attribution():
    with trace.TraceSession() as outer:
        with trace.TraceSession() as inner:
            with trace.span("inner/work"):
                with trace.span("inner/nested"):
                    pass
        with trace.span("outer/work"):
            pass
    assert [e["name"] for e in inner.events] == ["inner/nested",
                                                 "inner/work"]
    assert [e["name"] for e in outer.events] == ["outer/work"]
    assert trace.active_session() is None
    assert trace.span("x") is trace.span("y")


def test_trace_sessions_interleaved_close():
    s1 = trace.TraceSession().__enter__()
    s2 = trace.TraceSession().__enter__()
    with trace.span("two"):
        pass
    s1.__exit__(None, None, None)
    with trace.span("still-two"):
        pass
    s2.__exit__(None, None, None)
    assert [e["name"] for e in s2.events] == ["two", "still-two"]
    assert s1.events == [] and trace.active_session() is None


def test_trace_session_events_capped(monkeypatch):
    monkeypatch.setattr(trace, "_MAX_EVENTS", 8)
    with trace.TraceSession() as sess:
        for i in range(20):
            with trace.span(f"s{i}"):
                pass
    assert len(sess.events) == 8 and sess.dropped == 12


def test_abort_path_closes_the_log_and_the_session(tmp_path):
    o = RunObs("solve", meta={"n": 1}, directory=str(tmp_path))
    path = o.path
    assert trace.active_session() is not None
    o.chunk(pairs=5, b_hi=0.0, b_lo=1.0, device_seconds=0.1, dispatch=1)
    del o
    assert trace.active_session() is None
    recs = read_runlog(path)
    assert recs[-1]["kind"] == "final" and recs[-1]["aborted"] is True
    o2 = RunObs("solve", directory=str(tmp_path))
    o2.finish(iterations=1)
    o2.finish(iterations=2)
    finals = [r for r in read_runlog(path) if r["kind"] == "final"]
    assert finals[-1]["iterations"] == 1 and "aborted" not in finals[-1]


def test_trace_dir_writes_a_profiler_trace_with_the_spans(blobs, tmp_path):
    x, y = blobs
    tdir = tmp_path / "trace"
    cfg = _on(SVMConfig(c=4.0, gamma=0.1, engine="block",
                        working_set_size=32, chunk_iters=128), tmp_path,
              trace_dir=str(tdir))
    res = solve(x, y, cfg, device="cpu", callback=lambda *a: None)
    final = read_runlog(res.stats["obs_runlog"])[-1]
    assert final["trace_path"].startswith(str(tdir))
    with open(final["trace_path"]) as fh:
        assert "solver/chunk" in fh.read()
    spans = [r for r in read_runlog(res.stats["obs_runlog"])
             if r["kind"] == "span"]
    assert sum(r["name"] == "solver/chunk" for r in spans) == \
        res.stats["chunks"]
    # The block round's spans ride the same session (tests/
    # test_torch_spans.py holds their counts).
    assert {"block/select", "block/gather", "block/subproblem",
            "block/fold", "block/read"} <= {r["name"] for r in spans}


def test_compile_records_and_counter(tmp_path):
    """A build reported while a run is live is a compile record under
    the innermost label; the process counter counts every report."""
    o = RunObs("solve", meta={"n": 7}, directory=str(tmp_path))
    n0 = compilelog.compiles_total()
    with o.span("solver/chunk"):
        compilelog.record("build/subproblem", 1.5)
    compilelog.record("graph/fleet", 0.25, shape="k=4 trips=256")
    o.finish()
    assert compilelog.compiles_total() == n0 + 2
    recs = [r for r in read_runlog(o.path) if r["kind"] == "compile"]
    assert [r["entrypoint"] for r in recs] == [
        "solver/chunk:build/subproblem", "graph/fleet"]
    assert recs[0]["shape"] == "n=7" and recs[1]["shape"] == "k=4 trips=256"
    summary = analyze.summarize_run(analyze.load_runs([o.path])[-1])
    assert summary["compiles"] == 2 and summary["compile_seconds"] == 1.75


# ------------------------------------------------------------ entry points

def test_cli_train_obs_writes_a_run_log_that_obs_report_reads(tmp_path,
                                                              capsys):
    from dpsvm_tpu_torch import cli

    rng = np.random.default_rng(0)
    x = rng.normal(size=(80, 5)).astype(np.float32)
    y = np.where(x[:, 0] > 0, 1, -1)
    csv = tmp_path / "train.csv"
    csv.write_text("\n".join(",".join([str(int(yi))] + [f"{v:.5f}"
                                                        for v in row])
                             for yi, row in zip(y, x)) + "\n")
    runs = tmp_path / "runs"
    rc = cli.main(["train", "-f", str(csv), "-m", str(tmp_path / "m.txt"),
                   "-q", "--device", "cpu", "--engine", "block",
                   "--obs", "--obs-dir", str(runs),
                   "--metrics-jsonl", str(tmp_path / "m.jsonl")])
    assert rc == 0
    files = list(runs.glob("solve*.jsonl"))
    assert len(files) == 1
    kinds = {r["kind"] for r in read_runlog(str(files[0]))}
    assert {"manifest", "chunk", "final"} <= kinds
    assert (tmp_path / "m.jsonl").read_text().strip()
    capsys.readouterr()
    assert cli.main(["obs", "report", str(runs)]) == 0
    out = capsys.readouterr().out
    assert "1 run(s)" in out and "solve" in out


def test_serving_logs_register_and_hot_swap(blobs, tmp_path):
    """A served model with obs on keeps its verdicts and logs register
    and hot_swap; the v1 server's run log gets its final snapshot."""
    from dpsvm_tpu_torch import PredictServer, train
    from dpsvm_tpu_torch.config import ServeConfig
    from dpsvm_tpu_torch.serving import ServingEngine

    x, y = blobs
    model, _ = train(x, y, SVMConfig(c=4.0, gamma=0.1, engine="block",
                                     working_set_size=32), device="cpu")
    p = str(tmp_path / "m.npz")
    model.save(p)
    obs = ObsConfig(enabled=True, runlog_dir=str(tmp_path / "runs"))
    ref = ServingEngine(ServeConfig(buckets=(16,)), device="cpu")
    eng = ServingEngine(ServeConfig(buckets=(16,), obs=obs), device="cpu")
    outs = []
    for e in (ref, eng):
        e.register("m", p)
        e.swap("m", p)
        t = e.submit(x[:10], "m")
        outs.append(e.drain()[t])
        e.close()
    assert outs[0].verdict == outs[1].verdict == "ok"
    np.testing.assert_array_equal(outs[0].decision, outs[1].decision)
    srv = PredictServer(model, ServeConfig(buckets=(16,), obs=obs),
                        device="cpu")
    srv.predict(x[:5])
    srv.close()
    runs = analyze.load_runs([str(tmp_path / "runs")])
    events = [e["name"] for r in runs for e in r.events]
    assert "register" in events and "hot_swap" in events
    assert sum(1 for r in runs if r.final is not None) == 2


def test_front_door_and_fleet_events(blobs, tmp_path):
    """A ReplicaFleet with obs on behind its front door logs the JAX
    package's fleet and wire events: fleet_up, fleet_register,
    fleet_swap, listen, conn_open, conn_close, drain (begin, end),
    restart_replica, drain_replica and resume_replica; each replica's
    engine logs its own run with its replica id."""
    from dpsvm_tpu_torch import train
    from dpsvm_tpu_torch.config import ServeConfig
    from dpsvm_tpu_torch.serving import ReplicaFleet, ServeClient, ServeServer

    x, y = blobs
    model, _ = train(x, y, SVMConfig(c=4.0, gamma=0.1, engine="block",
                                     working_set_size=32), device="cpu")
    p = str(tmp_path / "m.npz")
    model.save(p)
    runs = str(tmp_path / "runs")
    fleet = ReplicaFleet(ServeConfig(
        buckets=(16,), listen="127.0.0.1:0", replicas=2,
        journal_path=str(tmp_path / "j.json"),
        obs=ObsConfig(enabled=True, runlog_dir=runs)), device="cpu")
    srv = ServeServer(fleet)
    try:
        fleet.register("m", p)
        fleet.swap("m", p)
        with ServeClient(srv.host, srv.port) as cli:
            assert cli.request(x[:3], model="m").verdict == "served"
        fleet.restart_replica(1)
    finally:
        srv.close()
        fleet.close()
    runs_ = analyze.load_runs([runs])
    agg = [r for r in runs_ if r.manifest.get("engine") == "serving_fleet"]
    assert len(agg) == 1
    names = [e["name"] for e in agg[0].events]
    for want in ("fleet_up", "fleet_register", "fleet_swap", "listen",
                 "conn_open", "conn_close", "restart_replica",
                 "drain_replica", "resume_replica", "drain"):
        assert want in names, want
    assert agg[0].final is not None
    reps = sorted(r.manifest.get("replica") for r in runs_
                  if r.manifest.get("engine") == "serving_v2")
    assert reps == [0, 1, 1]  # replica 1 restarted: a second run


def test_shardlocal_demotion_is_an_event(blobs, tmp_path):
    x, y = blobs
    cfg = _on(SVMConfig(c=4.0, gamma=0.1, engine="block",
                        working_set_size=16, local_working_sets=2,
                        sync_rounds=2), tmp_path)
    res = solve_mesh(x, y, cfg, mesh=Mesh(["cpu"] * 2))
    assert res.stats["shardlocal_demoted"]
    recs = records_for(read_runlog(res.stats["obs_runlog"]),
                       res.stats["obs_run_id"])
    ev = [r for r in recs if r["kind"] == "event"]
    assert [e["name"] for e in ev] == ["shardlocal_demotion"]
    assert ev[0]["pairs"] == res.stats["shardlocal_demotion"]["pairs"]
    assert recs[-1]["shardlocal_demoted"] is True
    assert any(r["kind"] == "chunk" and r["shardlocal"] for r in recs)


def test_cli_trace_dir_without_obs_and_the_metrics_stream(tmp_path):
    """--trace-dir alone wraps the whole CLI run in one profiler trace;
    --metrics-jsonl writes a record a chunk (MetricsLogger), the SV
    estimate of each the count of the solve's state."""
    from dpsvm_tpu_torch import cli
    from dpsvm_tpu_torch.utils.metrics import MetricsLogger, PhaseTimer

    rng = np.random.default_rng(1)
    x = rng.normal(size=(60, 4)).astype(np.float32)
    y = np.where(x[:, 1] > 0, 1, -1)
    csv = tmp_path / "t.csv"
    csv.write_text("\n".join(",".join([str(int(b))] + [f"{v:.5f}"
                                                       for v in a])
                             for a, b in zip(x, y)) + "\n")
    tdir = tmp_path / "trace"
    mj = tmp_path / "m.jsonl"
    assert cli.main(["train", "-f", str(csv), "-m", str(tmp_path / "m.txt"),
                     "-q", "--device", "cpu", "--engine", "block",
                     "--working-set-size", "8", "--chunk-iters", "16",
                     "--trace-dir", str(tdir),
                     "--metrics-jsonl", str(mj)]) == 0
    (trace_file,) = list(tdir.glob("trace-*.json"))
    assert json.loads(trace_file.read_text())["traceEvents"]
    recs = [json.loads(ln) for ln in mj.read_text().splitlines()]
    assert len(recs) > 1 and recs[-1]["gap"] <= 2e-3 + 1e-6
    # The logger counts a mesh state's per-shard alphas too.
    log = MetricsLogger()
    import torch

    class _S:
        alpha = [torch.tensor([0.0, 1.0]), torch.tensor([2.0, 0.0])]

    log(5, -1.0, 1.0, _S())
    assert log.records[0]["sv_estimate"] == 2
    timer = PhaseTimer()
    with timer.phase("a", torch.zeros(2)):
        pass
    assert set(timer.phases) == {"a"} and timer.phases["a"] >= 0
