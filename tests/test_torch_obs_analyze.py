"""Run-log analytics in the port (obs/analyze.py, `cli obs`) against the
JAX package's dpsvm_tpu/obs/analyze.py on the same files: summaries,
stall windows, the report (text and markdown), the per-phase diff,
pick_run, tail and the CLI. Pure readers: the run logs are written by
the port's RunLog (and one by the JAX package's), no device work."""

import json

import pytest

from dpsvm_tpu.obs import analyze as janalyze
from dpsvm_tpu.obs.runlog import RunLog as JaxRunLog
from dpsvm_tpu_torch import cli
from dpsvm_tpu_torch.obs import analyze
from dpsvm_tpu_torch.obs.runlog import RunLog


def _write_solve_run(path, pairs_per_chunk=(100, 100, 100),
                     gaps=(1.0, 0.5, 0.01), device_s=0.1, phase_seconds=None,
                     tool="solve", converged=True, compiles=0, events=(),
                     writer=RunLog, final_extra=None):
    log = writer(str(path), tool, meta={"n": 1000, "d": 8,
                                        "engine": "block"})
    total = 0
    for i, (p, g) in enumerate(zip(pairs_per_chunk, gaps)):
        total += p
        log.record("chunk", pairs=total, pairs_delta=p, b_hi=-g / 2,
                   b_lo=g / 2, gap=g, device_seconds=device_s,
                   dispatch=i + 1)
    for _ in range(compiles):
        log.record("compile", entrypoint="solver/chunk:build/subproblem",
                   shape="n=1000 d=8", seconds=0.5)
    for name in events:
        log.record("event", name=name)
    ph = phase_seconds or {"setup": 0.2,
                           "solve": device_s * len(pairs_per_chunk),
                           "observe": 0.01, "finalize": 0.02}
    log.finish(iterations=total, converged=converged, phase_seconds=ph,
               **(final_extra or {}))
    return log.run_id


def _both(fn_name, *args, **kw):
    return (getattr(analyze, fn_name)(*args, **kw),
            getattr(janalyze, fn_name)(*args, **kw))


CASES = {
    "plain": dict(),
    "stalled": dict(pairs_per_chunk=(10,) * 6,
                    gaps=(1.0, 1.0, 0.999999, 0.5, 0.5, 0.5)),
    "faults": dict(events=("fault", "retry", "demotion", "resume")),
    "compiles": dict(compiles=3),
    "shrink": dict(final_extra={"ooc_shrink": True,
                                "shrink_active_fraction": 0.25,
                                "shrink_reconstructions": 2,
                                "tiles_skipped": 12,
                                "tile_bytes_skipped": 2 ** 31,
                                "shrink_demoted": True}),
    "jax_writer": dict(writer=JaxRunLog),
    "open": dict(converged=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_summary_and_report_are_jaxs(tmp_path, case):
    p = tmp_path / "solve-1.jsonl"
    _write_solve_run(p, **CASES[case])
    mine, theirs = _both("load_runs", [str(tmp_path)])
    assert [r.run_id for r in mine] == [r.run_id for r in theirs]
    sm = [analyze.summarize_run(r) for r in mine]
    sj = [janalyze.summarize_run(r) for r in theirs]
    assert sm == sj
    for md in (False, True):
        assert analyze.render_report(sm, md=md) == \
            janalyze.render_report(sj, md=md)
    if case == "stalled":
        assert sm[0]["stalls"]["count"] >= 1
    if case == "faults":
        assert "f=1 r=1 d=1 c=1" in analyze.render_report(sm)


def test_summary_throughput_and_gap(tmp_path):
    _write_solve_run(tmp_path / "solve-1.jsonl")
    s = analyze.summarize_run(analyze.load_runs([str(tmp_path)])[0])
    assert s["pairs"] == 300 and s["chunks"] == 3
    assert s["pairs_per_second"] == 1000
    assert s["gap_first"] == 1.0 and s["gap_last"] == 0.01
    assert s["finished"] and s["converged"]


def test_directory_glob_and_tool_filter(tmp_path):
    _write_solve_run(tmp_path / "solve-1.jsonl")
    _write_solve_run(tmp_path / "serve-1.jsonl", tool="serve")
    runs = analyze.load_runs([str(tmp_path / "*.jsonl")])
    assert sorted(r.manifest["tool"] for r in runs) == ["serve", "solve"]
    with pytest.raises(FileNotFoundError):
        analyze.load_runs([str(tmp_path / "nothing*.jsonl")])


@pytest.mark.parametrize("phases_b", [
    {"setup": 0.2, "solve": 0.9, "observe": 0.01, "finalize": 0.02},
    {"setup": 2.2, "solve": 0.2, "observe": 0.01, "finalize": 0.02},
])
def test_diff_is_jaxs(tmp_path, phases_b):
    a = tmp_path / "a.jsonl"
    b = tmp_path / "b.jsonl"
    _write_solve_run(a)
    _write_solve_run(b, phase_seconds=phases_b, compiles=2)
    d, dj = (
        mod.diff_runs(mod.summarize_run(mod.pick_run(mod.load_runs([str(a)]))),
                      mod.summarize_run(mod.pick_run(mod.load_runs([str(b)]))))
        for mod in (analyze, janalyze))
    assert d == dj
    assert d["attributed_phase"] in ("solve", "setup")
    assert d["compile_delta"] == 2
    assert analyze.render_diff(d) == janalyze.render_diff(dj)


def test_pick_run_prefers_the_newest_finished(tmp_path):
    p = tmp_path / "solve-1.jsonl"
    first = _write_solve_run(p)
    second = _write_solve_run(p, converged=False)
    log = RunLog(str(p), "solve")  # an open run: no final record
    log.record("chunk", pairs=1, pairs_delta=1)
    for mod in (analyze, janalyze):
        runs = mod.load_runs([str(p)])
        assert mod.pick_run(runs).run_id == second
        assert mod.pick_run(runs, run_id=first).run_id == first
        with pytest.raises(KeyError):
            mod.pick_run(runs, run_id="nope")


@pytest.mark.parametrize("n", [0, 2, 50])
def test_tail_is_jaxs(tmp_path, n):
    p = tmp_path / "solve-1.jsonl"
    _write_solve_run(p, events=("fault",))
    mine, theirs = _both("tail_records", str(p), n)
    assert mine == theirs
    assert len(mine) == min(n, 6)


def test_cli_obs_report_diff_tail_and_errors(tmp_path, capsys):
    a = tmp_path / "a.jsonl"
    b = tmp_path / "b.jsonl"
    _write_solve_run(a)
    _write_solve_run(b, phase_seconds={"setup": 0.2, "solve": 1.3})
    assert cli.main(["obs", "report", str(tmp_path)]) == 0
    assert "2 run(s): 600 pairs" in capsys.readouterr().out
    assert cli.main(["obs", "report", "--md", str(a)]) == 0
    assert capsys.readouterr().out.startswith("| tool |")
    assert cli.main(["obs", "report", "--json", str(a)]) == 0
    line = json.loads(capsys.readouterr().out.strip())
    assert line["pairs"] == 300
    assert cli.main(["obs", "diff", str(a), str(b)]) == 0
    assert "attribution: phase 'solve'" in capsys.readouterr().out
    assert cli.main(["obs", "diff", "--json", str(a), str(b)]) == 0
    assert json.loads(capsys.readouterr().out)["attributed_phase"] \
        == "solve"
    assert cli.main(["obs", "tail", str(a), "-n", "2"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 2 and "final" in out[-1]
    assert cli.main(["obs", "report", str(tmp_path / "missing")]) == 2
    assert "error:" in capsys.readouterr().err
    assert cli.main(["obs", "tail", str(tmp_path)]) == 2
