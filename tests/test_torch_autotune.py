"""The port's autotune (dpsvm_tpu_torch/autotune) against the JAX
package's: profile I/O and its rules on one document both packages read,
the probe records' verdict rule, a deterministic probe pass, and the
gates the profile decides in solve, solve_ooc and solve_mesh and in the
serving bucket ladder, each with the same provenance records as the JAX
package on the same inputs.

Every probe pass here runs at the smoke scale on the CPU, where every
probe is non-authoritative; the JAX package's probes are not run (its
fused and ring probes run interpret-mode Pallas)."""

import dataclasses
import json
import re
import warnings

import jax
import numpy as np
import pytest
import torch

from dpsvm_tpu import autotune as jat
from dpsvm_tpu.autotune import probes as jprobes
from dpsvm_tpu.autotune import profile as jprofile
from dpsvm_tpu.config import ServeConfig as JaxServeConfig
from dpsvm_tpu.config import SVMConfig as JaxConfig
from dpsvm_tpu.parallel.dist_smo import solve_mesh as jax_solve_mesh
from dpsvm_tpu.serve import resolve_buckets as jax_resolve_buckets
from dpsvm_tpu.solver.smo import solve as jax_solve
from dpsvm_tpu_torch import autotune as tat
from dpsvm_tpu_torch import cli
from dpsvm_tpu_torch.autotune import probes as tprobes
from dpsvm_tpu_torch.autotune import profile as tprofile
from dpsvm_tpu_torch.config import ObsConfig, ServeConfig, SVMConfig
from dpsvm_tpu_torch.data.synth import make_blobs_binary
from dpsvm_tpu_torch.parallel.dist_smo import solve_mesh
from dpsvm_tpu_torch.parallel.mesh import Mesh
from dpsvm_tpu_torch.serve import DEFAULT_BUCKETS, resolve_buckets
from dpsvm_tpu_torch.solver.solve import solve

KNOB_PROBE = {"pipeline_rounds": "pipeline",
              "pipeline_rounds_mesh": "pipeline_mesh",
              "local_working_sets": "shardlocal",
              "ring_exchange": "ring", "fused_round": "fused_round",
              "ooc_shrink": "ooc_shrink", "serve_buckets": "serve_buckets"}
ALL_OFF = {k: False for k in KNOB_PROBE}
CFG = dict(engine="block", working_set_size=16, epsilon=1e-2, c=10.0,
           gamma=0.1)


class FakeClock:
    """Every interval reads exactly `step` seconds: two same-seed passes
    give byte-identical records."""

    def __init__(self, step: float = 1e-3):
        self.t = 0.0
        self.step = step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


def _doc(decisions, device_kind="cpu", ratio=0.5, authoritative=True,
         torch_version=None, jax_version=None, skipped=()):
    """A profile document carrying BOTH packages' version stamps (the
    JAX package reads `jax`, the port `torch`)."""
    probes = {}
    for knob, dec in decisions.items():
        name = KNOB_PROBE[knob]
        probes[name] = {"probe": name, "knob": knob, "seed": 0,
                        "shapes": {"n": 1024, "d": 16, "q": 16},
                        "a_seconds": 1.0, "b_seconds": ratio,
                        "ratio": ratio, "threshold": 0.9,
                        "authoritative": authoritative,
                        "verdict": bool(dec)}
    for name in skipped:
        probes[name] = {"probe": name, "knob": jprobes.PROBE_KNOBS[name],
                        "seed": 0, "shapes": {}, "skipped": "test skip",
                        "authoritative": False, "verdict": False}
    return {"schema": 1, "device_kind": device_kind, "backend": "cpu",
            "n_devices": 8, "jax": jax_version or jax.__version__,
            "torch": torch_version or torch.__version__,
            "utc": "2026-10-01T00:00:00Z", "git_sha": "deadbeef", "seed": 0,
            "probes": probes, "decisions": dict(decisions)}


def _write(tmp_path, doc, name="cpu.json") -> str:
    p = tmp_path / name
    p.write_text(json.dumps(doc, indent=1, sort_keys=True))
    return str(p)


def _load_both(path):
    """(port outcome, JAX outcome): the loaded profile, or "refused" (the
    package's ProfileError)."""
    out = []
    for mod in (tprofile, jprofile):
        try:
            out.append(mod.load_profile(path))
        except mod.ProfileError:
            out.append("refused")
    return out


@pytest.fixture(scope="module")
def blobs():
    return make_blobs_binary(n=300, d=8, seed=3, sep=1.2)


@pytest.fixture
def both_profiles(tmp_path):
    """Install one document as the active profile in both packages."""
    import contextlib

    @contextlib.contextmanager
    def install(doc):
        path = _write(tmp_path, doc, "installed.json")
        with tprofile.use_profile(path), jprofile.use_profile(path):
            yield path
    return install


# ------------------------------------------------------------- profile I/O

def _profile_case(case):
    if case == "round_trip":
        return _doc({**ALL_OFF, "ring_exchange": True})
    if case == "newer_schema":
        return {**_doc(ALL_OFF), "schema": 2}
    if case == "honesty":
        return _doc({**ALL_OFF, "pipeline_rounds": True},
                    authoritative=False)
    if case == "honesty_no_probe":
        doc = _doc({**ALL_OFF, "fused_round": True})
        del doc["probes"]["fused_round"]
        return doc
    if case == "malformed":
        return {**_doc(ALL_OFF), "n_devices": None}
    if case == "missing_fields":
        return {"schema": 1}
    if case == "skipped":
        off = {k: v for k, v in ALL_OFF.items() if k != "ring_exchange"}
        return _doc(off, skipped=("ring",))
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["round_trip", "newer_schema", "honesty",
                                  "honesty_no_probe", "malformed",
                                  "missing_fields", "skipped"])
def test_profile_rules_match_jax(case, tmp_path):
    """Each document is given to both load_profiles: the same accept or
    refuse outcome, the same decisions and probes, and the same gate
    decisions through use_profile."""
    path = _write(tmp_path, _profile_case(case))
    mine, theirs = _load_both(path)
    if theirs == "refused":
        assert mine == "refused", (case, mine)
        return
    assert mine != "refused", case
    assert mine.decisions == theirs.decisions
    assert mine.probes == theirs.probes
    assert mine.path == theirs.path == path
    assert mine.torch == torch.__version__ and theirs.jax == jax.__version__
    for knob in KNOB_PROBE:
        with tprofile.use_profile(mine), jprofile.use_profile(theirs):
            assert tprofile.gate_decision(knob, "cpu") == \
                jprofile.gate_decision(knob, "cpu")
    if case == "skipped":
        assert "ring_exchange" not in mine.decisions
        with tprofile.use_profile(mine):
            assert tprofile.gate_decision("ring_exchange", "cpu") is None


@pytest.mark.parametrize("case", ["partial", "skipped_over_measured",
                                  "full_pass_over_skew"])
def test_profile_merges_match_jax(case, tmp_path):
    """_merge_partial / _maybe_merge: the same merged probes and
    decisions, and the same refusals, in both packages."""
    fresh = _doc({"ring_exchange": True}, ratio=0.4)
    if case == "partial":
        base = _doc(ALL_OFF)
    elif case == "skipped_over_measured":
        base = _doc({**ALL_OFF, "ring_exchange": True})
        fresh = _doc({}, skipped=("ring",))
    else:
        base = _doc(ALL_OFF, jax_version="9.9.0", torch_version="9.9.0")
    p_base = _write(tmp_path, base, "base.json")
    p_fresh = _write(tmp_path, fresh, "fresh.json")
    t_fresh = tprofile.load_profile(p_fresh)
    j_fresh = jprofile.load_profile(p_fresh)
    if case == "full_pass_over_skew":
        with pytest.raises(tprofile.ProfileError, match="version-skewed"):
            tat._merge_partial(t_fresh, p_base)
        with pytest.raises(jprofile.ProfileError, match="version-skewed"):
            jat._merge_partial(j_fresh, p_base)
        assert tat._maybe_merge(t_fresh, p_base, partial=False) is t_fresh
        assert jat._maybe_merge(j_fresh, p_base, partial=False) is j_fresh
        return
    tm = tat._maybe_merge(t_fresh, p_base, partial=True)
    jm = jat._maybe_merge(j_fresh, p_base, partial=True)
    assert tm.decisions == jm.decisions
    assert tm.probes == jm.probes
    if case == "skipped_over_measured":
        assert tm.decisions["ring_exchange"] is True
        assert not tm.probes["ring"].get("skipped")


def test_port_refuses_other_kinds_torch_skew_and_jax_profiles(
        tmp_path, monkeypatch):
    """Device-kind and torch-version refusal (the port alone): each
    profile is treated as absent with one warning, so the gates take
    their defaults. A JAX-only profile (no torch stamp) is refused the
    same way."""
    monkeypatch.delenv("DPSVM_AUTOTUNE_PROFILE", raising=False)
    monkeypatch.setenv("DPSVM_AUTOTUNE_DIR", str(tmp_path))
    on = {"pipeline_rounds": True}
    cases = [
        (_doc(on, device_kind="NVIDIA H100 80GB HBM3"), "measured on"),
        (_doc(on, torch_version="9.9.0"), "torch"),
        ({k: v for k, v in _doc(on).items() if k != "torch"}, "refused"),
    ]
    for doc, phrase in cases:
        _write(tmp_path, doc)
        tprofile._warned.clear()
        with pytest.warns(UserWarning, match=phrase):
            assert tprofile.active_profile("cpu") is None
        assert tprofile.gate_decision("pipeline_rounds", "cpu") is None
    _write(tmp_path, _doc(on))
    assert tprofile.active_profile("cpu").decisions["pipeline_rounds"]
    assert tprofile.slug("NVIDIA H100 80GB HBM3") == "nvidia-h100-80gb-hbm3"
    assert tprofile.profile_path("NVIDIA H100 80GB HBM3").endswith(
        "nvidia-h100-80gb-hbm3.json")


def test_committed_profiles_load_and_keep_the_honesty_rule():
    """The committed CPU profile: non-authoritative, every decision
    False. The committed H100 profile: loads (the honesty rule holds),
    records the mesh probes as skipped on one card and every measured
    probe over the card's passes."""
    import os

    d = tprofile.profiles_dir()
    cpu = tprofile.load_profile(os.path.join(d, "cpu.json"))
    assert cpu.device_kind == "cpu" and cpu.torch == torch.__version__
    assert not any(r.get("authoritative") for r in cpu.probes.values())
    assert set(cpu.decisions.values()) == {False}
    assert set(cpu.probes) == set(tprobes.PROBES)
    h100 = tprofile.load_profile(
        os.path.join(d, "nvidia-h100-80gb-hbm3.json"))
    assert h100.device_kind == "NVIDIA H100 80GB HBM3"
    for name in ("shardlocal", "pipeline_mesh", "ring"):
        assert "item 6" in h100.probes[name]["skipped"]
        assert tprobes.PROBE_KNOBS[name] not in h100.decisions
    for name in ("pipeline", "fused_round", "ooc_shrink", "serve_buckets"):
        rec = h100.probes[name]
        assert rec["authoritative"] is True
        assert rec["passes"] == tat.CARD_PASSES
        assert len(rec["ratios"]) == rec["passes"]
    # The ooc probe's whole solves, both converged on the card.
    assert all(side["converged"]
               for side in h100.probes["ooc_shrink"]["solves"].values())


# ------------------------------------------------------------ the probes

def test_ab_and_skip_records_match_jax():
    """The verdict rule on a grid of seconds, thresholds and
    authoritative flags, including the ratio-None cases (a zero on
    either side), and the skip record."""
    tctx = tprobes.ProbeContext(smoke=True, device="cpu")
    jctx = jprobes.ProbeContext(smoke=True)
    assert tctx.shapes() == jctx.shapes()
    grid = (0.0, 1e-9, 4e-4, 0.45, 0.9, 1.0, 2.5)
    for probe in tprobes.PROBES:
        assert tprobes.PROBE_KNOBS[probe] == jprobes.PROBE_KNOBS[probe]
    for a in grid:
        for b in grid:
            for thr in (None, 0.5):
                for auth in (True, False):
                    args = ("pipeline", "plain", "piped", a, b, auth)
                    kw = dict(note="n", threshold=thr)
                    assert tprobes._ab_record(args[0], tctx, *args[1:],
                                              **kw) == \
                        jprobes._ab_record(args[0], jctx, *args[1:], **kw)
    assert tprobes._skip_record("ring", tctx, "why") == \
        jprobes._skip_record("ring", jctx, "why")


def test_agreement_across_passes():
    """agree(): the verdict needs every pass to pay; the record is the
    pass least favourable to B, so its ratio reconciles from its own
    seconds; every pass's ratio and their spread ride along; a pass
    with no reading (ratio None) vetoes; one pass and a skip pass
    through unchanged."""
    ctx = tprobes.ProbeContext(smoke=True, device="cpu")

    def rec(b, auth=True):
        return tprobes._ab_record("fused_round", ctx, "a", "b", 1.0, b,
                                  authoritative=auth)

    one = rec(0.5)
    assert tprobes.agree([one]) is one
    skip = tprobes._skip_record("ring", ctx, "why")
    assert tprobes.agree([skip, skip]) is skip
    paid = tprobes.agree([rec(0.5), rec(0.8), rec(0.6)])
    assert paid["verdict"] is True and paid["ratio"] == 0.8
    assert paid["b_seconds"] / paid["a_seconds"] == pytest.approx(0.8)
    assert paid["ratios"] == [0.5, 0.8, 0.6] and paid["passes"] == 3
    assert paid["spread"] == pytest.approx(0.3)
    split = tprobes.agree([rec(0.27), rec(0.95), rec(0.5)])
    assert split["verdict"] is False and split["ratio"] == 0.95
    blind = tprobes.agree([rec(0.5), rec(0.0)])
    assert blind["verdict"] is False and blind["ratio"] is None
    assert blind["spread"] is None
    cpu = tprobes.agree([rec(0.5, auth=False)] * 2)
    assert cpu["verdict"] is False


def test_port_refuses_a_true_decision_a_pass_did_not_pay(tmp_path):
    """The honesty rule at load covers every pass: a True decision whose
    record lists a pass over its threshold (or with no reading) is
    refused; the same record with every pass paying loads."""
    for ratios, ok in (([0.5, 0.7, 0.8], True), ([0.5, 0.95], False),
                       ([0.5, None], False)):
        doc = _doc({**ALL_OFF, "fused_round": True})
        doc["probes"]["fused_round"].update(passes=len(ratios),
                                            ratios=ratios)
        path = _write(tmp_path, doc, "passes.json")
        if ok:
            assert tprofile.load_profile(path).decisions["fused_round"]
        else:
            with pytest.raises(tprofile.ProfileError, match="honesty"):
                tprofile.load_profile(path)


def test_passes_run_the_list_and_keep_every_ratio():
    """run_probes(passes=2) with a fake clock: every measured record
    carries both passes' ratios."""
    prof = tat.run_probes(knobs=["pipeline", "serve_buckets"],
                          seed=1, smoke=True, timer=FakeClock(),
                          verbose=False, device="cpu", passes=2)
    for name in ("pipeline", "serve_buckets"):
        rec = prof.probes[name]
        assert rec["passes"] == 2 and len(rec["ratios"]) == 2
        assert rec["verdict"] is False
    with pytest.raises(ValueError, match="passes"):
        tat.run_probes(knobs=["pipeline"], smoke=True, device="cpu",
                       passes=0)


def test_probe_pass_is_deterministic_and_run_logged(tmp_path):
    """run_probes(smoke=True) twice with a fake clock: byte-stable
    stable_view and records, every CPU decision False, each probe
    mirrored into the autotune run log."""
    from dpsvm_tpu_torch.obs.runlog import read_runlog

    ocfg = ObsConfig(enabled=True, runlog_dir=str(tmp_path))
    profs = [tat.run_probes(seed=3, smoke=True, timer=FakeClock(),
                            obs_config=ocfg, verbose=False, device="cpu")
             for _ in range(2)]
    a, b = (json.dumps(tat.stable_view(p), sort_keys=True) for p in profs)
    assert a == b
    assert profs[0].probes == profs[1].probes
    assert profs[0].decisions == {k: False for k in KNOB_PROBE}
    assert not any(r["authoritative"] for r in profs[0].probes.values())
    assert profs[0].torch == torch.__version__
    # The ooc probe times whole solves: each side's solves converge, and
    # the rounds they ran in all are the rounds of each times their count.
    for side in profs[0].probes["ooc_shrink"]["solves"].values():
        assert side["converged"] and side["solves"] == 2
        assert side["rounds_run"] == side["solves"] * side["rounds"]
    path, = tmp_path.glob("autotune-*.jsonl")
    recs = read_runlog(str(path))
    assert sum(r["kind"] == "probe" for r in recs) == 2 * len(tat.PROBES)
    assert [r["kind"] for r in recs if r["kind"] != "probe"] == \
        ["manifest", "final"] * 2


# ---------------------------------------------- gates on one device

def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **kw)


def test_single_device_gate_records_match_jax(blobs, both_profiles,
                                              tmp_path, capsys):
    """The same stats["autotune"] records in both packages; the run-log
    manifest's autotune key equals the stats fragment, and `obs
    report`'s profile column reads it (the profile's name, with a +knob
    tag for each gate it turned on)."""
    from dpsvm_tpu_torch.obs.analyze import run_cli as obs_cli
    from dpsvm_tpu_torch.obs.runlog import read_runlog

    x, y = blobs
    runs = tmp_path / "runs"
    with both_profiles(_doc({**ALL_OFF, "fused_round": True})):
        solve(x, y, SVMConfig(**CFG, obs=ObsConfig(
            enabled=True, runlog_dir=str(tmp_path / "on"))), device="cpu")
    capsys.readouterr()
    assert obs_cli(["report", str(tmp_path / "on")]) == 0
    assert "installed.json +fused_round" in capsys.readouterr().out
    with both_profiles(_doc(ALL_OFF)):
        rt = solve(x, y, SVMConfig(**CFG, obs=ObsConfig(
            enabled=True, runlog_dir=str(runs))), device="cpu")
        rj = _quiet(jax_solve, x, y, JaxConfig(**CFG))
    assert rt.stats["autotune"] == rj.stats["autotune"]
    gates = rt.stats["autotune"]["gates"]
    assert set(gates) == {"pipeline_rounds", "fused_round"}
    assert all(g["source"] == "profile" and g["decision"] is False
               for g in gates.values())
    path, = runs.glob("solve-*.jsonl")
    man, = [r for r in read_runlog(str(path)) if r["kind"] == "manifest"]
    assert man["autotune"] == rt.stats["autotune"]


def test_no_profile_and_cpu_profile_are_bitwise_today(blobs, both_profiles):
    """No profile, an all-False profile and the committed CPU profile
    (the default resolution here): alpha, iterations and f bitwise."""
    x, y = blobs
    cfg = SVMConfig(**CFG)
    with tprofile.use_profile(None):
        r0 = solve(x, y, cfg, device="cpu")
    with both_profiles(_doc(ALL_OFF)):
        r1 = solve(x, y, cfg, device="cpu")
    r2 = solve(x, y, cfg, device="cpu")
    assert r0.stats["autotune"]["gates"]["fused_round"]["source"] == \
        "default"
    assert r2.stats["autotune"]["gates"]["fused_round"]["profile"] \
        .endswith("cpu.json")
    for r in (r1, r2):
        np.testing.assert_array_equal(r.alpha, r0.alpha)
        np.testing.assert_array_equal(r.stats["f"], r0.stats["f"])
        assert r.iterations == r0.iterations
        assert not (r.stats["pipelined"] or r.stats["fused_round"])


def _dual(res, y):
    a = np.asarray(res.alpha, np.float64)
    f = np.asarray(res.stats["f"], np.float64)
    return float(a.sum() - 0.5 * np.sum(a * y * (f + y)))


def _contract(rt, rj, y):
    assert rt.converged and rj.converged
    assert abs(_dual(rt, y) - _dual(rj, y)) <= 1e-4 * abs(_dual(rj, y))
    assert abs(rt.n_sv - rj.n_sv) <= max(1, 0.02 * rj.n_sv)
    assert abs(rt.b - rj.b) <= 5e-3


@pytest.mark.parametrize("knob,flag", [("pipeline_rounds", "pipelined"),
                                       ("fused_round", "fused_round")])
def test_true_decision_routes_both_packages_alike(blobs, both_profiles,
                                                  knob, flag):
    """A True decision runs the engine in both packages (the JAX solve
    takes the rounds of its explicit-knob twin), within the whole-solve
    contract of each other; an explicit knob wins and records no gate."""
    x, y = blobs
    with both_profiles(_doc({**ALL_OFF, knob: True})):
        rt = solve(x, y, SVMConfig(**CFG), device="cpu")
        rj = _quiet(jax_solve, x, y, JaxConfig(**CFG))
        ft = solve(x, y, SVMConfig(**CFG, **{knob: False}), device="cpu")
        fj = _quiet(jax_solve, x, y, JaxConfig(**CFG, **{knob: False}))
    twin = _quiet(jax_solve, x, y, JaxConfig(**CFG, **{knob: True}))
    assert rt.stats[flag] and rt.stats["autotune"] == rj.stats["autotune"]
    assert rt.stats["autotune"]["gates"][knob]["decision"] is True
    assert rj.stats["outer_rounds"] == twin.stats["outer_rounds"]
    np.testing.assert_array_equal(rj.alpha, twin.alpha)
    _contract(rt, rj, y)
    assert not ft.stats[flag]
    assert knob not in ft.stats.get("autotune", {}).get("gates", {})
    assert ft.stats.get("autotune") == fj.stats.get("autotune")


def test_ooc_shrink_gate_matches_jax(blobs, both_profiles):
    """solve_ooc's ooc_shrink=None consults the gate: the same record as
    the JAX package, and a True decision shrinks the stream."""
    x, y = blobs
    kw = dict(CFG, ooc=True, ooc_tile_rows=64)
    for on in (False, True):
        with both_profiles(_doc({**ALL_OFF, "ooc_shrink": on})):
            rt = solve(x, y, SVMConfig(**kw), device="cpu")
            rj = _quiet(jax_solve, x, y, JaxConfig(**kw))
        assert rt.stats["autotune"] == rj.stats["autotune"]
        assert rt.stats["ooc_shrink"] is on
        assert rj.stats["ooc_shrink"] is on
        _contract(rt, rj, y)
    explicit = solve(x, y, SVMConfig(**kw, ooc_shrink=False), device="cpu")
    assert "autotune" not in explicit.stats


# --------------------------------------------------------- mesh gates

def test_mesh_gate_records_match_jax(blobs, both_profiles, tmp_path):
    """solve_mesh consults the mesh's own knobs (pipeline_rounds_mesh,
    local_working_sets, ring_exchange) with the JAX package's records;
    the manifest carries the fragment."""
    from dpsvm_tpu_torch.obs.runlog import read_runlog

    x, y = blobs
    runs = tmp_path / "runs"
    with both_profiles(_doc(ALL_OFF)):
        rt = _quiet(solve_mesh, x, y, SVMConfig(**CFG, obs=ObsConfig(
            enabled=True, runlog_dir=str(runs))), mesh=Mesh(["cpu"] * 4))
        rj = _quiet(jax_solve_mesh, x, y, JaxConfig(**CFG), num_devices=4)
    assert rt.stats["autotune"] == rj.stats["autotune"]
    assert set(rt.stats["autotune"]["gates"]) == {
        "local_working_sets", "pipeline_rounds_mesh", "ring_exchange"}
    path, = runs.glob("solve_mesh-*.jsonl")
    man, = [r for r in read_runlog(str(path)) if r["kind"] == "manifest"]
    assert man["autotune"] == rt.stats["autotune"]
    _contract(rt, rj, y)


def test_mesh_true_decision_and_one_shard_guard(blobs, both_profiles):
    """A True ring_exchange decision runs the ring exchange in both
    packages; a True local_working_sets decision engages the shard-local
    runner on 2 shards but is not even consulted on one."""
    x, y = blobs
    with both_profiles(_doc({**ALL_OFF, "ring_exchange": True})):
        rt = _quiet(solve_mesh, x, y, SVMConfig(**CFG),
                    mesh=Mesh(["cpu"] * 2))
        rj = _quiet(jax_solve_mesh, x, y, JaxConfig(**CFG), num_devices=2)
    assert rt.stats["autotune"] == rj.stats["autotune"]
    assert rt.stats["ring_exchange"]
    _contract(rt, rj, y)
    with both_profiles(_doc({**ALL_OFF, "local_working_sets": True})):
        one = _quiet(solve_mesh, x, y, SVMConfig(**CFG),
                     mesh=Mesh(["cpu"]))
        one_j = _quiet(jax_solve_mesh, x, y, JaxConfig(**CFG),
                       num_devices=1)
        two = _quiet(solve_mesh, x, y, SVMConfig(**CFG),
                     mesh=Mesh(["cpu"] * 2))
    assert "local_working_sets" not in one.stats["autotune"]["gates"]
    assert one.stats["autotune"] == one_j.stats["autotune"]
    assert not one.stats.get("shardlocal")
    assert two.stats["autotune"]["gates"]["local_working_sets"][
        "decision"] is True
    assert "shardlocal_demoted" in two.stats and two.converged


# ------------------------------------------------------- serving ladder

def test_resolve_buckets_provenance_matches_jax(both_profiles):
    for buckets in (None, (16, 64)):
        with tprofile.use_profile(None), jprofile.use_profile(None):
            assert resolve_buckets(ServeConfig(buckets=buckets), "cpu") == \
                jax_resolve_buckets(JaxServeConfig(buckets=buckets), "cpu")
    for on in (False, True):
        with both_profiles(_doc({**ALL_OFF, "serve_buckets": on})):
            for buckets in (None, (16, 64)):
                mine = resolve_buckets(ServeConfig(buckets=buckets), "cpu")
                theirs = jax_resolve_buckets(
                    JaxServeConfig(buckets=buckets), "cpu")
                assert mine == theirs
            assert mine[0] == (16, 64) and "auto_apply" not in mine[1]
            ladder, prov = resolve_buckets(ServeConfig(buckets=None), "cpu")
            assert ladder == DEFAULT_BUCKETS
            assert prov["auto_apply"] is on


@pytest.fixture(scope="module")
def served_model():
    from dpsvm_tpu_torch.models.multiclass import train_multiclass

    rng = np.random.default_rng(5)
    x = np.concatenate([rng.normal(size=(40, 4)) + 2.0 * k
                        for k in range(3)]).astype(np.float32)
    labels = np.repeat(np.arange(3), 40)
    model, _ = train_multiclass(x, labels, SVMConfig(c=5.0, gamma=0.25),
                                strategy="ovr", device="cpu")
    return model, x


def _leg(eng, x, drain=True):
    """One serving leg of 12 three-row requests: drained, or only pumped
    until the queue is empty (still inside the leg)."""
    rng = np.random.default_rng(1)
    for _ in range(12):
        eng.submit(x[rng.integers(0, len(x), size=3)], model="m")
    if drain:
        return eng.drain()
    while eng.scheduler.queue_depth:
        eng.pump()
    return None


def test_bucket_auto_apply_only_armed_and_between_legs(served_model,
                                                       both_profiles):
    """maybe_apply_bucket_suggestion applies the occupancy suggestion
    only with buckets=None under an authoritative True decision, and
    only at drain() (between legs), never inside pump(); the restaged
    groups answer the same. An explicit ladder and a False decision
    leave the ladder alone."""
    from dpsvm_tpu_torch.serving import ServingEngine

    model, x = served_model
    q = x[:5]
    with both_profiles(_doc({**ALL_OFF, "serve_buckets": True})):
        eng = ServingEngine(ServeConfig(buckets=None), device="cpu")
        fixed = ServingEngine(ServeConfig(buckets=(16, 64)), device="cpu")
    with both_profiles(_doc({**ALL_OFF, "serve_buckets": False})):
        unarmed = ServingEngine(ServeConfig(buckets=None), device="cpu")
    try:
        for e in (eng, fixed, unarmed):
            e.register("m", model)
        assert eng.bucket_provenance["auto_apply"] is True
        _leg(eng, x, drain=False)  # inside a leg: nothing applied
        assert eng._bucket_ladder == DEFAULT_BUCKETS
        assert "applied_buckets" not in eng.bucket_provenance
        done = eng.drain()  # the leg ends: applied
        assert len(done) == 12
        applied = eng.bucket_provenance["applied_buckets"]
        assert applied != list(DEFAULT_BUCKETS)
        assert tuple(applied) == eng._bucket_ladder
        assert eng.snapshot()["bucket_provenance"]["applied_buckets"] == \
            applied
        np.testing.assert_allclose(eng.decision(q, model="m"),
                                   unarmed.decision(q, model="m"),
                                   rtol=1e-6, atol=1e-6)
        for e in (fixed, unarmed):
            _leg(e, x)
            assert e.maybe_apply_bucket_suggestion() is None
            assert "applied_buckets" not in e.bucket_provenance
        assert fixed.bucket_provenance["source"] == "config"
        assert unarmed.bucket_provenance["auto_apply"] is False
        assert unarmed._bucket_ladder == DEFAULT_BUCKETS
    finally:
        for e in (eng, fixed, unarmed):
            e.close()


def test_bucket_auto_apply_waits_for_a_swap_preparation(served_model,
                                                        both_profiles):
    """While an admin thread is preparing a swap (``_preparing`` non-zero,
    as _gc_groups reads it) the armed auto-apply leaves the ladder and
    the staged groups alone; the next idle moment applies it."""
    from dpsvm_tpu_torch.serving import ServingEngine

    model, x = served_model
    with both_profiles(_doc({**ALL_OFF, "serve_buckets": True})):
        eng = ServingEngine(ServeConfig(buckets=None), device="cpu")
    try:
        eng.register("m", model)
        _leg(eng, x, drain=False)
        staged = dict(eng._groups)
        with eng._prep_lock:
            eng._preparing += 1
        eng.drain()
        assert eng._bucket_ladder == DEFAULT_BUCKETS
        assert "applied_buckets" not in eng.bucket_provenance
        assert eng._groups == staged
        with eng._prep_lock:
            eng._preparing -= 1
        applied = eng.maybe_apply_bucket_suggestion()
        assert applied and tuple(applied) == eng._bucket_ladder
        assert eng._groups == {}
        assert len(eng.decision(x[:5], model="m")) == 5
    finally:
        eng.close()


# ---------------------------------------------------------------- cli

def test_cli_autotune_run_show_diff(tmp_path, capsys):
    out_a, out_b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    for out in (out_a, out_b):
        assert cli.main(["autotune", "run", "--smoke", "--device", "cpu",
                         "--knobs", "pipeline,serve_buckets",
                         "--out", out]) == 0
    capsys.readouterr()
    assert cli.main(["autotune", "show", out_a]) == 0
    shown = capsys.readouterr().out
    assert re.search(r"pipeline\s+pipeline_rounds", shown)
    assert "decisions: pipeline_rounds=False, serve_buckets=False" in shown
    assert cli.main(["autotune", "diff", out_a, out_b]) == 0
    diffed = capsys.readouterr().out
    assert "verdict moved" not in diffed
    assert cli.main(["autotune", "show", "--device", "cpu"]) == 0
    assert "cpu.json" in capsys.readouterr().out
    bad = _write(tmp_path, {**_doc(ALL_OFF), "schema": 2}, "bad.json")
    assert cli.main(["autotune", "show", bad]) == 2


def test_cli_lint_threads_check_passes(capsys):
    assert cli.main(["lint", "--threads", "--check"]) == 0
    assert "PASS" in capsys.readouterr().out
    assert cli.main(["lint"]) == 2
    assert "no XLA HLO" in capsys.readouterr().err


def test_decision_table_and_stable_view_shape():
    doc = _doc({**ALL_OFF, "pipeline_rounds": True}, skipped=("ring",))
    prof = tprofile.DeviceProfile(**{k: v for k, v in doc.items()
                                     if k not in ("jax",)})
    view = tat.stable_view(prof)
    assert set(view) == {"device_kind", "backend", "n_devices", "seed",
                         "decisions", "probes"}
    assert "skipped: test skip" in tat._decision_table(prof)
    assert dataclasses.asdict(prof)["torch"] == torch.__version__
