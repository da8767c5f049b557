"""The mesh engines this port added to parallel/dist_smo.py and
parallel/dist_block.py, against the JAX package's solve_mesh with the
same knobs on its forced host devices (tests/conftest.py), the port on
Mesh(["cpu"] * P): the per-pair mesh engine (engine="xla": plain,
cached, second order, nu), the pipelined runner (with and without the
ring), the fused-fold runner, the active-set runner, and the model
families on the mesh.

Contracts: the per-pair engine's first 20 trips update the coordinates
JAX's update (ROADMAP C.12); whole solves meet the port's contract (both
converge, dual rel 1e-4, SV count 2%, |b - b_jax| <= 5e-3); within the
port the ring changes nothing (bitwise) and the budget is exact. The
per-pair mesh chunk runs on the devices (solver/smo.py queue_trips): a
solve is bitwise the same at smo.TRIPS 1, 8 and 256, the cached mesh
retraces the cached single device bit for bit, and a chunk reads the
host once a batch of TRIPS trips plus once at its end.
Mirrors tests/test_dist_smo.py:33-110 and 163-226,
tests/test_pipelined.py:268-330, tests/test_fused_fold.py:155-190 and
tests/test_nusvm.py:73-140."""

import math
import warnings

import numpy as np
import pytest

from dpsvm_tpu.config import SVMConfig as JaxConfig
from dpsvm_tpu.data.synth import make_blobs_binary
from dpsvm_tpu.models import svr as jsvr
from dpsvm_tpu.models.oneclass import train_oneclass as jax_oneclass
from dpsvm_tpu.parallel.dist_smo import solve_mesh as jax_solve_mesh
from dpsvm_tpu_torch import (Mesh, SVMConfig, solve, solve_mesh,
                             train_oneclass, train_svr)
from dpsvm_tpu_torch.analysis.op_facts import Recorder
from dpsvm_tpu_torch.models import nusvm as tnusvm
from dpsvm_tpu_torch.parallel import dist_smo as tdist
from dpsvm_tpu_torch.solver import chunks as tchunks
from dpsvm_tpu_torch.solver import smo as tsmo
from dpsvm_tpu.models import nusvm as jnusvm

BASE = dict(c=5.0, gamma=0.1, epsilon=1e-3, max_iter=200_000,
            engine="block", working_set_size=16)


@pytest.fixture(scope="module")
def blobs():
    """301 rows: every mesh size pads."""
    return make_blobs_binary(n=301, d=10, seed=3, sep=1.2)


@pytest.fixture(scope="module")
def tiny():
    return make_blobs_binary(n=160, d=8, seed=5, sep=1.5)


def _dual(res, y):
    a = np.asarray(res.alpha, np.float64)
    f = np.asarray(res.stats["f"], np.float64)
    return float(a.sum() - 0.5 * np.sum(a * y * (f + y)))


def _contract(rt, rj, y):
    assert rt.converged and rj.converged
    assert abs(_dual(rt, y) - _dual(rj, y)) <= 1e-4 * abs(_dual(rj, y))
    assert abs(rt.n_sv - rj.n_sv) <= max(1, 0.02 * rj.n_sv)
    assert abs(rt.b - rj.b) <= 5e-3


def both(x, y, kw, p_dev, **solve_kw):
    """(port, jax) solve_mesh results with the same knobs."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rt = solve_mesh(x, y, SVMConfig(**kw), mesh=Mesh(["cpu"] * p_dev),
                        **solve_kw)
        rj = jax_solve_mesh(x, y, JaxConfig(**kw), num_devices=p_dev,
                            **solve_kw)
    return rt, rj


# ---- the per-pair mesh engine --------------------------------------


def _nu_start(x, y):
    """A feasible nu-dual start (alpha in [0, 1], equal mass per class)
    and its gradient f = K (alpha y), in float64 then float32, handed to
    both packages as alpha_init / f_init."""
    alpha = np.zeros(len(y), np.float32)
    for cls in (1, -1):
        alpha[np.nonzero(y == cls)[0][:12]] = 0.5
    sq = (x.astype(np.float64) ** 2).sum(1)
    k = np.exp(-0.1 * np.maximum(sq[:, None] + sq[None, :]
                                 - 2.0 * x.astype(np.float64) @ x.T, 0.0))
    return alpha, (k @ (alpha * y)).astype(np.float32)


def _changed(steps):
    return [tuple(np.nonzero(b != a)[0].tolist())
            for a, b in zip(steps, steps[1:])]


PAIR = {"mvp": dict(), "cache": dict(cache_lines=16),
        "second_order": dict(selection="second_order"),
        "nu": dict(selection="nu", c=1.0),
        "cache-second_order": dict(cache_lines=16,
                                   selection="second_order"),
        "cache-nu": dict(cache_lines=16, selection="nu", c=1.0),
        "cache1": dict(cache_lines=1)}


def _init_of(rule, x, y) -> dict:
    """The nu rule's feasible start (alpha_init / f_init), else none."""
    if PAIR[rule].get("selection") != "nu":
        return {}
    return dict(zip(("alpha_init", "f_init"), _nu_start(x, y)))


@pytest.mark.parametrize("rule", list(PAIR))
def test_pair_mesh_first_pairs_are_jaxs(tiny, rule):
    """ROADMAP C.12 on the mesh: observed after every trip (chunk_iters
    1), the first 20 trips update the same coordinates in both packages,
    and alpha after them agrees within rtol 1e-5."""
    x, y = tiny
    kw = {**BASE, "engine": "xla", "chunk_iters": 1, "max_iter": 20,
          **PAIR[rule]}
    init = _init_of(rule, x, y)
    steps = {}
    for name, fn, cfg, mkw in (
            ("port", solve_mesh, SVMConfig(**kw), dict(mesh=Mesh(["cpu"] * 2))),
            ("jax", jax_solve_mesh, JaxConfig(**kw), dict(num_devices=2))):
        seen = [np.asarray(init.get("alpha_init", np.zeros(len(y))),
                           np.float32)]
        fn(x, y, cfg, callback=lambda it, bh, bl, st: seen.append(
            np.concatenate([np.asarray(a) for a in (
                st.alpha if isinstance(st.alpha, list) else [st.alpha])]
            )[:len(y)]), **mkw, **init)
        steps[name] = seen
    assert len(steps["port"]) == len(steps["jax"]) == 21
    assert _changed(steps["port"]) == _changed(steps["jax"])
    np.testing.assert_allclose(steps["port"][-1], steps["jax"][-1],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("p_dev,rule,kw", [
    (2, "mvp", dict()), (4, "second_order", dict(compensated=True)),
    (4, "cache", dict()), (2, "mvp", dict(dtype="bfloat16")),
    (2, "cache-second_order", dict()), (4, "cache-second_order", dict()),
    (2, "cache-nu", dict()), (4, "cache-nu", dict()),
    (2, "cache1", dict()), (4, "cache1", dict())])
def test_pair_mesh_matches_jax(blobs, p_dev, rule, kw):
    x, y = blobs
    rt, rj = both(x, y, {**BASE, "engine": "xla", **PAIR[rule], **kw}, p_dev,
                  **_init_of(rule, x, y))
    _contract(rt, rj, y)
    assert "outer_rounds" not in rt.stats
    if PAIR[rule].get("cache_lines"):
        assert rt.stats["cache_lookups"] == 2 * rt.iterations
        assert rt.stats["cache_hits"] == int(rj.stats["cache_hits"]) \
            or rt.iterations != rj.iterations
        if rule != "cache1":
            assert rt.stats["cache_hit_rate"] > 0


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def test_pair_mesh_cache_and_single_device(tiny):
    """The cache changes no pair (the JAX test holds the trajectory
    length and alpha); with P shards of n_loc a multiple of 16 the mesh
    retraces the single device's trajectory to the pair (ROADMAP C.26:
    the CPU's GEMV orders the last n mod 16 columns otherwise), cached
    or not: the cached mesh fills its lines with the single device's
    products (kernel cache_fill's plain version), so alpha, f, the pairs
    and the hits are the cached single device's bit for bit."""
    x, y = tiny  # 160 rows: P = 2 gives n_loc 80
    kw = {**BASE, "engine": "xla"}
    r0 = solve_mesh(x, y, SVMConfig(**kw), mesh=Mesh(["cpu"] * 2))
    rc = solve_mesh(x, y, SVMConfig(**kw, cache_lines=32),
                    mesh=Mesh(["cpu"] * 2))
    r1 = solve(x, y, SVMConfig(**kw), device="cpu")
    r1c = solve(x, y, SVMConfig(**kw, cache_lines=32), device="cpu")
    assert r0.iterations == rc.iterations == r1.iterations
    np.testing.assert_allclose(rc.alpha, r0.alpha, atol=1e-5)
    np.testing.assert_array_equal(r0.alpha, r1.alpha)
    assert rc.iterations == r1c.iterations
    assert rc.stats["cache_hits"] == r1c.stats["cache_hits"] > 0
    np.testing.assert_array_equal(_bits(rc.alpha), _bits(r1c.alpha))
    np.testing.assert_array_equal(_bits(rc.stats["f"]),
                                  _bits(r1c.stats["f"]))
    assert rc.b == r1c.b


TRIPS_RULES = ("mvp", "cache", "second_order", "nu", "cache-second_order")


@pytest.mark.parametrize("rule", TRIPS_RULES)
def test_pair_mesh_trips_between_reads_do_not_move_the_result(
        monkeypatch, tiny, rule):
    """The mesh chunk queues smo.TRIPS trips between host reads; a trip
    after the stop is masked and changes nothing, so TRIPS 1, 8 and 256
    give the same alpha, f, pairs, b and hits bit for bit; the trips
    queued past the last pair are fewer than TRIPS, and the host reads
    once a batch plus once at the chunk's end."""
    x, y = tiny
    kw = {**BASE, "engine": "xla", **PAIR[rule]}
    out = {}
    for trips in (1, 8, 256):
        monkeypatch.setattr(tsmo, "TRIPS", trips)
        res = solve_mesh(x, y, SVMConfig(**kw), mesh=Mesh(["cpu"] * 2),
                         **_init_of(rule, x, y))
        st = res.stats
        assert res.converged
        assert res.iterations <= st["trips_queued"] < res.iterations + trips
        assert st["host_reads"] == math.ceil(st["trips_queued"] / trips) + 1
        out[trips] = res
    a = out[1]
    for b in (out[8], out[256]):
        assert b.iterations == a.iterations and b.b == a.b
        assert b.stats["cache_hits"] == a.stats["cache_hits"]
        np.testing.assert_array_equal(_bits(b.alpha), _bits(a.alpha))
        np.testing.assert_array_equal(_bits(b.stats["f"]),
                                      _bits(a.stats["f"]))
    if PAIR[rule].get("cache_lines"):
        assert a.stats["cache_hits"] > 0


@pytest.mark.parametrize("rule", ["cache", "cache-second_order"])
def test_pair_mesh_host_reads_per_chunk(monkeypatch, tiny, rule):
    """A cached mesh solve observed in chunks of 40 pairs at TRIPS = 8:
    every read_obs call (counted by a spy) is a batch's read or the
    chunk's own, host_reads <= ceil(trips / TRIPS) + chunks, the recorder
    sees no other host read and no implicit synchronization, and a chunk
    that ends on the pair budget queues no masked trip."""
    monkeypatch.setattr(tsmo, "TRIPS", 8)
    calls = {"read_obs": 0}
    for mod in (tsmo, tdist):
        def spy(*args, _fn=mod.read_obs, **kw):
            calls["read_obs"] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(mod, "read_obs", spy)
    seen = {}
    run_chunks = tchunks.run_chunks

    def recorded(*args, **kw):
        calls["read_obs"] = 0
        with Recorder() as rec:
            out = run_chunks(*args, **kw)
        seen.update(reads=rec.host_reads, syncs=rec.syncs,
                    spied=calls["read_obs"])
        return out

    monkeypatch.setattr(tchunks, "run_chunks", recorded)
    x, y = tiny
    res = solve_mesh(x, y, SVMConfig(**{**BASE, "engine": "xla",
                                        "chunk_iters": 40, **PAIR[rule]}),
                     mesh=Mesh(["cpu"] * 2),
                     callback=lambda it, b_hi, b_lo, state: None)
    st = res.stats
    assert res.converged and st["chunks"] > 2
    assert st["cache_lookups"] == 2 * res.iterations
    assert seen["spied"] == seen["reads"] == st["host_reads"]
    assert st["host_reads"] <= math.ceil(st["trips_queued"] / 8) + \
        st["chunks"]
    assert seen["syncs"] == 0
    assert st["trips_queued"] - res.iterations < 8


def test_pair_mesh_budget_mode_exact(blobs):
    x, y = blobs
    kw = {**BASE, "engine": "xla", "max_iter": 300, "budget_mode": True}
    rt, rj = both(x, y, kw, 4)
    assert rt.iterations == rj.iterations == 300
    assert abs(float(np.dot(rt.alpha, y))) < 1e-4


# ---- the block runners ----------------------------------------------


BLOCK_CASES = [
    (2, dict(pipeline_rounds=True)),
    (4, dict(pipeline_rounds=True, ring_exchange=True,
             selection="second_order")),
    (4, dict(pipeline_rounds=True, compensated=True)),
    (4, dict(fused_fold=True, working_set_size=8, compensated=True)),
    (4, dict(active_set_size=64, reconcile_rounds=4)),
    (2, dict(active_set_size=128, reconcile_rounds=8, compensated=True)),
]


@pytest.mark.parametrize(
    "p_dev,kw", BLOCK_CASES,
    ids=[f"P{p}-" + "-".join(f"{k}={v}" for k, v in kw.items())
         for p, kw in BLOCK_CASES])
def test_block_runners_match_jax(blobs, p_dev, kw):
    """Each runner against the JAX package's same runner; the fused fold
    against the JAX package's global runner (the optimum, as its own
    tests/test_fused_fold.py holds its fused mesh runner: its fold kernel
    runs interpreted on the CPU, tens of seconds a solve)."""
    x, y = blobs
    cfg = {**BASE, **kw}
    if kw.get("fused_fold"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rt = solve_mesh(x, y, SVMConfig(**cfg),
                            mesh=Mesh(["cpu"] * p_dev))
            rj = jax_solve_mesh(x, y, JaxConfig(**{**cfg,
                                                   "fused_fold": False}),
                                num_devices=p_dev)
    else:
        rt, rj = both(x, y, cfg, p_dev)
    _contract(rt, rj, y)
    st = rt.stats
    assert st["pipelined"] == bool(kw.get("pipeline_rounds"))
    assert st["fused_fold"] == bool(kw.get("fused_fold"))
    assert st.get("active_set_size") == kw.get("active_set_size")
    assert st.get("ring_exchange") == rj.stats.get("ring_exchange")
    assert st["outer_rounds"] > 0


@pytest.mark.parametrize("p_dev", [2, 4])
def test_pipelined_ring_on_equals_ring_off_bitwise(tiny, p_dev):
    """The ring moves the prefetch's bits: same pairs, rounds, alpha and
    f with and without it (kernel B7's plain version on the CPU)."""
    x, y = tiny
    kw = {**BASE, "pipeline_rounds": True}
    off = solve_mesh(x, y, SVMConfig(**kw), mesh=Mesh(["cpu"] * p_dev))
    on = solve_mesh(x, y, SVMConfig(**kw, ring_exchange=True),
                    mesh=Mesh(["cpu"] * p_dev))
    assert on.stats["ring_exchange"] and "ring_exchange" not in off.stats
    assert (on.iterations, on.stats["outer_rounds"]) == (
        off.iterations, off.stats["outer_rounds"])
    np.testing.assert_array_equal(on.alpha, off.alpha)
    np.testing.assert_array_equal(on.stats["f"], off.stats["f"])


@pytest.mark.parametrize("kw", [
    dict(pipeline_rounds=True), dict(fused_fold=True, working_set_size=8),
    dict(active_set_size=64)], ids=["pipelined", "fused", "active"])
def test_block_runners_budget_cap_exact(blobs, kw):
    """max_iter exactly: budget_mode on the pipelined and fused runners
    (the fused one held within the port: the JAX package's interpreted
    fold kernel is slow on the CPU), the active runner's plain cap
    against the JAX package's with the refreshed extrema on its exit."""
    from dpsvm_tpu_torch.ops.select import extrema_np

    x, y = blobs
    cfg = {**BASE, **kw, "max_iter": 37}
    if not kw.get("active_set_size"):
        cfg.update(budget_mode=True, inner_iters=8)
    if kw.get("fused_fold"):
        rt = solve_mesh(x, y, SVMConfig(**cfg), mesh=Mesh(["cpu"] * 4))
        assert rt.iterations == 37 and rt.stats["fused_fold"]
        return
    rt, rj = both(x, y, cfg, 4)
    assert rt.iterations == rj.iterations == 37
    assert not rt.converged
    if kw.get("active_set_size"):
        b_hi, b_lo = extrema_np(rt.stats["f"], rt.alpha, y, BASE["c"])
        assert rt.b_hi == b_hi and rt.b_lo == b_lo


def test_active_mesh_device_counts_and_single_device(blobs):
    """The same optimum on 1, 2 and 4 shards and on one device (the JAX
    test's solution-level pin)."""
    x, y = blobs
    cfg = SVMConfig(**BASE, active_set_size=128, reconcile_rounds=4)
    runs = [solve_mesh(x, y, cfg, mesh=Mesh(["cpu"] * p)) for p in (1, 2, 4)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        runs.append(solve(x, y, cfg, device="cpu"))
    for r in runs[1:]:
        assert r.converged
        assert abs(_dual(r, y) - _dual(runs[0], y)) <= 1e-3 * abs(
            _dual(runs[0], y))
        assert abs(r.b - runs[0].b) < 5e-3


# ---- the model families on the mesh -------------------------------


@pytest.mark.parametrize("engine", ["block", "xla"])
def test_families_on_the_mesh_match_jax(tiny, engine):
    """train_svr (alpha_init / f_init on the mesh), train_nusvr (the nu
    rule) and train_oneclass on Mesh(["cpu"] * 2) against the JAX
    package's mesh runs: predictions within 5e-3 of each other (the
    JAX tests' tolerance), converged."""
    x, y = tiny
    z = np.sin(x[:, 0]).astype(np.float32)
    kw = dict(c=1.0, gamma=0.1, epsilon=1e-3, engine=engine,
              working_set_size=16)
    mesh = Mesh(["cpu"] * 2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        runs = [
            (train_svr(x, z, SVMConfig(**kw), svr_epsilon=0.1,
                       backend="mesh", mesh=mesh),
             jsvr.train_svr(x, z, JaxConfig(**kw), svr_epsilon=0.1,
                            backend="mesh", num_devices=2)),
            (tnusvm.train_nusvr(x, z, nu=0.4, config=SVMConfig(**kw),
                                backend="mesh", mesh=mesh),
             jnusvm.train_nusvr(x, z, nu=0.4, config=JaxConfig(**kw),
                                backend="mesh", num_devices=2)),
            (train_oneclass(x, nu=0.2, config=SVMConfig(**kw),
                            backend="mesh", mesh=mesh),
             jax_oneclass(x, nu=0.2, config=JaxConfig(**kw),
                          backend="mesh", num_devices=2)),
        ]
    for (mt, rt), (mj, rj) in runs:
        assert rt.converged and rj.converged
        assert rt.stats["mesh_devices"] == ["cpu", "cpu"]
        if hasattr(mt, "decision_function"):  # one-class: the decisions
            np.testing.assert_allclose(
                mt.decision_function(x, device="cpu"),
                mj.decision_function(x), atol=5e-3)
        else:
            np.testing.assert_allclose(mt.predict(x, device="cpu"),
                                       mj.predict(x), atol=5e-3)
