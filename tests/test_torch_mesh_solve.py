"""Whole solves of the port's mesh block engines
(dpsvm_tpu_torch/parallel/dist_smo.py solve_mesh) against the JAX
package's solve_mesh with the same knobs on its forced host devices.

The whole-solve contract of tests/test_torch_solve.py (both converge, dual
objective within rel 1e-4, SV count within 2%, |b - b_jax| <= 5e-3): the
packages sum the fold's matmuls in other orders, so trajectories part.
Pinned exactly: within the port the ring exchange changes nothing (ring on
== ring off, bitwise); from the same mid-solve state both packages'
global rounds choose the same working set (the same extrema, bit for
bit) for three rounds; the shard-local engine reports its demotion and
converges; the knobs the mesh does not run raise."""

import contextlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpsvm_tpu.config import SVMConfig as JaxConfig
from dpsvm_tpu.ops.kernels import KernelParams as JaxKP
from dpsvm_tpu.ops.kernels import kernel_diag as jax_kernel_diag
from dpsvm_tpu.ops.kernels import squared_norms as jax_squared_norms
from dpsvm_tpu.parallel import dist_block as jdb
from dpsvm_tpu.parallel import mesh as jmesh
from dpsvm_tpu.parallel.dist_smo import solve_mesh as jax_solve_mesh
from dpsvm_tpu.solver.block import BlockState as JaxBlockState
from dpsvm_tpu_torch import (Mesh, SVMConfig, SVMModel, accuracy, cli, convert,
                             solve, solve_mesh, train)
from dpsvm_tpu_torch.ops.kernels import (KernelParams, kernel_diag,
                                         squared_norms)
from dpsvm_tpu_torch.ops.select import extrema_np
from dpsvm_tpu_torch.parallel import dist_block as tdb
from dpsvm_tpu_torch.parallel.mesh import pad_rows

BASE = dict(c=5.0, gamma=0.1, epsilon=1e-3, max_iter=200_000,
            engine="block", working_set_size=16)


@contextlib.contextmanager
def _no_warning():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        yield


def _dual_obj(res, y):
    a = np.asarray(res.alpha, np.float64)
    f = np.asarray(res.stats["f"], np.float64)
    return float(a.sum() - 0.5 * np.sum(a * y * (f + y)))


def _assert_same_optimum(rt, rj, y, c, eps=1e-3):
    """The whole-solve contract; the block engines' final state also
    meets the stopping rule (a per-pair run ends with the update of the
    trip that saw it met, as on one device: eps=None skips the test)."""
    assert rj.converged and rt.converged
    obj_j, obj_t = _dual_obj(rj, y), _dual_obj(rt, y)
    assert abs(obj_t - obj_j) <= 1e-4 * abs(obj_j), (obj_t, obj_j)
    assert abs(rt.n_sv - rj.n_sv) <= 0.02 * rj.n_sv, (rt.n_sv, rj.n_sv)
    assert abs(rt.b - rj.b) <= 5e-3, (rt.b, rj.b)
    if eps is not None:
        b_hi, b_lo = extrema_np(rt.stats["f"], rt.alpha, y, c)
        assert b_lo <= b_hi + 2 * eps + 1e-6
    assert rt.alpha.shape == y.shape


@pytest.fixture(scope="module")
def uneven():
    """301 rows: every mesh size pads (P = 4: 304 rows, three masked)."""
    from dpsvm_tpu.data.synth import make_blobs_binary
    return make_blobs_binary(n=301, d=10, seed=3, sep=1.2)


@pytest.fixture(scope="module")
def tiny():
    """160 rows: the port-only pins, where the optimum is not the point."""
    from dpsvm_tpu.data.synth import make_blobs_binary
    return make_blobs_binary(n=160, d=8, seed=5, sep=1.5)


SOLVE_CASES = [
    (2, dict()),
    (4, dict(ring_exchange=True, selection="second_order", compensated=True)),
    (4, dict(pair_batch=2)),
    (2, dict(local_working_sets=2)),
    (4, dict(local_working_sets=4, sync_rounds=2, ring_exchange=True,
             selection="second_order", compensated=True)),
    (4, dict(dtype="bfloat16", ring_exchange=True, weight_pos=2.0,
             weight_neg=0.5)),
]


@pytest.mark.parametrize(
    "p_dev,kw", SOLVE_CASES,
    ids=[f"P{p}-" + ("-".join(f"{k}={v}" for k, v in kw.items()) or "global")
         for p, kw in SOLVE_CASES])
def test_solve_mesh_matches_jax_same_knobs(uneven, p_dev, kw):
    x, y = uneven
    cfg = {**BASE, **kw}
    rj = jax_solve_mesh(x, y, JaxConfig(**cfg), num_devices=p_dev)
    rt = solve_mesh(x, y, SVMConfig(**cfg), mesh=Mesh(["cpu"] * p_dev))
    _assert_same_optimum(rt, rj, y, SVMConfig(**cfg).c_bounds())
    assert rt.stats["mesh_devices"] == ["cpu"] * p_dev
    for key in ("num_devices", "rows_padded"):
        assert rt.stats[key] == rj.stats[key]
    assert rt.stats["n_pad"] == pad_rows(len(y), p_dev) > len(y)
    assert rt.stats.get("ring_exchange") == rj.stats.get("ring_exchange")
    assert ("shardlocal_demoted" in rt.stats) \
        == ("shardlocal_demoted" in rj.stats)
    assert rt.stats["outer_rounds"] > 0


RING_CASES = [
    (2, dict()), (4, dict()), (8, dict(working_set_size=8)),
    (4, dict(selection="second_order", compensated=True)),
    (4, dict(pair_batch=4)),
    (2, dict(local_working_sets=2, sync_rounds=2)),
    (4, dict(local_working_sets=2)),
    (4, dict(local_working_sets=2, sync_rounds=3, compensated=True)),
    (8, dict(local_working_sets=2, sync_rounds=2, dtype="bfloat16")),
]


@pytest.mark.parametrize(
    "p_dev,kw", RING_CASES,
    ids=[f"P{p}-" + ("-".join(f"{k}={v}" for k, v in kw.items()) or "global")
         for p, kw in RING_CASES])
def test_ring_on_equals_ring_off_bitwise(tiny, p_dev, kw):
    """The ring moves bits and folds in the all_gather sync's order: same
    pairs, rounds, alpha, f and extrema, the demotion point included."""
    x, y = tiny
    mesh = Mesh(["cpu"] * p_dev)
    cfg = SVMConfig(**{**BASE, "epsilon": 1e-2, **kw})
    r0 = solve_mesh(x, y, cfg.replace(ring_exchange=False), mesh=mesh)
    r1 = solve_mesh(x, y, cfg.replace(ring_exchange=True), mesh=mesh)
    assert r0.converged and r1.converged
    assert r1.iterations == r0.iterations
    assert r1.stats["outer_rounds"] == r0.stats["outer_rounds"]
    np.testing.assert_array_equal(r1.alpha.view(np.uint32),
                                  r0.alpha.view(np.uint32))
    np.testing.assert_array_equal(r1.stats["f"].view(np.uint32),
                                  r0.stats["f"].view(np.uint32))
    assert (r1.b_hi, r1.b_lo) == (r0.b_hi, r0.b_lo)
    assert r1.stats["ring_exchange"] is True
    assert "ring_exchange" not in r0.stats
    assert r1.stats.get("shardlocal_demotion") \
        == r0.stats.get("shardlocal_demotion")


@pytest.mark.parametrize("p_dev,ring", [(2, False), (4, True)])
def test_global_rounds_choose_jaxs_working_sets(blobs_small, p_dev, ring):
    """Three JAX rounds from the start give a mid-solve state; from it
    (carried across by convert.shard_state) both packages run three more
    rounds, one at a time. Each round's extrema, read from its selection,
    are the same bits, the rows it updated are the same, and alpha and f
    stay within rounding."""
    x, y = blobs_small
    q, inner, c, eps, tau = 16, 32, (5.0, 5.0), 1e-3, 1e-12
    n = len(y)
    n_pad = pad_rows(n, p_dev)
    xp = np.zeros((n_pad, x.shape[1]), np.float32)
    xp[:n] = x
    yp = np.ones(n_pad, np.float32)
    yp[:n] = y
    valid = np.arange(n_pad) < n
    jkp = JaxKP("rbf", 0.1)
    jrun = jdb.make_block_chunk_runner(
        jmesh.make_data_mesh(p_dev), jkp, c, eps, tau, q, inner, 1,
        inner_impl="xla", interpret=True, ring_exchange=ring)
    jx = jnp.asarray(xp)
    jxsq = jax_squared_norms(jx)
    jargs = (jx, jnp.asarray(yp), jxsq, jax_kernel_diag(jxsq, params=jkp),
             jnp.asarray(valid))
    jst = JaxBlockState(jnp.zeros(n_pad, jnp.float32), jnp.asarray(-yp),
                        jnp.float32(-jnp.inf), jnp.float32(jnp.inf),
                        jnp.int32(0), jnp.int32(0), None)
    for _ in range(3):
        jst = jrun(*jargs, jst, jnp.int32(10 ** 6))
    assert int(jst.pairs) > 0

    mesh = Mesh(["cpu"] * p_dev)
    kp = KernelParams("rbf", 0.1)
    trun = tdb.make_block_chunk_runner(mesh, kp, c, eps, tau, q, inner, 1,
                                       ring_exchange=ring)
    n_loc = n_pad // p_dev
    cut = lambda a: [torch.tensor(a[r * n_loc:(r + 1) * n_loc])
                     for r in range(p_dev)]
    x_s = cut(xp)
    xsq_s = [squared_norms(t) for t in x_s]
    targs = (x_s, cut(yp), xsq_s, [kernel_diag(s, kp) for s in xsq_s],
             cut(valid))
    a_s, f_s, _ = convert.shard_state(jst.alpha, jst.f, None, mesh)
    tst = tdb.MeshBlockState(
        a_s, f_s, [torch.tensor(float(jst.b_hi))],
        [torch.tensor(float(jst.b_lo))],
        [torch.tensor(int(jst.pairs), dtype=torch.int32)],
        [torch.tensor(3, dtype=torch.int32)])
    for _ in range(3):
        a_before = np.asarray(jst.alpha)
        jst = jrun(*jargs, jst, jnp.int32(10 ** 6))
        tst = trun(*targs, tst, 10 ** 6)
        ta, tf, _ = convert.unshard_state(tst.alpha, tst.f)
        assert np.float32(tst.b_hi[0]).tobytes() \
            == np.float32(jst.b_hi).tobytes()
        assert np.float32(tst.b_lo[0]).tobytes() \
            == np.float32(jst.b_lo).tobytes()
        assert int(tst.pairs[0]) == int(jst.pairs)
        moved_j = np.nonzero(np.asarray(jst.alpha) != a_before)[0]
        moved_t = np.nonzero(ta != a_before)[0]
        assert len(moved_j) > 0
        np.testing.assert_array_equal(moved_t, moved_j)
        np.testing.assert_allclose(ta, np.asarray(jst.alpha), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(tf, np.asarray(jst.f), rtol=1e-5,
                                   atol=1e-5)
        # Carry JAX's state across again, so a last-bit difference in one
        # fold does not decide the next round's ties.
        a_s, f_s, _ = convert.shard_state(jst.alpha, jst.f, None, mesh)
        tst = tst._replace(alpha=a_s, f=f_s)
    assert int(tst.rounds[0]) == int(jst.rounds) == 6


def test_mesh_of_one_shard_is_the_single_device_engine(tiny):
    """P = 1: no exchange, no padding beyond the multiple of 8; the global
    runner's optimum is the single-device block engine's."""
    x, y = tiny
    cfg = SVMConfig(**BASE)
    r1 = solve_mesh(x, y, cfg, mesh=Mesh(["cpu"]))
    rs = solve(x, y, cfg, device="cpu")
    _assert_same_optimum(r1, rs, y, cfg.c_bounds())
    # ring_exchange has no hops on one shard: the plain exchange runs.
    r1r = solve_mesh(x, y, cfg.replace(ring_exchange=True),
                     mesh=Mesh(["cpu"]))
    assert "ring_exchange" not in r1r.stats
    np.testing.assert_array_equal(r1r.alpha, r1.alpha)


def test_shardlocal_demotion_is_reported_and_converges(blobs_small):
    x, y = blobs_small
    cfg = SVMConfig(**{**BASE, "local_working_sets": 2, "sync_rounds": 2})
    res = solve_mesh(x, y, cfg, mesh=Mesh(["cpu"] * 4))
    st = res.stats
    assert res.converged and st["shardlocal_demoted"] is True
    dem = st["shardlocal_demotion"]
    assert 0 < dem["pairs"] <= res.iterations
    assert dem["rounds"] % 2 == 0 and dem["rounds"] < st["outer_rounds"]
    assert dem["stalled"] or dem["gap"] <= 10 * cfg.epsilon
    assert st["shardlocal_syncs"] == dem["rounds"] // 2
    # lws=1 is the global runner: no shard-local stats at all.
    r1 = solve_mesh(x, y, cfg.replace(local_working_sets=1, sync_rounds=1),
                    mesh=Mesh(["cpu"] * 4))
    assert "shardlocal_demoted" not in r1.stats and r1.converged


def test_budget_mode_runs_exact_pairs_on_the_mesh(blobs_small):
    x, y = blobs_small
    cfg = {**BASE, "budget_mode": True, "max_iter": 500, "inner_iters": 24}
    rj = jax_solve_mesh(x, y, JaxConfig(**cfg), num_devices=2)
    rt = solve_mesh(x, y, SVMConfig(**cfg), mesh=Mesh(["cpu"] * 2))
    assert rt.iterations == rj.iterations == 500
    assert rt.converged == rj.converged
    b_hi, b_lo = extrema_np(rt.stats["f"], rt.alpha, y, 5.0)
    assert (rt.b_hi, rt.b_lo) == (b_hi, b_lo)


@pytest.mark.parametrize("kw", [
    dict(engine="xla"), dict(pipeline_rounds=True), dict(fused_fold=True),
    dict(fused_round=True), dict(active_set_size=64), dict(ooc=True)])
def test_unported_mesh_knobs_name_their_roadmap_item(blobs_small, kw):
    """The mesh knobs the port once refused run, each within the
    whole-solve contract of the JAX package's mesh solve with the same
    knobs: the per-pair engine, the pipelined, fused-fold and active
    runners, and fused_round=True, which warns in both packages and
    keeps the mesh's own runner (here the fused fold, asked with it).
    ooc=True on the mesh still names item 10b."""
    x, y = blobs_small
    if kw.get("ooc"):
        cfg = SVMConfig(**{**BASE, **kw})
        with pytest.raises(NotImplementedError, match="item 10b"):
            solve_mesh(x, y, cfg, mesh=Mesh(["cpu"] * 2))
        with pytest.raises(NotImplementedError, match="item 10b"):
            train(x, y, cfg, backend="mesh", mesh=Mesh(["cpu"] * 2))
        return
    if kw.get("fused_round"):
        kw = {**kw, "fused_fold": True}
    cfg = {**BASE, **kw}
    if cfg.get("fused_fold"):
        cfg["working_set_size"] = 8  # q/2 <= n_loc/128 at n_loc 1024
    with pytest.warns(UserWarning) if kw.get("fused_round") else \
            _no_warning():
        rt = solve_mesh(x, y, SVMConfig(**cfg), mesh=Mesh(["cpu"] * 2))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rj = jax_solve_mesh(x, y, JaxConfig(**cfg), num_devices=2)
    _assert_same_optimum(rt, rj, y, SVMConfig(**cfg).c_bounds(),
                         1e-3 if cfg["engine"] == "block" else None)
    st = rt.stats
    if cfg["engine"] == "block":
        assert st["pipelined"] == bool(cfg.get("pipeline_rounds"))
        assert st["fused_fold"] == bool(cfg.get("fused_fold"))
        assert st.get("active_set_size") == cfg.get("active_set_size")
        assert st["n_pad"] == pad_rows(len(y), 2, 1024 if st["fused_fold"]
                                       else 8)
    else:
        assert "outer_rounds" not in st and st["cache_lookups"] == 0
    _, res = train(x, y, SVMConfig(**cfg), backend="mesh",
                   mesh=Mesh(["cpu"] * 2))
    np.testing.assert_array_equal(res.alpha, rt.alpha)


def test_mesh_refusals(blobs_small, monkeypatch):
    x, y = blobs_small
    with pytest.raises(ValueError, match="single-chip solver only"):
        solve_mesh(x, y, SVMConfig(engine="pallas"), mesh=Mesh(["cpu"] * 2))
    # The nu rule without the nu trainers' seed: the JAX package's
    # ValueError, in both packages.
    for fn, kw in ((solve_mesh, dict(mesh=Mesh(["cpu"] * 2))),
                   (jax_solve_mesh, dict(num_devices=2))):
        cfg_cls = SVMConfig if fn is solve_mesh else JaxConfig
        with pytest.raises(ValueError, match="internal to the nu duals"):
            fn(x, y, cfg_cls(**{**BASE, "selection": "nu"}), **kw)
    # The host backends are ported; like the JAX package's they run the
    # per-pair mvp engine only.
    with pytest.raises(ValueError, match="fixed host engine"):
        train(x, y, SVMConfig(**BASE), backend="native", device="cpu")
    # No mesh given and no card: raise, never the CPU by itself.
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_mesh(x, y, SVMConfig(**BASE))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(x, y, SVMConfig(**BASE), backend="mesh")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_mesh(x, y, SVMConfig(**BASE),
                   mesh=Mesh([torch.device("cuda", 0)] * 2))
    # The runners' own factory-time guards.
    kp = KernelParams("rbf", 0.1)
    with pytest.raises(ValueError, match=">= 2 devices"):
        tdb.make_block_chunk_runner(Mesh(["cpu"]), kp, 1.0, 1e-3, 1e-12, 16,
                                    32, ring_exchange=True)
    with pytest.raises(ValueError, match="feature kernels"):
        tdb.make_block_shardlocal_chunk_runner(
            Mesh(["cpu"] * 2), KernelParams("precomputed"), 1.0, 1e-3, 1e-12,
            16, 32, 4)
    with pytest.raises(ValueError, match="selection"):
        tdb.make_block_shardlocal_chunk_runner(
            Mesh(["cpu"] * 2), kp, 1.0, 1e-3, 1e-12, 16, 32, 4,
            selection="nu")


def test_train_and_auto_backend_reach_the_mesh(tiny, monkeypatch):
    x, y = tiny
    cfg = SVMConfig(**{**BASE, "epsilon": 1e-2})
    mesh = Mesh(["cpu"] * 2)
    model, res = train(x, y, cfg, backend="mesh", mesh=mesh)
    assert isinstance(model, SVMModel) and res.converged
    assert res.stats["mesh_devices"] == ["cpu", "cpu"]
    assert accuracy(model, x, y, device="cpu") > 0.85
    # auto: the mesh when one is given (or several cards are visible) and
    # the engine is the block engine; the single device otherwise.
    _, ra = train(x, y, cfg, backend="auto", mesh=mesh)
    assert ra.stats["mesh_devices"] == ["cpu", "cpu"]
    np.testing.assert_array_equal(ra.alpha, res.alpha)
    _, rs = train(x, y, cfg, backend="auto", device="cpu")
    assert "mesh_devices" not in rs.stats
    # The per-pair engine runs on the mesh too: auto takes it there.
    _, rx = train(x, y, cfg.replace(engine="xla"), backend="auto", mesh=mesh,
                  device="cpu")
    assert rx.stats["mesh_devices"] == ["cpu", "cpu"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(x, y, cfg, backend="auto")  # four cards "visible": the mesh
    _, rd = train(x, y, cfg, backend="auto", device="cpu")  # a named device
    assert "mesh_devices" not in rd.stats


def test_cli_mesh_flags_reach_the_engines(tmp_path, capsys, monkeypatch):
    from dpsvm_tpu_torch.data.loader import save_csv
    from dpsvm_tpu_torch.data.synth import make_blobs_binary

    x, y = make_blobs_binary(n=240, d=8, seed=5, sep=2.0)
    train_p = str(tmp_path / "train.csv")
    save_csv(train_p, x, y)
    common = ["train", "-f", train_p, "-c", "5", "-g", "0.1", "--engine",
              "block", "--working-set-size", "16", "--backend", "mesh",
              "--num-devices", "2", "--device", "cpu"]
    assert cli.main(common + ["-m", str(tmp_path / "m1.txt"),
                              "--ring-exchange", "on"]) == 0
    out1 = capsys.readouterr().out
    assert "['cpu', 'cpu']" in out1 and "converged" in out1
    assert cli.main(common + ["-m", str(tmp_path / "m2.txt"),
                              "--local-working-sets", "2", "--sync-rounds",
                              "2", "--ring-exchange", "off"]) == 0
    m1 = SVMModel.load(str(tmp_path / "m1.txt"))
    m2 = SVMModel.load(str(tmp_path / "m2.txt"))
    assert abs(m1.b - m2.b) < 5e-3 and abs(m1.n_sv - m2.n_sv) <= 2
    # sync_rounds without the shard-local engine, and a knob the mesh
    # does not run (the out-of-core stream): both refused with a
    # message, exit code 2. The pipelined runner trains.
    assert cli.main(common + ["-m", str(tmp_path / "m3.txt"),
                              "--sync-rounds", "2"]) == 2
    assert cli.main(common + ["-m", str(tmp_path / "m3.txt"), "--ooc"]) == 2
    err = capsys.readouterr().err
    assert "local_working_sets >= 2" in err and "item 10b" in err
    assert cli.main(common + ["-m", str(tmp_path / "m4.txt"),
                              "--pipeline-rounds", "on"]) == 0
    m4 = SVMModel.load(str(tmp_path / "m4.txt"))
    assert abs(m1.b - m4.b) < 5e-3 and abs(m1.n_sv - m4.n_sv) <= 2
    # More shards than cards and no --device: a message, not a traceback.
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert cli.main(common[:-2] + ["-m", str(tmp_path / "m3.txt")]) == 2
    err = capsys.readouterr().err
    assert "only 1 visible" in err and "--device cuda:0" in err


def test_train_defaults_to_auto_and_one_card_is_single(tiny, monkeypatch):
    """Fault C.20: train() defaults to backend="auto", as the JAX
    package's does; auto resolves to the single device on a one-card
    host (and on the CPU), takes the mesh on two cards only for the
    block engine, and never for a warm start."""
    import inspect

    from dpsvm_tpu.train import train as jax_train
    from dpsvm_tpu_torch.train import resolve_backend

    default = inspect.signature(train).parameters["backend"].default
    assert default == "auto" == \
        inspect.signature(jax_train).parameters["backend"].default
    block = SVMConfig(**BASE)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert resolve_backend("auto", block) == "single"
    assert resolve_backend("auto", block, device="cpu") == "single"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert resolve_backend("auto", block) == "mesh"
    assert resolve_backend("auto", block, device="cuda:0") == "single"
    # As the JAX package's auto: the per-pair engine and the families'
    # warm starts take the mesh too (the families whatever the engine);
    # only the out-of-core stream stays on one device (item 10b).
    assert resolve_backend("auto", block.replace(engine="xla")) == "mesh"
    assert resolve_backend("auto", block, warm=True) == "mesh"
    assert resolve_backend("auto", block.replace(engine="pallas")) == "single"
    assert resolve_backend("auto", block.replace(engine="pallas"),
                           warm=True) == "mesh"
    assert resolve_backend("auto", block.replace(ooc=True)) == "single"
    assert resolve_backend("mesh", block, warm=True) == "mesh"
    x, y = tiny
    model, res = train(x, y, SVMConfig(**{**BASE, "epsilon": 1e-2}),
                       device="cpu")
    assert res.converged and "mesh_devices" not in res.stats
