"""The port's fused block engines (fused fold, fused round, pipelined)
against the JAX package's engines under the same knob, on the CPU.

Whole solves are held to the contract of tests/test_torch_solve.py
(both converge, dual objective within rel 1e-4, SV count within 2%,
|b - b_jax| <= 5e-3): the packages sum the fold's matmuls in other
orders, so trajectories part. Within the port, the plain fused round
equals the plain fused fold bit for bit (the JAX package's own pin
between its engines)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpsvm_tpu.config import SVMConfig as JaxConfig
from dpsvm_tpu.ops.kernels import KernelParams as JaxKP
from dpsvm_tpu.ops.kernels import kernel_diag as jax_kernel_diag
from dpsvm_tpu.ops.kernels import squared_norms as jax_squared_norms
from dpsvm_tpu.solver import block as jblock
from dpsvm_tpu.solver.smo import solve as jax_solve
from dpsvm_tpu_torch import SVMConfig, cli, solve
from dpsvm_tpu_torch.ops import fold_select as tfs
from dpsvm_tpu_torch.ops.kernels import KernelParams, kernel_diag
from dpsvm_tpu_torch.ops.select import extrema_np
from dpsvm_tpu_torch.solver import block as tblock
from dpsvm_tpu_torch.solver.solve import choose_engine

BASE = dict(c=1.0, gamma=0.1, engine="block")


def _dual_obj(res, y):
    a = np.asarray(res.alpha, np.float64)
    f = np.asarray(res.stats["f"], np.float64)
    return float(a.sum() - 0.5 * np.sum(a * y * (f + y)))


def _assert_same_optimum(rt, rj, y, c=1.0, eps=1e-3):
    assert rj.converged and rt.converged
    obj_j, obj_t = _dual_obj(rj, y), _dual_obj(rt, y)
    assert abs(obj_t - obj_j) <= 1e-4 * abs(obj_j), (obj_t, obj_j)
    assert abs(rt.n_sv - rj.n_sv) <= 0.02 * rj.n_sv, (rt.n_sv, rj.n_sv)
    assert abs(rt.b - rj.b) <= 5e-3, (rt.b, rj.b)
    b_hi, b_lo = extrema_np(rt.stats["f"], rt.alpha, y, c)
    assert b_lo <= b_hi + 2 * eps + 1e-6
    assert rt.alpha.shape == y.shape


@pytest.fixture
def data(request, blobs_small, blobs_medium):
    """blobs_small (n = 300: one 1024-row tile) or blobs_medium (n =
    1200: two tiles), by the test's `size` parameter."""
    return blobs_small if request.param == "small" else blobs_medium


KNOB_CASES = [
    ("small", dict(selection="mvp")),
    ("small", dict(selection="second_order")),
    ("small", dict(selection="mvp", compensated=True)),
    ("small", dict(selection="second_order", weight_pos=2.0,
                   weight_neg=0.5)),
    ("medium", dict(selection="mvp")),
    ("medium", dict(selection="second_order", compensated=True,
                    weight_pos=2.0, weight_neg=0.5)),
]


@pytest.mark.parametrize("knob", ["fused_fold", "fused_round",
                                  "pipeline_rounds"])
@pytest.mark.parametrize(
    "data,kw", KNOB_CASES, indirect=["data"],
    ids=[f"{size}-" + "-".join(f"{k}={v}" for k, v in kw.items())
         for size, kw in KNOB_CASES])
def test_solve_matches_jax_same_knob(data, knob, kw):
    x, y = data
    cfg = {**BASE, "working_set_size": 16 if len(y) < 1000 else 32,
           knob: True, **kw}
    rj = jax_solve(x, y, JaxConfig(**cfg))
    rt = solve(x, y, SVMConfig(**cfg), device="cpu")
    stat = "pipelined" if knob == "pipeline_rounds" else knob
    assert rt.stats[stat] and rt.stats["outer_rounds"] > 0
    assert sum(rt.stats[k] for k in ("fused_fold", "fused_round",
                                     "pipelined")) == 1
    _assert_same_optimum(rt, rj, y, c=SVMConfig(**cfg).c_bounds())


@pytest.mark.parametrize("pair_batch,kw", [
    (2, dict()), (4, dict()), (2, dict(fused_fold=True)),
    (2, dict(pipeline_rounds=True, compensated=True))])
def test_block_pair_batch_solve_matches_jax(blobs_small, pair_batch, kw):
    """The block subproblem's pair batch (stale-ranked extra pairs a
    trip) on whole solves: the JAX engine's optimum with the same knobs,
    and a pair count near its own (attempted slots count in both; the
    trajectories part as every block solve's do, so 1184 pairs in JAX
    stand against 1316 here at pair_batch=4)."""
    x, y = blobs_small
    cfg = {**BASE, "working_set_size": 16, "pair_batch": pair_batch, **kw}
    rj = jax_solve(x, y, JaxConfig(**cfg))
    rt = solve(x, y, SVMConfig(**cfg), device="cpu")
    _assert_same_optimum(rt, rj, y)
    assert abs(rt.iterations - rj.iterations) <= 0.25 * rj.iterations


@pytest.mark.parametrize("compensated", [False, True])
def test_pipelined_select_makes_the_float_valid_once(blobs_small,
                                                     monkeypatch,
                                                     compensated):
    """The pipelined engine's candidate selection (pallas_select=True)
    converts `valid` to float32 once per chunk and hands that one tensor
    to every select_rows call. Its result is bitwise the one of a chunk
    whose every select_rows call gets a float32 `valid` made afresh;
    test_pipelined_pallas_select_chunk_matches_jax holds the same chunk
    against the JAX package. A prefetch
    asked for the candidate kernel without the float views raises."""
    x, y = blobs_small
    xp, yp, valid = _padded_problem(x, y, 1024, 0.1)
    tkp = KernelParams("rbf", 0.1)
    tx, ty, tv = map(torch.as_tensor, (xp, yp, valid))
    tsq = (tx * tx).sum(dim=1)
    tkd = kernel_diag(tsq, tkp)
    zt = torch.zeros((), dtype=torch.int32)
    seen = []
    real = tblock.select_rows

    def spy(f2d, alpha2d, y2d, valid2d, c):
        seen.append(valid2d)
        return real(f2d, alpha2d, y2d, valid2d, c)

    def fresh(f2d, alpha2d, y2d, valid2d, c):
        made = tv.float().view(-1, 128)
        seen.append(made)
        return real(f2d, alpha2d, y2d, made, c)

    def chunk():
        st = tblock.BlockState(torch.zeros(1024), -ty,
                               torch.tensor(-np.inf), torch.tensor(np.inf),
                               zt, zt,
                               torch.zeros(1024) if compensated else None)
        return tblock.run_chunk_block_pipelined(
            tx, ty, tsq, tkd, tv, st, 100_000, tkp, 1.0, 1e-3, 1e-12, 16,
            32, pallas_select=True)

    monkeypatch.setattr(tblock, "select_rows", spy)
    once = chunk()
    assert int(once.rounds) > 1
    assert len(seen) == int(once.rounds) + 1
    assert all(v is seen[0] for v in seen)
    assert seen[0].dtype == torch.float32 and seen[0].shape == (8, 128)
    monkeypatch.setattr(tblock, "select_rows", fresh)
    seen.clear()
    every = chunk()
    assert len({id(v) for v in seen}) == len(seen) == int(every.rounds) + 1
    for a, b in zip(once, every):
        if a is None:
            assert b is None
            continue
        np.testing.assert_array_equal(
            np.atleast_1d(np.asarray(a)).view(np.uint8),
            np.atleast_1d(np.asarray(b)).view(np.uint8))
    with pytest.raises(ValueError, match="valid2d"):
        tblock.prefetch_working_set(tx, ty, tsq, tkd, -ty,
                                    torch.zeros(1024), tv, tkp, 1.0, 16,
                                    "mvp", pallas_select=True)


@pytest.mark.parametrize("knob", ["fused_fold", "fused_round"])
def test_budget_mode_runs_exact_pairs(blobs_medium, knob):
    x, y = blobs_medium
    cfg = {**BASE, "working_set_size": 32, knob: True, "budget_mode": True,
           "max_iter": 1000, "inner_iters": 50}
    rj = jax_solve(x, y, JaxConfig(**cfg))
    rt = solve(x, y, SVMConfig(**cfg), device="cpu")
    assert rt.iterations == rj.iterations == 1000
    assert rt.converged == rj.converged
    b_hi, b_lo = extrema_np(rt.stats["f"], rt.alpha, y, 1.0)
    assert (rt.b_hi, rt.b_lo) == (b_hi, b_lo)


@pytest.mark.parametrize("data,selection,compensated", [
    ("small", "mvp", False), ("small", "mvp", True),
    ("small", "second_order", False), ("small", "second_order", True),
    ("medium", "mvp", False), ("medium", "second_order", True),
], indirect=["data"])
def test_fused_round_equals_fused_fold_bitwise(data, selection,
                                               compensated):
    """The port's own pin: on the CPU both engines run the same plain
    stages (x[w], kernel_rows, coef @ K, fold_select), so their whole
    trajectories agree bit for bit."""
    x, y = data
    cfg = SVMConfig(**BASE, working_set_size=16 if len(y) < 1000 else 32,
                    selection=selection, compensated=compensated)
    rf = solve(x, y, cfg.replace(fused_fold=True), device="cpu")
    rr = solve(x, y, cfg.replace(fused_round=True), device="cpu")
    assert rf.stats["fused_fold"] and rr.stats["fused_round"]
    assert rr.iterations == rf.iterations
    assert rr.stats["outer_rounds"] == rf.stats["outer_rounds"]
    np.testing.assert_array_equal(rr.alpha.view(np.uint32),
                                  rf.alpha.view(np.uint32))
    np.testing.assert_array_equal(rr.stats["f"].view(np.uint32),
                                  rf.stats["f"].view(np.uint32))
    assert (rr.b_hi, rr.b_lo) == (rf.b_hi, rf.b_lo)


def _padded_problem(x, y, n_pad, gamma):
    n, d = x.shape
    xp = np.zeros((n_pad, d), np.float32)
    xp[:n] = x
    yp = np.ones(n_pad, np.float32)
    yp[:n] = y
    valid = np.zeros(n_pad, bool)
    valid[:n] = True
    return xp, yp, valid


def test_pipelined_pallas_select_chunk_matches_jax(blobs_small):
    """run_chunk_block_pipelined(pallas_select=True) against the JAX
    package's _run_chunk_block_pipelined(pallas_select=True,
    interpret=True) from the same padded start state: the seed prefetch
    (working set, extrema) is bitwise equal, and both chunks converge to
    the same optimum."""
    x, y = blobs_small
    n = len(y)
    xp, yp, valid = _padded_problem(x, y, 1024, 0.1)
    q, inner, eps, tau = 16, 32, 1e-3, 1e-12
    jkp, tkp = JaxKP("rbf", 0.1), KernelParams("rbf", 0.1)
    jx = jnp.asarray(xp)
    jsq = jax_squared_norms(jx)
    jkd = jax_kernel_diag(jsq, jkp)
    tx, ty, tv = map(torch.as_tensor, (xp, yp, valid))
    tsq = torch.tensor(np.asarray(jsq))
    tkd = kernel_diag(tsq, tkp)
    yv, vv = jnp.asarray(yp), jnp.asarray(valid)

    jc = jblock.prefetch_working_set(jx, yv, jsq, jkd, -yv,
                                     jnp.zeros(1024), vv, jkp, 1.0, q,
                                     "mvp", pallas_select=True,
                                     interpret=True)
    tc = tblock.prefetch_working_set(tx, ty, tsq, tkd, -ty,
                                     torch.zeros(1024), tv, tkp, 1.0, q,
                                     "mvp", pallas_select=True,
                                     valid2d=tv.float().view(-1, 128))
    np.testing.assert_array_equal(tc.w.numpy(), np.asarray(jc.w))
    np.testing.assert_array_equal(tc.ok.numpy(), np.asarray(jc.ok))
    assert (float(tc.b_hi), float(tc.b_lo)) == (float(jc.b_hi),
                                                float(jc.b_lo))
    np.testing.assert_allclose(tc.kb.numpy(), np.asarray(jc.kb), rtol=1e-6)

    zero = jnp.int32(0)
    jst = jblock.BlockState(jnp.zeros(1024), -yv, jnp.float32(-np.inf),
                            jnp.float32(np.inf), zero, zero)
    jfin = jblock.run_chunk_block_pipelined(
        jx, yv, jsq, jkd, vv, jst, jnp.int32(100_000), jkp, 1.0, eps, tau,
        q, inner, 10 ** 6, inner_impl="xla", interpret=True,
        pallas_select=True)
    zt = torch.zeros((), dtype=torch.int32)
    tst = tblock.BlockState(torch.zeros(1024), -ty,
                            torch.tensor(-np.inf), torch.tensor(np.inf),
                            zt, zt)
    tfs.select_rows.launches = 0
    tfin = tblock.run_chunk_block_pipelined(
        tx, ty, tsq, tkd, tv, tst, 100_000, tkp, 1.0, eps, tau, q, inner,
        pallas_select=True)
    assert tfs.select_rows.launches == 0  # the CPU runs the plain version
    for fin in (jfin, tfin):
        assert not float(fin.b_lo) > float(fin.b_hi) + 2 * eps
        assert int(fin.rounds) > 1
    ja, jf = np.asarray(jfin.alpha), np.asarray(jfin.f)
    ta, tf = tfin.alpha.numpy(), tfin.f.numpy()
    assert not ta[n:].any() and not ja[n:].any()

    def obj(a, f):
        a, f = a[:n].astype(np.float64), f[:n].astype(np.float64)
        return float(a.sum() - 0.5 * np.sum(a * y * (f + y)))

    assert abs(obj(ta, tf) - obj(ja, jf)) <= 1e-4 * abs(obj(ja, jf))


@pytest.mark.parametrize("knob", ["fused_fold", "fused_round"])
def test_fused_engines_at_a_whole_number_of_tiles(knob):
    """n = 1024 needs no padding rows, but the fused engines still carry
    their `valid` mask: the same optimum as the plain engine."""
    from dpsvm_tpu.data.synth import make_blobs_binary

    x, y = make_blobs_binary(n=1024, d=6, seed=2, sep=1.5)
    cfg = SVMConfig(**BASE, working_set_size=16)
    rf = solve(x, y, cfg.replace(**{knob: True}), device="cpu")
    rp = solve(x, y, cfg, device="cpu")
    assert rf.stats[knob] and rf.stats["n_pad"] == 1024
    assert rf.converged and rp.converged
    assert abs(_dual_obj(rf, y) - _dual_obj(rp, y)) <= 1e-4 * abs(
        _dual_obj(rp, y))


def test_small_n_falls_back_to_the_plain_engine():
    """q/2 > n_pad/128: every slot cannot find a per-row candidate, so
    the plain engine runs even with the knobs forced on, as in JAX."""
    from dpsvm_tpu.data.synth import make_blobs_binary

    x, y = make_blobs_binary(n=200, d=6, seed=1, sep=1.5)
    for knob in ("fused_fold", "fused_round"):
        cfg = {**BASE, "working_set_size": 128, knob: True}
        rt = solve(x, y, SVMConfig(**cfg), device="cpu")
        rj = jax_solve(x, y, JaxConfig(**cfg))
        assert rt.converged and rj.converged
        assert not rt.stats[knob] and rt.stats["n_pad"] == 200


@pytest.mark.parametrize("n,ws,dev,want", [
    (300, 16, "cpu", "fused_round"),
    (200, 128, "cpu", None),
    (2048, 32, "cuda", "fused_round"),
])
def test_choose_engine_mirrors_the_jax_solve(n, ws, dev, want):
    eng = choose_engine(SVMConfig(**BASE, working_set_size=ws,
                                  fused_round=True), n, torch.device(dev))
    assert eng["fused_round"] == (want == "fused_round")
    assert eng["n_pad"] == (-(-n // 1024) * 1024 if want else n)
    pipe = choose_engine(SVMConfig(**BASE, working_set_size=ws,
                                   pipeline_rounds=True, fused_fold=True),
                         n, torch.device(dev))
    assert pipe["pipelined"] and not pipe["fused_fold"]
    # The one-pass prefetch selection engages on CUDA only (the JAX
    # package: on the TPU only), and only within the shape contract.
    assert pipe["pipe_select"] == (dev == "cuda" and want is not None)
    auto = choose_engine(SVMConfig(**BASE, working_set_size=ws), n,
                         torch.device(dev))
    assert not (auto["fused_fold"] or auto["fused_round"]
                or auto["pipelined"]) and auto["n_pad"] == n


BAD_CONFIGS = [
    (dict(engine="xla", fused_round=True), "block-engine"),
    (dict(engine="block", kernel="precomputed", fused_round=True),
     "feature kernels"),
    (dict(engine="block", fused_round=True, pipeline_rounds=True),
     "pipeline_rounds"),
    (dict(engine="block", fused_round=True, active_set_size=64),
     "active_set_size"),
    (dict(engine="block", fused_round=True, ooc=True), "ooc"),
    (dict(engine="block", fused_round=True, gram_resident=True),
     "gram_resident"),
    (dict(engine="xla", pipeline_rounds=True), "block-engine"),
    (dict(engine="block", pipeline_rounds=True, active_set_size=64),
     "active_set_size"),
    (dict(engine="block", pipeline_rounds=True, selection="nu"),
     "selection"),
]


@pytest.mark.parametrize("kw,match", BAD_CONFIGS)
def test_config_validation_matches_jax(kw, match):
    with pytest.raises(ValueError, match=match):
        JaxConfig(**kw)
    with pytest.raises(ValueError, match=match):
        SVMConfig(**kw)


@pytest.mark.parametrize("flag", ["--fused-round", "--pipeline-rounds"])
def test_cli_flags_reach_the_engines(tmp_path, capsys, blobs_small, flag):
    x, y = blobs_small
    csv = tmp_path / "train.csv"
    np.savetxt(csv, np.column_stack([y, x]), delimiter=",", fmt="%.7g")
    model = tmp_path / "m.txt"
    rc = cli.main(["train", "-f", str(csv), "-m", str(model), "-c", "1",
                   "-g", "0.1", "--engine", "block", "--working-set-size",
                   "16", flag, "on", "--device", "cpu"])
    assert rc == 0 and model.exists()
    assert "train accuracy" in capsys.readouterr().out
    args = cli._build_parser().parse_args(
        ["train", "-f", "a", "-m", "b", flag, "off"])
    assert getattr(args, flag[2:].replace("-", "_")) == "off"
