"""The port's per-pair engines (engine="xla" with the row cache, the
resident Gram and micro-batching; engine="pallas" on kernel B6's plain
version) against the JAX package's solve() on the same inputs, on the
CPU.

exp differs by a few ulps between XLA and torch (ROADMAP C.2), so the
trajectories part after a while; the first pairs must be the same pairs,
and whole solves are held to the port's contract: both converge, dual
objective within rel 1e-4, SV count within 2%, |b - b_jax| <= 5e-3. On
the small blobs the two packages also take the same number of pairs and
report the same cache counters."""

import numpy as np
import pytest
import torch

from dpsvm_tpu.config import SVMConfig as JaxConfig
from dpsvm_tpu.models.svm_model import SVMModel as JaxModel
from dpsvm_tpu.predict import decision_function as jax_decision
from dpsvm_tpu.solver.smo import solve as jax_solve
from dpsvm_tpu.train import train as jax_train
from dpsvm_tpu_torch import (SVMConfig, SVMModel, cli, decision_function,
                             solve, train)
from dpsvm_tpu_torch.data import save_csv
from dpsvm_tpu_torch.ops.kernels import KernelParams
from dpsvm_tpu_torch.ops.select import extrema_np
from dpsvm_tpu_torch.solver import smo as tsmo
from dpsvm_tpu_torch.solver import solve as tsolve

BASE = dict(c=1.0, gamma=0.1)
CACHE_STATS = ("cache_hits", "cache_lookups", "cache_evictions")


def _dual_obj(res, y):
    a = np.asarray(res.alpha, np.float64)
    f = np.asarray(res.stats["f"], np.float64)
    return float(a.sum() - 0.5 * np.sum(a * y * (f + y)))


def _assert_same_optimum(rt, rj, y, eps=1e-3):
    assert rj.converged and rt.converged
    obj_j, obj_t = _dual_obj(rj, y), _dual_obj(rt, y)
    assert abs(obj_t - obj_j) <= 1e-4 * abs(obj_j), (obj_t, obj_j)
    assert abs(rt.n_sv - rj.n_sv) <= 0.02 * rj.n_sv, (rt.n_sv, rj.n_sv)
    assert abs(rt.b - rj.b) <= 5e-3, (rt.b, rj.b)
    # The stopping rule holds on the last selection's extrema (the final
    # update after it may open the gap by a little, as in JAX).
    assert rt.b_lo <= rt.b_hi + 2 * eps
    assert rt.alpha.shape == y.shape


@pytest.fixture
def data(request, blobs_small, blobs_medium):
    return blobs_small if request.param == "small" else blobs_medium


# Whole solves on the blobs fixtures, shared by the tests of this module
# that run the same configuration: {(package, id of X, config): result}.
_SOLVES = {}


def _solved(x, y, cfg):
    """solve() of the package `cfg` belongs to (the port on the CPU), once
    per data and configuration."""
    key = (type(cfg), id(x), cfg)
    if key not in _SOLVES:
        _SOLVES[key] = (solve(x, y, cfg, device="cpu")
                        if isinstance(cfg, SVMConfig)
                        else jax_solve(x, y, cfg))
    return _SOLVES[key]


CASES = [
    ("small", dict()),
    ("small", dict(selection="second_order")),
    ("small", dict(cache_lines=8)),
    ("small", dict(cache_lines=64)),
    ("small", dict(selection="second_order", cache_lines=8)),
    ("small", dict(compensated=True)),
    ("small", dict(weight_pos=2.0, weight_neg=0.5)),
    ("small", dict(selection="second_order", compensated=True,
                   weight_pos=2.0, weight_neg=0.5)),
    ("small", dict(dtype="bfloat16")),
    ("small", dict(pair_batch=2)),
    ("small", dict(pair_batch=4)),
    ("small", dict(pair_batch=8)),
    ("small", dict(pair_batch=4, compensated=True)),
    ("small", dict(gram_resident=True)),
    ("small", dict(gram_resident=True, selection="second_order")),
    ("small", dict(gram_resident=True, pair_batch=4)),
    ("small", dict(engine="pallas")),
    ("small", dict(engine="pallas", cache_lines=8)),
    ("medium", dict()),
    ("medium", dict(cache_lines=64, selection="second_order")),
    ("medium", dict(pair_batch=8)),
    ("medium", dict(engine="pallas", cache_lines=64)),
]


@pytest.mark.parametrize(
    "data,kw", CASES, indirect=["data"],
    ids=[f"{size}-" + "-".join(f"{k}={v}" for k, v in kw.items())
         for size, kw in CASES])
def test_solve_matches_jax(data, kw):
    x, y = data
    cfg = {**BASE, **kw}
    rj = _solved(x, y, JaxConfig(**cfg))
    rt = _solved(x, y, SVMConfig(**cfg))
    _assert_same_optimum(rt, rj, y)
    assert "outer_rounds" not in rt.stats
    assert rt.stats["gram_resident"] == bool(kw.get("gram_resident"))
    assert rt.stats["n_pad"] == (8192 if kw.get("engine") == "pallas"
                                 else len(y))
    if len(y) < 1000:
        # On the small blobs the trajectories stay together to the end.
        assert rt.iterations == rj.iterations
        assert {k: rt.stats[k] for k in CACHE_STATS} == \
            {k: rj.stats[k] for k in CACHE_STATS}
        assert rt.stats["cache_hit_rate"] == \
            pytest.approx(rj.stats["cache_hit_rate"], abs=1e-12)


def _changed_per_step(alphas):
    """The indices whose alpha changed at each step."""
    return [tuple(np.flatnonzero(b != a).tolist())
            for a, b in zip(alphas, alphas[1:])]


@pytest.mark.parametrize("kw", [dict(), dict(selection="second_order"),
                                dict(cache_lines=4), dict(engine="pallas"),
                                dict(pair_batch=4)],
                         ids=["mvp", "second_order", "cache", "pallas",
                              "micro4"])
def test_first_pairs_are_jaxs(blobs_medium, kw):
    """The first 20 trips update the same coordinates as JAX's (JAX
    observed after every trip with a chunk_iters=1 callback, the port
    re-run with max_iter = 1 .. 20)."""
    x, y = blobs_medium
    k = kw.get("pair_batch", 1)
    seen = [np.zeros(len(y), np.float32)]

    def record(it, b_hi, b_lo, state):
        seen.append(np.array(state.alpha)[:len(y)])

    jax_solve(x, y, JaxConfig(**BASE, **kw, chunk_iters=k,
                              max_iter=20 * k), callback=record)
    port = [np.zeros(len(y), np.float32)] + [
        solve(x, y, SVMConfig(**BASE, **kw, max_iter=t * k),
              device="cpu").alpha for t in range(1, 21)]
    assert len(seen) == len(port) == 21
    assert _changed_per_step(port) == _changed_per_step(seen)
    np.testing.assert_allclose(port[-1], seen[-1], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("data", ["small", "medium"], indirect=True)
def test_pallas_and_xla_counts_differ_by_at_most_one(data):
    """engine="pallas" stops at the first post-update selection that shows
    convergence, skipping the final degenerate update: one pair fewer or
    the same, in both packages."""
    x, y = data
    counts = {}
    for eng in ("xla", "pallas"):
        counts[eng] = (_solved(x, y, SVMConfig(**BASE, engine=eng))
                       .iterations,
                       _solved(x, y, JaxConfig(**BASE, engine=eng))
                       .iterations)
    for side in (0, 1):
        assert abs(counts["xla"][side] - counts["pallas"][side]) <= 1


@pytest.mark.parametrize("kw", [dict(), dict(selection="second_order"),
                                dict(cache_lines=16), dict(engine="pallas"),
                                dict(pair_batch=4), dict(pair_batch=8)],
                         ids=["mvp", "second_order", "cache", "pallas",
                              "micro4", "micro8"])
def test_budget_mode_lands_exactly_on_max_iter(blobs_small, kw):
    """The budget is not a multiple of the micro batch: attempted slots
    count, so every engine stops at exactly max_iter, as in JAX."""
    x, y = blobs_small
    cfg = {**BASE, "c": 10.0, "budget_mode": True, "max_iter": 101, **kw}
    rt = solve(x, y, SVMConfig(**cfg), device="cpu")
    rj = jax_solve(x, y, JaxConfig(**cfg))
    assert rt.iterations == rj.iterations == 101
    assert rt.converged == rj.converged
    b_hi, b_lo = extrema_np(rt.stats["f"], rt.alpha, y, 10.0)
    assert rt.converged == (not (b_lo > b_hi + 2e-3))


def test_max_iter_exit_keeps_the_carried_extrema(blobs_medium):
    """Without budget_mode a max_iter exit reports the last selection's
    extrema, not a refresh (as JAX does for the per-pair engines)."""
    x, y = blobs_medium
    rt = solve(x, y, SVMConfig(**BASE, max_iter=50), device="cpu")
    rj = jax_solve(x, y, JaxConfig(**BASE, max_iter=50))
    assert rt.iterations == rj.iterations == 50
    assert not rt.converged and not rj.converged
    assert rt.b_hi == pytest.approx(rj.b_hi, abs=1e-5)
    assert rt.b_lo == pytest.approx(rj.b_lo, abs=1e-5)


def test_micro_free_point_in_both_lists_cannot_livelock():
    """JAX's crafted state (tests/test_micro_batch.py): I_up's top three
    are {0, 3, 1} by f and the free point 1 tops I_low, so 1 collides
    across the lists. Rank-ordered gating must still EXECUTE pair 0."""
    import jax.numpy as jnp

    from dpsvm_tpu.ops.kernels import KernelParams as JaxKP
    from dpsvm_tpu.solver.smo import _run_chunk_micro, init_state

    n, c = 6, 10.0
    y = np.array([1, 1, 1, -1, -1, -1], np.float32)
    alpha = np.array([0.0, 5.0, 10.0, 10.0, 0.0, 0.0], np.float32)
    f = np.array([-2.0, -1.0, -5.0, -1.5, -1.9, -1.8], np.float32)
    x = np.eye(n, 4, dtype=np.float32)
    x_sq = (x * x).sum(1)
    st = init_state(n, jnp.asarray(y), 1)._replace(alpha=jnp.asarray(alpha),
                                                    f=jnp.asarray(f))
    jout = _run_chunk_micro(jnp.asarray(x), jnp.asarray(y),
                            jnp.asarray(x_sq), jnp.ones((n,), jnp.float32),
                            None, st, jnp.int32(3), JaxKP("rbf", 0.5),
                            (c, c), 1e-3, 1e-12, chunk=3, k=3)
    tst = tsmo.init_pair_state(torch.as_tensor(y))._replace(
        alpha=torch.as_tensor(alpha), f=torch.as_tensor(f))
    tout = tsmo.run_chunk_micro(
        torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(x_sq),
        torch.ones(n), None, tst, 3, KernelParams("rbf", 0.5), (c, c), 1e-3,
        1e-12, 3)
    assert not np.allclose(tout.alpha.numpy(), alpha)
    assert tout.it == int(jout.it) >= 1
    np.testing.assert_allclose(tout.alpha.numpy(), np.asarray(jout.alpha),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tout.f.numpy(), np.asarray(jout.f),
                               rtol=1e-6, atol=1e-6)


def test_micro_clamps_the_batch_to_tiny_problems():
    x = np.array([[0.0, 0.0], [1.0, 1.0], [0.2, 0.1], [0.9, 1.1]],
                 np.float32)
    y = np.array([-1, 1, -1, 1], np.int32)
    ref = jax_solve(x, y, JaxConfig(**BASE))
    for k in (8, 4):
        got = solve(x, y, SVMConfig(**BASE, pair_batch=k), device="cpu")
        assert got.converged
        assert abs(got.b - ref.b) < 1e-3


def test_resident_gram_gate(monkeypatch):
    """Auto is on for engine="xla" from 8192 rows when 4 n^2 bytes fit
    70% of the card's memory; the CPU has no budget, so auto stays off
    there (as in JAX); True forces it, pallas never has it."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    cfg = SVMConfig()
    assert tsolve.gram_budget_bytes(cpu) == 0
    assert not tsolve.resolve_gram(cfg, 60_000, cpu)
    assert tsolve.resolve_gram(cfg.replace(gram_resident=True), 100, cpu)
    assert not tsolve.resolve_gram(cfg.replace(engine="pallas"), 60_000,
                                   cpu)
    monkeypatch.setattr(tsolve, "gram_budget_bytes",
                        lambda dev: int(0.70 * 80e9))
    assert tsolve.resolve_gram(cfg, 60_000, cuda)
    assert not tsolve.resolve_gram(cfg, 8191, cuda)
    assert not tsolve.resolve_gram(cfg, 160_000, cuda)
    assert not tsolve.resolve_gram(cfg.replace(gram_resident=False),
                                   60_000, cuda)
    assert not tsolve.resolve_gram(cfg.replace(engine="block"), 60_000,
                                   cuda)


def test_default_config_trains_on_the_cpu(blobs_small):
    """SVMConfig() is engine="xla": it trains through train() with no
    engine named, and the model decides as the JAX package's does."""
    x, y = blobs_small
    model, res = train(x, y, SVMConfig(c=10, gamma=0.05), device="cpu")
    assert res.converged and not res.stats["gram_resident"]
    jm, _ = jax_train(x, y, JaxConfig(c=10, gamma=0.05), backend="single")
    np.testing.assert_allclose(decision_function(model, x, device="cpu"),
                               np.asarray(jax_decision(jm, x)), atol=2e-3)


@pytest.mark.parametrize("extra", [[], ["-s", "64", "--pair-batch", "4"],
                                   ["--engine", "pallas", "-s", "16"]],
                         ids=["default", "cache-micro", "pallas"])
def test_cli_trains_per_pair_and_jax_reloads(tmp_path, capsys, blobs_small,
                                             extra):
    x, y = blobs_small
    csv = str(tmp_path / "train.csv")
    save_csv(csv, x, y)
    path = str(tmp_path / "m.txt")
    rc = cli.main(["train", "-f", csv, "-m", path, "-c", "1", "-g", "0.1",
                   "--device", "cpu", *extra])
    out = capsys.readouterr().out
    assert rc == 0 and "converged at iteration" in out
    if "-s" in extra and "--pair-batch" not in extra:
        assert "cache hit rate" in out
    args = cli._build_parser().parse_args(["train", "-f", "a", "-m", "b",
                                           *extra])
    assert args.cache_size == (int(extra[extra.index("-s") + 1])
                               if "-s" in extra else 0)
    assert args.engine == ("pallas" if "pallas" in extra else "xla")
    # The JAX package reads the model and scores it the same.
    jm = JaxModel.load(path)
    d_t = decision_function(SVMModel.load(path), x, device="cpu")
    d_j = np.asarray(jax_decision(jm, x, precision="float64"))
    np.testing.assert_allclose(d_t, d_j, atol=1e-4)
