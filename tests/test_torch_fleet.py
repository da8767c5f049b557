"""The port's fleet (dpsvm_tpu_torch/solver/fleet.py) and its batched
selection (ops/select.py select_working_set_batched) against the JAX
package's on the same seeded inputs: the selection bit for bit (ties to
the lowest index, +-0 included), every fleet problem within the
whole-solve contract of JAX's solve_fleet (dual rel 1e-4, SV count 2%,
|db| 5e-3), the freeze of a converged problem bit for bit (a non-finite
kernel value in its gated lane included), and the routing reasons.

JAX's own freeze test (tests/test_fleet.py) does not hold on jax 0.9.0,
so the freeze is held here on the port alone."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dpsvm_tpu.config import SVMConfig as JaxConfig
from dpsvm_tpu.ops.select import \
    select_working_set_batched as jax_select_batched
from dpsvm_tpu.solver import fleet as jfleet
from dpsvm_tpu_torch import SVMConfig
from dpsvm_tpu_torch.data.synth import make_mnist_multiclass
from dpsvm_tpu_torch.ops.kernels import KernelParams
from dpsvm_tpu_torch.ops.select import (select_working_set,
                                        select_working_set_batched)
from dpsvm_tpu_torch.solver import fleet as tfleet


def _select_inputs(seed, k=5, n=64):
    rng = np.random.default_rng(seed)
    # Few distinct values, so ties are common; +-0 among them.
    f = rng.choice(np.array([-1.0, -0.0, 0.0, 0.5, 2.0], np.float32),
                   size=(k, n))
    c_pos = rng.choice([1.0, 2.0], size=(k, 1)).astype(np.float32)
    c_neg = rng.choice([1.0, 0.5], size=(k, 1)).astype(np.float32)
    y = rng.choice(np.array([-1.0, 1.0], np.float32), size=(k, n))
    bound = np.where(y > 0, c_pos, c_neg)
    alpha = np.where(rng.random((k, n)) < 0.3, 0.0,
                     np.where(rng.random((k, n)) < 0.5, bound,
                              0.5 * bound)).astype(np.float32)
    valid = rng.random((k, n)) < 0.8
    valid[-1] = False  # a problem with no rows (a bucket filler)
    return f, alpha, y, c_pos, c_neg, valid


@pytest.mark.parametrize("seed", range(6))
def test_batched_selection_is_jaxs_bitwise(seed):
    args = _select_inputs(seed)
    got = select_working_set_batched(*(torch.as_tensor(a) for a in args))
    want = jax_select_batched(*(jnp.asarray(a) for a in args))
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy()
        if w.dtype == np.float32:
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
        else:
            np.testing.assert_array_equal(g, w)


def test_batched_selection_is_the_single_rule_per_row():
    f, alpha, y, c_pos, c_neg, valid = _select_inputs(9)
    t = [torch.as_tensor(a) for a in (f, alpha, y, c_pos, c_neg, valid)]
    i_hi, b_hi, i_lo, b_lo = select_working_set_batched(*t)
    for j in range(f.shape[0] - 1):
        c = (float(c_pos[j, 0]), float(c_neg[j, 0]))
        one = select_working_set(t[0][j], t[1][j], t[2][j], c, t[5][j])
        assert (int(one[0]), int(one[2])) == (int(i_hi[j]), int(i_lo[j]))
        assert float(one[1]) == float(b_hi[j])
        assert float(one[3]) == float(b_lo[j])


@pytest.fixture(scope="module")
def classes():
    return make_mnist_multiclass(n=240, d=16, seed=2, n_classes=3)


def _problems(mod, x, y):
    cls = np.unique(y)
    out = [mod.FleetProblem(y=np.where(y == c, 1, -1).astype(np.int32),
                            tag=("ovr", int(c))) for c in cls]
    mask = (y == cls[0]) | (y == cls[1])
    out.append(mod.FleetProblem(y=np.where(y == cls[0], 1, -1).astype(
        np.int32), row_mask=mask, c=3.0, tag="masked"))
    out.append(mod.FleetProblem(y=np.where(y == cls[2], 1, -1).astype(
        np.int32), c=(2.0, 0.5), tag="pair"))
    return out


def _dual(res, y):
    a = res.alpha.astype(np.float64)
    yf = y.astype(np.float64)
    return float(a.sum() - 0.5 * np.sum(a * yf * (res.stats["f"] + yf)))


@pytest.mark.parametrize("kw", [dict(gamma=0.1),
                                dict(gamma=0.1, gram_resident=True)],
                         ids=["features", "resident-gram"])
def test_solve_fleet_matches_jax(classes, kw):
    x, y = classes
    cfg = dict(c=2.0, epsilon=1e-3, **kw)
    pt = _problems(tfleet, x, y)
    rt = tfleet.solve_fleet(x, pt, SVMConfig(**cfg), device="cpu")
    rj = jfleet.solve_fleet(x, _problems(jfleet, x, y), JaxConfig(**cfg))
    for p, a, b in zip(pt, rt, rj):
        yk = p.y if p.row_mask is None else p.y[p.row_mask]
        assert a.converged and b.converged
        assert abs(_dual(a, yk) - _dual(b, yk)) <= 1e-4 * abs(_dual(b, yk))
        assert abs(a.n_sv - b.n_sv) <= max(1, 0.02 * b.n_sv)
        assert abs(a.b - b.b) <= 5e-3
        assert a.alpha.shape == yk.shape
        assert a.stats["tag"] == p.tag
        assert a.stats["fleet"]["bucket"] == b.stats["fleet"]["bucket"] == 8
    fl = rt[0].stats["fleet"]
    assert fl["trips"] == max(r.iterations for r in rt)
    assert fl["host_reads"] == rt[0].dispatches >= 1
    assert sum(r.train_seconds for r in rt) == pytest.approx(
        fl["device_seconds"])


def test_fleet_problem_is_the_sequential_solve(classes):
    """A problem's trajectory is the per-pair mvp engine's: the same
    pairs, and the same alpha bit for bit on the CPU."""
    from dpsvm_tpu_torch.solver.solve import solve

    x, y = classes
    cfg = SVMConfig(c=2.0, gamma=0.1, epsilon=1e-3)
    yk = np.where(y == 1, 1, -1).astype(np.int32)
    res = tfleet.solve_fleet(x, [tfleet.FleetProblem(y=yk)], cfg,
                             device="cpu")[0]
    seq = solve(x, yk, cfg, device="cpu")
    assert res.iterations == seq.iterations
    np.testing.assert_array_equal(res.alpha, seq.alpha)


def test_converged_problem_freezes_bitwise():
    """Trip by trip: once a problem's gap closes, its alpha, f, extrema
    and pair count never change again, while the others run on; a
    non-finite kernel value and a -0.0 gradient in its gated lane change
    nothing."""
    rng = np.random.default_rng(3)
    n = 48
    x = rng.normal(size=(n, 3)).astype(np.float32)
    x64 = x.astype(np.float64)
    g = np.exp(-0.5 * ((x64[:, None] - x64[None]) ** 2).sum(-1))
    g = g.astype(np.float32)
    easy = np.where(x[:, 0] > 0, 1.0, -1.0).astype(np.float32)
    hard = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    y = torch.as_tensor(np.stack([easy, hard]))
    valid = torch.ones((2, n), dtype=torch.bool)
    cb = torch.tensor([[1.0, 1.0], [50.0, 50.0]])
    xt = torch.as_tensor(g)
    x_sq = torch.zeros(n)
    kp = KernelParams("precomputed")
    st = tfleet.FleetState(torch.zeros((2, n)), -y.clone(),
                           torch.full((2,), -np.inf),
                           torch.full((2,), np.inf),
                           torch.zeros(2, dtype=torch.int32),
                           torch.zeros((), dtype=torch.int32))
    frozen = None
    for _ in range(5000):
        st = tfleet.fleet_trip(xt, y, x_sq, valid, cb, st, 10 ** 6, kp,
                               1e-3, 1e-12)
        act = tfleet.active_mask(st, 10 ** 6, 1e-3)
        if frozen is None and not bool(act[0]):
            frozen = [t[0].clone() for t in st[:5]]
            # Poison what a later gated trip of problem 0 reads: its rows
            # of the Gram, and a -0.0 in its gradient.
            st = st._replace(f=st.f.clone())
            st.f[0, 7] = -0.0
            frozen[1][7] = -0.0
            xt = xt.clone()
            xt[:, :] = torch.where(torch.arange(n)[None, :] == 0,
                                   float("inf"), xt)
        if frozen is not None:
            for a, b in zip(frozen, st[:5]):
                assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                                   else a,
                                   b[0].view(torch.int32)
                                   if b.is_floating_point() else b[0])
        if not bool(act.any()):
            break
    assert frozen is not None
    assert int(st.t) == int(st.it.max())


CONFIGS = [dict(), dict(engine="block"), dict(selection="second_order"),
           dict(pair_batch=2), dict(kernel="precomputed"),
           dict(compensated=True), dict(reconstruct_every=1000),
           dict(engine="block", kernel="precomputed", compensated=True),
           dict(gram_resident=True), dict(engine="pallas")]


@pytest.mark.parametrize("kw", CONFIGS)
def test_routing_reasons_are_jaxs(kw):
    assert (tfleet.fleet_routing_reasons(SVMConfig(**kw))
            == jfleet.fleet_routing_reasons(JaxConfig(**kw)))


def test_buckets_chunks_and_bounds_are_jaxs():
    for k in range(1, 70):
        assert tfleet._fleet_bucket(k) == jfleet._fleet_bucket(k)
    items = list(range(45))
    assert tfleet.fleet_chunks(items, 16) == jfleet.fleet_chunks(items, 16)
    cfg = dict(c=2.0, weight_pos=3.0, weight_neg=0.5)
    for c in (None, 4.0, (1.0, 2.0)):
        assert tfleet._problem_bounds(
            tfleet.FleetProblem(y=None, c=c), SVMConfig(**cfg)) == \
            jfleet._problem_bounds(jfleet.FleetProblem(y=None, c=c),
                                   JaxConfig(**cfg))


@pytest.mark.parametrize("kw,phrase", [
    (dict(selection="second_order"), "MVP rule only"),
    (dict(compensated=True), "accuracy stack"),
])
def test_refusals_are_jaxs(classes, kw, phrase):
    x, y = classes
    p = [tfleet.FleetProblem(y=np.where(y == 0, 1, -1))]
    jp = [jfleet.FleetProblem(y=np.where(y == 0, 1, -1))]
    with pytest.raises(ValueError, match=phrase):
        tfleet.solve_fleet(x, p, SVMConfig(**kw), device="cpu")
    with pytest.raises(ValueError, match=phrase):
        jfleet.solve_fleet(x, jp, JaxConfig(**kw))
    with pytest.raises(ValueError, match="shape"):
        tfleet.solve_fleet(x, [tfleet.FleetProblem(y=np.ones(3))],
                           SVMConfig(), device="cpu")
    assert tfleet.solve_fleet(x, [], SVMConfig(), device="cpu") == []
