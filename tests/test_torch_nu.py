"""The port's nu rule against the JAX package, on the same seeded inputs:
the per-class pair (select_working_set_nu), the nu stopping gap
(nu_stopping_pair, stopping_extrema, extrema_np), the block engine's
per-class quarters (select_block(rule="nu")), all bit for bit, with an
empty class, ties and signed zeros; the subproblem's plain nu rule bit
for bit against both JAX forms; the per-pair nu step's first pairs;
and how the solve treats selection="nu" (q granularity, the plain round
whatever the fused knobs say, the refusals)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpsvm_tpu.config import SVMConfig as JaxConfig
from dpsvm_tpu.ops import select as jsel
from dpsvm_tpu.ops.pallas_subproblem import solve_subproblem_pallas
from dpsvm_tpu.solver import block as jblock
from dpsvm_tpu.solver.smo import solve as jax_solve
from dpsvm_tpu_torch import SVMConfig, solve
from dpsvm_tpu_torch.ops import select as tsel
from dpsvm_tpu_torch.ops import subproblem as tsub
from dpsvm_tpu_torch.solver import block as tblock
from dpsvm_tpu_torch.solver.solve import block_height, choose_engine

EPS, TAU = 1e-3, 1e-12


def _bits(v):
    return np.float32(np.asarray(v)).view(np.int32)


def _cases():
    """(f, alpha, y, c) float32 states of a nu dual, n = 400."""
    rng = np.random.default_rng(5)
    n, c = 400, 1.0
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    alpha = rng.choice([0.0, c, 0.25, 0.6], size=n).astype(np.float32)
    out = {"random": (rng.normal(size=n).astype(np.float32), alpha, y, c)}
    # Heavy ties, signed zeros among them.
    out["ties"] = (rng.choice(np.array([-1.0, -0.0, 0.0, 0.5, 1.0],
                                       np.float32), size=n), alpha, y, c)
    # All +1 (one-class data): the - class is empty on both sides.
    ones = np.ones(n, np.float32)
    out["one_class"] = (rng.normal(size=n).astype(np.float32), alpha, ones, c)
    # The + class has no I_up member (all at the bound), the - class no
    # I_low member (all at the bound): each class has a one-sided set.
    a_side = np.where(y > 0, c, c).astype(np.float32)
    a_side[:40] = 0.5
    out["one_sided"] = (rng.normal(size=n).astype(np.float32), a_side, y, c)
    # A violation tie between the classes (ties go to the + class).
    f_tie = np.zeros(n, np.float32)
    a_mid = np.full(n, 0.5, np.float32)
    f_tie[np.nonzero(y > 0)[0][:2]] = (-1.0, 1.0)
    f_tie[np.nonzero(y < 0)[0][:2]] = (-2.0, 0.0)
    out["class_tie"] = (f_tie, a_mid, y, c)
    # Class weights.
    out["weighted"] = (rng.normal(size=n).astype(np.float32),
                       (rng.random(n) * 0.5).astype(np.float32), y,
                       (1.0, 0.4))
    return out


CASES = _cases()


def _valid(n, masked):
    if not masked:
        return None
    v = np.ones(n, bool)
    v[::7] = False
    return v


@pytest.mark.parametrize("masked", [False, True], ids=["all", "valid"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_select_working_set_nu_bitwise(case, masked):
    f, alpha, y, c = CASES[case]
    valid = _valid(len(y), masked)
    j = jsel.select_working_set_nu(
        jnp.asarray(f), jnp.asarray(alpha), jnp.asarray(y), c,
        None if valid is None else jnp.asarray(valid))
    t = tsel.select_working_set_nu(
        torch.as_tensor(f), torch.as_tensor(alpha), torch.as_tensor(y), c,
        None if valid is None else torch.as_tensor(valid))
    assert int(t[0]) == int(j[0]) and int(t[2]) == int(j[2])
    assert _bits(t[1]) == _bits(j[1]) and _bits(t[3]) == _bits(j[3])


def test_class_tie_goes_to_the_positive_class():
    f, alpha, y, c = CASES["class_tie"]
    i, b_hi, j, b_lo = tsel.select_working_set_nu(
        torch.as_tensor(f), torch.as_tensor(alpha), torch.as_tensor(y), c)
    assert float(b_lo - b_hi) == 2.0
    assert y[int(i)] > 0 and y[int(j)] > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_nu_stopping_extrema_bitwise(case):
    f, alpha, y, c = CASES[case]
    jb = jsel.stopping_extrema(jnp.asarray(f), jnp.asarray(alpha),
                               jnp.asarray(y), c, rule="nu")
    tb = tsel.stopping_extrema(torch.as_tensor(f), torch.as_tensor(alpha),
                               torch.as_tensor(y), c, rule="nu")
    assert [_bits(v) for v in tb] == [_bits(v) for v in jb]
    assert tsel.extrema_np(f, alpha, y, c, rule="nu") == \
        jsel.extrema_np(f, alpha, y, c, rule="nu")
    # A float64 f is kept as is on the host path.
    f64 = f.astype(np.float64) + 1e-12
    assert tsel.extrema_np(f64, alpha, y, c, rule="nu") == \
        jsel.extrema_np(f64, alpha, y, c, rule="nu")


@pytest.mark.parametrize("vals", [
    (1.0, 2.0, 0.0, 1.0),                   # tie: the + class
    (np.inf, -np.inf, -1.0, 1.0),           # empty + class
    (-1.0, 1.0, np.inf, -np.inf),           # empty - class
    (np.inf, -np.inf, np.inf, -np.inf),     # both empty
    (-0.0, 0.0, 0.0, -0.0),                 # signed zeros
    (0.1, 0.30000001, 0.2, 0.4),            # float32 rounding decides
])
def test_nu_stopping_pair_bitwise(vals):
    v32 = [np.float32(v) for v in vals]
    j = jsel.nu_stopping_pair(*map(jnp.float32, v32))
    t = tsel.nu_stopping_pair(*(torch.tensor(v) for v in v32))
    assert [_bits(v) for v in t] == [_bits(v) for v in j]
    # The host form works in float64, as the JAX package's NumPy path.
    jh = jsel.nu_stopping_pair(*map(float, v32), xp=np)
    assert tsel.nu_stopping_pair(*map(float, v32)) == tuple(map(float, jh))


@pytest.mark.parametrize("q", [4, 64, 100, 256])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "valid"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_select_block_nu_bitwise(case, masked, q):
    f, alpha, y, c = CASES[case]
    valid = _valid(len(y), masked)
    jw, jok, jbh, jbl = jblock.select_block(
        jnp.asarray(f), jnp.asarray(alpha), jnp.asarray(y), c, q,
        valid=None if valid is None else jnp.asarray(valid), rule="nu")
    tw, tok, tbh, tbl = tblock.select_block(
        torch.as_tensor(f), torch.as_tensor(alpha), torch.as_tensor(y), c, q,
        valid=None if valid is None else torch.as_tensor(valid), rule="nu")
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert _bits(tbh) == _bits(jbh) and _bits(tbl) == _bits(jbl)


def test_select_block_nu_masks_only_live_duplicates_within_a_class():
    """Free points sit in both quarters of their class: the low copy is
    masked, and every live slot is a distinct row of the quarter's
    class."""
    f, alpha, y, c = CASES["weighted"]
    w, ok, _, _ = tblock.select_block(torch.as_tensor(f),
                                      torch.as_tensor(alpha),
                                      torch.as_tensor(y), c, 64, rule="nu")
    live = w[ok].numpy()
    assert len(set(live.tolist())) == len(live)
    assert (y[w[:32].numpy()[ok[:32].numpy()]] > 0).all()
    assert (y[w[32:].numpy()[ok[32:].numpy()]] < 0).all()


def _nu_inputs(q, seed=0):
    """A working set that select_block(rule="nu") picks from a nu-SVC
    state of blobs: (kb, kd, ok, a, y, f) float32 numpy."""
    from dpsvm_tpu.data.synth import make_blobs_binary
    from dpsvm_tpu.ops.kernels import KernelParams, kernel_matrix

    x, y = make_blobs_binary(n=300, d=8, seed=3, sep=1.2)
    rng = np.random.default_rng(seed)
    alpha = rng.choice([0.0, 1.0, 0.3, 0.7], size=len(y)).astype(np.float32)
    K = np.asarray(kernel_matrix(x, x, KernelParams("rbf", 0.2)))
    yf = y.astype(np.float32)
    f = ((alpha * yf) @ K).astype(np.float32)
    w, ok, _, _ = jblock.select_block(jnp.asarray(f), jnp.asarray(alpha),
                                      jnp.asarray(yf), 1.0, q, rule="nu")
    w = np.asarray(w)
    return (K[np.ix_(w, w)].astype(np.float32),
            np.diag(K)[w].astype(np.float32), np.asarray(ok), alpha[w],
            yf[w], f[w])


@pytest.mark.parametrize("limit", [0, 1, 9, 256])
@pytest.mark.parametrize("q", [8, 64, 128])
def test_subproblem_nu_bitwise_both_jax_forms(q, limit):
    """The plain nu rule: the same pair count and alpha bits as JAX's
    XLA form and its Pallas kernel in interpret mode, on per-class
    quarters, down to a cut budget."""
    kb, kd, ok, a, y, f = _nu_inputs(q)
    a_t, _, t_t = tsub._solve_subproblem(
        *map(torch.as_tensor, (kb, kd, ok, a, y, f)), 1.0, EPS, TAU, limit,
        "nu")
    a_x, _, t_x = jblock._solve_subproblem(
        *map(jnp.asarray, (kb, kd, ok, a, y, f)), 1.0, EPS, TAU,
        jnp.int32(limit), rule="nu")
    a_p, t_p = solve_subproblem_pallas(
        *map(jnp.asarray, (kb, a, y, f, kd)), jnp.asarray(ok, jnp.float32),
        jnp.int32(limit), 1.0, EPS, TAU, rule="nu", interpret=True)
    assert int(t_t) == int(t_x) == int(t_p) <= limit
    if limit:
        assert int(t_t) > 0
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_x))
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_p))


def test_subproblem_nu_keeps_each_class_sum():
    """Both pair members share a class, so sum(alpha) of each class is
    conserved (up to float32 rounding)."""
    kb, kd, ok, a, y, f = _nu_inputs(64)
    a_t, _, t = tsub._solve_subproblem(
        *map(torch.as_tensor, (kb, kd, ok, a, y, f)), 1.0, EPS, TAU, 500,
        "nu")
    a_t = a_t.numpy().astype(np.float64)
    assert int(t) > 0
    for cls in (y > 0, y < 0):
        assert abs(a_t[cls].sum() - a[cls].astype(np.float64).sum()) < 1e-5


def test_block_height_keeps_quarters():
    for ws, n, want in ((128, 10_000, 128), (130, 10_000, 128),
                        (6, 10_000, 4), (2, 10_000, 4), (256, 103, 100)):
        cfg = SVMConfig(engine="block", working_set_size=ws, selection="nu")
        assert block_height(cfg, n)[0] == want
    assert block_height(SVMConfig(working_set_size=130), 10_000)[0] == 130


@pytest.mark.parametrize("knob", ["fused_fold", "fused_round",
                                  "pipeline_rounds"])
def test_choose_engine_runs_the_plain_round_under_nu(knob):
    kw = {knob: True} if knob != "pipeline_rounds" else {}
    cfg = SVMConfig(engine="block", working_set_size=64, selection="nu",
                    **kw)
    for dev in ("cpu", "cuda"):
        eng = choose_engine(cfg, 60_000, torch.device(dev))
        assert not (eng["pipelined"] or eng["fused_round"]
                    or eng["fused_fold"] or eng["pad"])
        assert eng["n_pad"] == 60_000
    # The same knob on mvp does take the fused engine.
    if knob != "pipeline_rounds":
        mvp = choose_engine(cfg.replace(selection="mvp"), 60_000,
                            torch.device("cpu"))
        assert mvp[knob]


def test_nu_without_a_warm_start_raises_like_jax(blobs_small):
    x, y = blobs_small
    for eng in ("block", "xla"):
        kw = dict(engine=eng, selection="nu", working_set_size=16)
        with pytest.raises(ValueError, match="train_nusvc") as ej:
            jax_solve(x, y, JaxConfig(**kw))
        with pytest.raises(ValueError, match="train_nusvc") as et:
            solve(x, y, SVMConfig(**kw), device="cpu")
        assert str(et.value) == str(ej.value)


def _nusvc_start(x, y, nu):
    """The nu-SVC warm start of the JAX package's trainer."""
    from dpsvm_tpu.models.nusvm import _capped_fill
    from dpsvm_tpu.ops.kernels import KernelParams, blocked_kernel_matvec

    n = len(y)
    alpha0 = np.zeros(n, np.float32)
    for idx in (np.nonzero(y > 0)[0], np.nonzero(y < 0)[0]):
        alpha0[idx] = _capped_fill(len(idx), nu * n / 2.0, 1.0)
    f0 = blocked_kernel_matvec(x, alpha0 * y, KernelParams("rbf", 0.05))
    return alpha0, f0


def _changed_per_step(traj):
    return [tuple(np.nonzero(b != a)[0]) for a, b in zip(traj, traj[1:])]


def test_first_nu_pairs_are_jaxs(blobs_medium):
    """The per-pair nu step: the first 15 trips from the nu-SVC start
    update the same coordinates as JAX's (JAX observed after every trip
    with a chunk_iters=1 callback, the port re-run with max_iter = 1 ..
    15)."""
    x, y = blobs_medium
    alpha0, f0 = _nusvc_start(x, y, 0.3)
    kw = dict(c=1.0, gamma=0.05, selection="nu")
    seen = [alpha0]

    def record(it, b_hi, b_lo, state):
        seen.append(np.array(state.alpha)[:len(y)])

    jax_solve(x, y, JaxConfig(**kw, chunk_iters=1, max_iter=15),
              callback=record, alpha_init=alpha0, f_init=f0)
    port = [alpha0] + [
        solve(x, y, SVMConfig(**kw, max_iter=t), device="cpu",
              alpha_init=alpha0, f_init=f0).alpha for t in range(1, 16)]
    assert len(seen) == len(port) == 16
    assert _changed_per_step(port) == _changed_per_step(seen)
    np.testing.assert_allclose(port[-1], seen[-1], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kw", [dict(engine="block", working_set_size=32),
                                dict(engine="xla"),
                                dict(engine="xla", cache_lines=8),
                                dict(engine="block", working_set_size=32,
                                     compensated=True)],
                         ids=["block", "xla", "xla-cache", "block-kahan"])
def test_nu_solve_matches_jax(blobs_small, kw):
    """A warm-started nu solve: converged in both packages, the dual
    objective within rel 1e-4 and the SV count within 2%, and each
    class's sum(alpha) kept."""
    x, y = blobs_small
    alpha0, f0 = _nusvc_start(x, y, 0.4)
    cfg = dict(c=1.0, gamma=0.05, selection="nu", **kw)
    rt = solve(x, y, SVMConfig(**cfg), device="cpu", alpha_init=alpha0,
               f_init=f0)
    rj = jax_solve(x, y, JaxConfig(**cfg), alpha_init=alpha0, f_init=f0)
    assert rt.converged and rj.converged

    def obj(r):
        a = r.alpha.astype(np.float64)
        return float(0.5 * np.sum(a * y * r.stats["f"]))

    assert abs(obj(rt) - obj(rj)) <= 1e-4 * abs(obj(rj))
    assert abs(rt.n_sv - rj.n_sv) <= max(1, 0.02 * rj.n_sv)
    for cls in (y > 0, y < 0):
        assert abs(rt.alpha[cls].astype(np.float64).sum()
                   - alpha0[cls].astype(np.float64).sum()) < 1e-3
