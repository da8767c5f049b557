"""The port's block subproblem (kernel B1's plain version and its
wrapper) against the JAX package: the XLA while_loop
(solver/block.py _solve_subproblem) and the Pallas kernel in interpret
mode (ops/pallas_subproblem.py solve_subproblem_pallas), on working sets
that select_block picks. Same pair count; alpha within rtol 1e-6 /
atol 1e-7, the tolerance tests/test_block_engine.py holds the Pallas
kernel to.

The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py
holds it against the plain version there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpsvm_tpu.ops.kernels import KernelParams, kernel_matrix
from dpsvm_tpu.ops.pallas_subproblem import solve_subproblem_pallas
from dpsvm_tpu.solver import block as jblock
from dpsvm_tpu_torch.ops import subproblem as tsub

C, EPS, TAU = 1.0, 1e-3, 1e-12
RTOL, ATOL = 1e-6, 1e-7


def _inputs(q, c=C, seed=0):
    """(kb, kd, ok, a, y, f) float32 numpy for a real working set of
    mid-solve blobs."""
    from dpsvm_tpu.data.synth import make_blobs_binary

    x, y = make_blobs_binary(n=300, d=10, seed=3, sep=1.2)
    cp, cn = c if isinstance(c, tuple) else (c, c)
    rng = np.random.default_rng(seed)
    alpha = np.clip(rng.normal(0.5, 0.5, len(y)), 0, min(cp, cn)).astype(np.float32)
    K = np.asarray(kernel_matrix(x, x, KernelParams("rbf", 0.2)))
    f = ((alpha * y) @ K - y).astype(np.float32)
    yf = y.astype(np.float32)
    w, ok, _, _ = jblock.select_block(jnp.asarray(f), jnp.asarray(alpha),
                                      jnp.asarray(yf), c, q)
    w = np.asarray(w)
    return (K[np.ix_(w, w)].astype(np.float32),
            np.diag(K)[w].astype(np.float32), np.asarray(ok), alpha[w],
            yf[w], f[w])


def _port(kb, kd, ok, a, y, f, limit, rule, c=C, eps=EPS, pair_batch=1):
    a_t, _, t = tsub._solve_subproblem(
        *map(torch.as_tensor, (kb, kd, ok, a, y, f)), c, eps, TAU, limit,
        rule, pair_batch)
    return a_t.numpy(), int(t)


@pytest.mark.parametrize("rule,pair_batch", [
    pytest.param("mvp", 1, id="mvp"),
    pytest.param("second_order", 1, id="second_order"),
    pytest.param("mvp", 2, id="mvp-pair_batch2"),
    pytest.param("mvp", 4, id="mvp-pair_batch4"),
    pytest.param("nu", 1, id="nu")])
@pytest.mark.parametrize("q", [32, 100, 128])
def test_plain_matches_jax_xla_and_pallas(q, rule, pair_batch):
    kb, kd, ok, a, y, f = _inputs(q)
    limit = 2 * q
    a_t, t_t = _port(kb, kd, ok, a, y, f, limit, rule,
                     pair_batch=pair_batch)
    a_x, _, t_x = jblock._solve_subproblem(
        *map(jnp.asarray, (kb, kd, ok, a, y, f)), C, EPS, TAU,
        jnp.int32(limit), rule=rule, pair_batch=pair_batch)
    a_p, t_p = solve_subproblem_pallas(
        *map(jnp.asarray, (kb, a, y, f, kd)), jnp.asarray(ok, jnp.float32),
        jnp.int32(limit), C, EPS, TAU, rule=rule, interpret=True,
        pair_batch=pair_batch)
    assert t_t == int(t_x) == int(t_p) > 0
    np.testing.assert_allclose(a_t, np.asarray(a_x), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(a_t, np.asarray(a_p), rtol=RTOL, atol=ATOL)
    if pair_batch > 1 or rule == "nu":
        # The extra slots, their gating and the two-FMA f_W update
        # included (and the nu rule's class choice): the same bits as
        # both JAX forms.
        np.testing.assert_array_equal(a_t, np.asarray(a_x))
        np.testing.assert_array_equal(a_t, np.asarray(a_p))


@pytest.mark.parametrize("pair_batch", [2, 4])
@pytest.mark.parametrize("limit,c,seed", [
    (0, C, 0), (1, C, 0), (7, C, 1), (9, (0.9, 0.4), 1), (301, 0.3, 2)])
def test_pair_batch_counts_and_gates_like_jax(pair_batch, limit, c, seed):
    """Attempted slots count while the budget lasts (an odd limit cuts a
    trip short), collisions and emptied stale sets gate to no-ops, and
    the weighted box rides along: pair count and alpha are JAX's."""
    kb, kd, ok, a, y, f = _inputs(32, c=c, seed=seed)
    a_t, t_t = _port(kb, kd, ok, a, y, f, limit, "mvp", c=c,
                     pair_batch=pair_batch)
    a_x, _, t_x = jblock._solve_subproblem(
        *map(jnp.asarray, (kb, kd, ok, a, y, f)), c, EPS, TAU,
        jnp.int32(limit), rule="mvp", pair_batch=pair_batch)
    assert t_t == int(t_x) <= limit
    np.testing.assert_array_equal(a_t, np.asarray(a_x))


def test_pair_batch_budget_mode_and_dead_slots_match_jax():
    """eps = -1e30 runs to the limit through emptied sets (the stale
    argmin aliases slot 0 and is gated), with half the slots dead."""
    kb, kd, ok, a, y, f = _inputs(32)
    ok = ok.copy()
    ok[::2] = False
    for pb in (2, 4):
        a_t, t_t = _port(kb, kd, ok, a, y, f, 200, "mvp", eps=-1e30,
                         pair_batch=pb)
        a_x, _, t_x = jblock._solve_subproblem(
            *map(jnp.asarray, (kb, kd, ok, a, y, f)), C, -1e30, TAU,
            jnp.int32(200), rule="mvp", pair_batch=pb)
        assert t_t == int(t_x) == 200
        np.testing.assert_array_equal(a_t, np.asarray(a_x))


@pytest.mark.parametrize("limit", [0, 1, 7])
@pytest.mark.parametrize("c", [0.3, (0.9, 0.4)])
def test_budget_and_weighted_box_match_jax(c, limit):
    kb, kd, ok, a, y, f = _inputs(64, c=c, seed=1)
    for rule in ("mvp", "second_order"):
        a_t, t_t = _port(kb, kd, ok, a, y, f, limit, rule, c=c)
        a_x, _, t_x = jblock._solve_subproblem(
            *map(jnp.asarray, (kb, kd, ok, a, y, f)), c, EPS, TAU,
            jnp.int32(limit), rule=rule)
        assert t_t == int(t_x) == limit
        np.testing.assert_allclose(a_t, np.asarray(a_x), rtol=RTOL, atol=ATOL)


def test_budget_mode_eps_counts_no_op_trips_like_jax():
    """eps = -1e30 keeps the gap open; second_order then counts trips
    without an eligible partner as no-ops instead of stalling."""
    kb, kd, ok, a, y, f = _inputs(32)
    for rule in ("mvp", "second_order"):
        a_t, t_t = _port(kb, kd, ok, a, y, f, 300, rule, eps=-1e30)
        a_x, _, t_x = jblock._solve_subproblem(
            *map(jnp.asarray, (kb, kd, ok, a, y, f)), C, -1e30, TAU,
            jnp.int32(300), rule=rule)
        assert t_t == int(t_x) == 300
        np.testing.assert_allclose(a_t, np.asarray(a_x), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("rule", ["mvp", "second_order"])
def test_rows_read_collects_the_visited_gram_rows(rule):
    """The set of rows the plain solve reads (the bound's bytes count):
    live slots only, at most two per pair, covering every slot whose
    alpha moved, and collecting it leaves the result unchanged."""
    kb, kd, ok, a, y, f = _inputs(100)
    rows = set()
    a_t, _, t = tsub._solve_subproblem(
        *map(torch.as_tensor, (kb, kd, ok, a, y, f)), C, EPS, TAU, 200,
        rule, rows_read=rows)
    a_p, t_p = _port(kb, kd, ok, a, y, f, 200, rule)
    assert int(t) == t_p > 0
    np.testing.assert_array_equal(a_t.numpy(), a_p)
    assert 2 <= len(rows) <= min(2 * t_p, 100)
    assert all(ok[r] for r in rows)
    assert set(np.nonzero(a_p != a)[0]) <= rows


def test_wrapper_takes_plain_path_on_cpu():
    kb, kd, ok, a, y, f = _inputs(100)
    tsub.solve_subproblem.launches = 0
    a_w, t = tsub.solve_subproblem(
        *map(torch.as_tensor, (kb, a, y, f, kd)),
        torch.as_tensor(ok.astype(np.float32)), torch.tensor(200, dtype=torch.int32),
        C, EPS, TAU, rule="second_order")
    assert tsub.solve_subproblem.launches == 0
    assert t.dtype == torch.int32 and t.dim() == 0
    a_p, t_p = _port(kb, kd, ok, a, y, f, 200, "second_order")
    assert int(t) == t_p
    np.testing.assert_array_equal(a_w.numpy(), a_p)


def test_unported_rules_raise():
    """An unknown rule and a pair batch other than mvp's 2 or 4 raise, as
    in the JAX package; the nu rule runs. (The name dates from when the
    port refused the nu rule.)"""
    kb, kd, ok, a, y, f = _inputs(32)
    args = (*map(torch.as_tensor, (kb, a, y, f, kd)),
            torch.as_tensor(ok.astype(np.float32)), 10, C, EPS, TAU)
    with pytest.raises(ValueError, match="unknown"):
        tsub.solve_subproblem(*args, rule="wss3")
    with pytest.raises(ValueError, match="mvp"):
        tsub.solve_subproblem(*args, rule="nu", pair_batch=2)
    a_w, t = tsub.solve_subproblem(*args, rule="nu")
    a_p, t_p = _port(kb, kd, ok, a, y, f, 10, "nu")
    assert int(t) == t_p
    np.testing.assert_array_equal(a_w.numpy(), a_p)
    with pytest.raises(ValueError, match="mvp"):
        tsub.solve_subproblem(*args, rule="second_order", pair_batch=2)
    with pytest.raises(ValueError, match="1, 2 or 4"):
        tsub.solve_subproblem(*args, rule="mvp", pair_batch=8)
    a_w, t = tsub.solve_subproblem(*args, rule="mvp", pair_batch=2)
    a_p, t_p = _port(kb, kd, ok, a, y, f, 10, "mvp", pair_batch=2)
    assert int(t) == t_p == 10
    np.testing.assert_array_equal(a_w.numpy(), a_p)


def test_wrapper_rejects_bad_inputs():
    kb, kd, ok, a, y, f = _inputs(32)
    t = [torch.as_tensor(v) for v in (kb, a, y, f, kd)]
    okf = torch.as_tensor(ok.astype(np.float32))
    with pytest.raises(ValueError, match="float32"):
        tsub.solve_subproblem(t[0].double(), *t[1:], okf, 10, C, EPS, TAU)
    with pytest.raises(ValueError, match="float32"):
        tsub.solve_subproblem(t[0], t[1][:31], *t[2:], okf, 10, C, EPS, TAU)
    with pytest.raises(ValueError, match="contiguous"):
        tsub.solve_subproblem(t[0].t(), *t[1:], okf, 10, C, EPS, TAU)


def test_box_constants_round_like_pair_alpha_update():
    """Equal weights: the snap constants are Python-double products
    rounded once; unequal: float32 arithmetic on the per-row bound."""
    c1, c2, s1, s2, m1, m2 = tsub._box_consts(3.0)
    assert c1 == c2 == np.float32(3.0)
    assert s1 == s2 == np.float32(3e-6) and m1 == np.float32(3.0 - 3e-6)
    c1, c2, s1, s2, m1, m2 = tsub._box_consts((0.3, 0.7))
    assert s1 == np.float32(1e-6) * np.float32(0.3)
    assert m2 == np.float32(0.7) - np.float32(np.float32(1e-6) * np.float32(0.7))


def test_kernel_build_raises_without_nvcc(monkeypatch):
    """No silent fallback: where nvcc is missing the build raises, and the
    library it would build lives under the checkout's build/ directory."""
    from dpsvm_tpu_torch.ops import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()
    path = _build._lib_path("subproblem")
    assert path.startswith(_build.BUILD_DIR)
    assert "-fmad=false" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_plan_covers_every_q():
    """Kernel B1's launch plan (what the wrapper passes to the kernel, and
    the kernel checks) for every q the kernel takes: one CTA (no cluster)
    whose threads' slots cover the q slots with no idle warp, one slot a
    thread up to q = 256, 2 up to 2048, 4 beyond, at most 32 warps (their
    records fill 32 places); its shared memory within sm_90's 232,448
    bytes with the on-chip rows of K(W, W) in it, as many as fit, a
    multiple of 4 so that they are one 16-byte bulk copy. q up to 236
    holds all of K(W, W) on chip, q = 256 the first 216 rows."""
    for q in range(1, 4097):
        p = tsub.subproblem_plan(q)
        assert p.slots == (1 if q <= 256 else 2 if q <= 2048 else 4)
        assert p.threads % 32 == 0 and 32 <= p.threads <= 1024
        assert p.threads * p.slots >= q > (p.threads - 32) * p.slots
        assert 0 <= p.nchip <= q and p.nchip * q % 4 == 0
        assert p.smem == tsub._HEAD_BYTES + 4 * p.nchip * q + 8 * q
        assert p.smem <= tsub.SMEM_LIMIT
        # Four more rows would not fit, unless all rows are on chip.
        assert p.nchip == q - q % 4 or p.smem + 16 * q > tsub.SMEM_LIMIT
        assert tsub.subproblem_plan(q, aligned=False).nchip == 0
    assert tsub.subproblem_plan(236).nchip == 236
    assert tsub.subproblem_plan(256) == (256, 1, 216, 228368)
    with pytest.raises(ValueError, match="4096"):
        tsub.subproblem_plan(4097)
