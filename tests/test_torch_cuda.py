"""Tests that need the CUDA card (marked `cuda`; they skip elsewhere).

The hand-written kernels have no CPU form, so they are held against
their plain PyTorch versions on the card. This file imports neither jax
nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import functools

import numpy as np
import pytest
import torch

from dpsvm_tpu_torch.autotune import use_profile
from dpsvm_tpu_torch import Mesh, SVMConfig, solve, solve_mesh
from dpsvm_tpu_torch.data.synth import make_blobs_binary
from dpsvm_tpu_torch.ops import cache_fill as tcf
from dpsvm_tpu_torch.ops import fold_select as tfs
from dpsvm_tpu_torch.ops import fused_update as tfu
from dpsvm_tpu_torch.ops import ring as tring
from dpsvm_tpu_torch.ops import round as tround
from dpsvm_tpu_torch.ops import subproblem as tsub
from dpsvm_tpu_torch.ops.kernels import (KernelParams, kernel_from_dots,
                                         kernel_matrix, squared_norms)
from dpsvm_tpu_torch.solver.block import select_block

C, EPS, TAU = 1.0, 1e-3, 1e-12
# Kernel B1's q: each variant of ops/subproblem.py subproblem_plan.
B1_QS = [64, 100, 128, 129, 256, 257, 400, 512, 1500, 3000]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU form")
    # Written against the auto gates' defaults: no device profile
    # resolves a None knob here (autotune/profile.py).
    with use_profile(None):
        yield torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rule,pair_batch", [
    pytest.param("mvp", 1, id="mvp"),
    pytest.param("second_order", 1, id="second_order"),
    pytest.param("mvp", 2, id="mvp-pair_batch2"),
    pytest.param("mvp", 4, id="mvp-pair_batch4")])
@pytest.mark.parametrize("q", B1_QS)
def test_subproblem_kernel_matches_plain(cuda, q, rule, pair_batch):
    """Kernel B1 against the plain version on the same CUDA tensors:
    same pair count; alpha within rtol 1e-6 / atol 1e-7 (bitwise is
    expected). q picks every variant of subproblem_plan: the Gram block
    on chip in one CTA (64, 128, 129), in a cluster of 2 (256, 257), 4
    (400) and 8 (512) CTAs, and through L2 with one (100 on its own
    would be on chip), two and four slots a thread (1500, 3000); odd q
    load the columns without bulk copies. pair_batch 2 and 4 add the
    stale-ranked extra pairs of a trip."""
    x, y = make_blobs_binary(n=4000, d=10, seed=3, sep=1.2)
    rng = np.random.default_rng(0)
    alpha = np.clip(rng.normal(0.5, 0.5, len(y)), 0, C).astype(np.float32)
    xt = torch.as_tensor(x, device=cuda)
    K = kernel_matrix(xt, xt, KernelParams("rbf", 0.2))
    yt = torch.as_tensor(y.astype(np.float32), device=cuda)
    at = torch.as_tensor(alpha, device=cuda)
    f = (at * yt) @ K - yt
    w, ok, _, _ = select_block(f, at, yt, C, q)
    kb = K[w][:, w].contiguous()
    args = (kb, at[w], yt[w], f[w], torch.diagonal(K)[w].contiguous(),
            ok.float())
    lim = torch.tensor(2 * q, dtype=torch.int32, device=cuda)
    tsub.solve_subproblem.launches = 0
    a_k, t_k = tsub.solve_subproblem(*args, lim, C, EPS, TAU, rule=rule,
                                     pair_batch=pair_batch)
    torch.cuda.synchronize()
    assert tsub.solve_subproblem.launches == 1
    a_p, _, t_p = tsub._solve_subproblem(kb, args[4], ok, args[1], args[2],
                                         args[3], C, EPS, TAU, 2 * q, rule,
                                         pair_batch)
    assert int(t_k) == int(t_p) > 0
    np.testing.assert_allclose(a_k.cpu().numpy(), a_p.cpu().numpy(),
                               rtol=1e-6, atol=1e-7)
    if pair_batch > 1:
        assert _same_bits(a_k, a_p)


def _nu_subproblem_args(dev, q, case, seed=0):
    """A nu-SVC-like working set that select_block(rule="nu") picks: per
    class alpha in [0, 1] with a margin of free points. `case` "mixed"
    keeps both classes' quarters; "one_class" flips W to a single class
    (the other's extrema are empty, +-inf); "ties" rounds f so several
    slots share each extremum."""
    x, y = make_blobs_binary(n=4000, d=10, seed=3, sep=1.2)
    rng = np.random.default_rng(seed)
    alpha = rng.choice([0.0, 1.0, 0.3, 0.7], size=len(y)).astype(np.float32)
    xt = torch.as_tensor(x, device=dev)
    K = kernel_matrix(xt, xt, KernelParams("rbf", 0.2))
    yt = torch.as_tensor(y.astype(np.float32), device=dev)
    at = torch.as_tensor(alpha, device=dev)
    f = (at * yt) @ K
    if case == "ties":
        f = torch.round(f * 4.0) / 4.0
    w, ok, _, _ = select_block(f, at, yt, 1.0, q, rule="nu")
    kb = K[w][:, w].contiguous()
    yw = yt[w].clone()
    if case == "one_class":
        yw = torch.ones_like(yw)
    return (kb, at[w].contiguous(), yw, f[w].contiguous(),
            torch.diagonal(K)[w].contiguous(), ok.float())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mixed", "one_class", "ties"])
@pytest.mark.parametrize("q", B1_QS)
def test_subproblem_kernel_nu_rule_bitwise_plain(cuda, q, case):
    """Kernel B1's nu rule (per-class extrema, the class by the float32
    violation test) against its plain version: the same pair count and
    the same alpha bits, on every variant of subproblem_plan (q rounded
    down to a multiple of 4, the nu working set's quarters). q = 100
    keeps a quarter of 25 slots."""
    q4 = q - q % 4
    args = _nu_subproblem_args(cuda, q4, case)
    lim = torch.tensor(2 * q4, dtype=torch.int32, device=cuda)
    tsub.solve_subproblem.launches = 0
    a_k, t_k = tsub.solve_subproblem(*args, lim, 1.0, EPS, TAU, rule="nu")
    torch.cuda.synchronize()
    assert tsub.solve_subproblem.launches == 1
    kb, a0, yw, f0, kd, ok = args
    a_p, _, t_p = tsub._solve_subproblem(kb, kd, ok > 0, a0, yw, f0, 1.0,
                                         EPS, TAU, 2 * q4, "nu")
    assert int(t_k) == int(t_p) > 0
    assert _same_bits(a_k, a_p)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_solve_on_card_matches_cpu(cuda, dtype):
    """The whole solve on the card (kernel B1, cuBLAS folds) reaches the
    optimum of the CPU plain path: dual objective within rel 1e-4."""
    x, y = make_blobs_binary(n=1200, d=24, seed=11, sep=1.0)
    cfg = SVMConfig(c=1.0, gamma=0.1, engine="block", working_set_size=64,
                    dtype=dtype)
    tsub.solve_subproblem.launches = 0
    rg = solve(x, y, cfg)
    assert tsub.solve_subproblem.launches == rg.stats["outer_rounds"] > 0
    rc = solve(x, y, cfg, device="cpu")
    assert rg.converged and rc.converged

    def obj(r):
        a, f = r.alpha.astype(np.float64), r.stats["f"].astype(np.float64)
        return float(a.sum() - 0.5 * np.sum(a * y * (f + y)))

    assert abs(obj(rg) - obj(rc)) <= 1e-4 * abs(obj(rc))
    assert abs(rg.n_sv - rc.n_sv) <= 0.02 * rc.n_sv


def _views(dev, rows, seed, c=(2.0, 0.5)):
    """(f, err, alpha, y, valid, delta) (rows, 128) float32 on `dev`, with
    alpha at 0, at C and inside the box, and a padded tail."""
    rng = np.random.default_rng(seed)
    n = rows * 128
    cp, cn = c if isinstance(c, tuple) else (c, c)
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    c_row = np.where(y > 0, cp, cn).astype(np.float32)
    pick = rng.integers(0, 3, n)
    alpha = np.where(pick == 0, 0.0, np.where(pick == 1, c_row,
                     rng.random(n) * c_row)).astype(np.float32)
    f = rng.normal(size=n).astype(np.float32)
    f[:300] = np.round(f[:300] * 4) / 4  # ties inside and across rows
    err = (rng.normal(size=n) * 1e-7).astype(np.float32)
    delta = (rng.normal(size=n) * 0.05).astype(np.float32)
    valid = np.ones(n, np.float32)
    valid[-150:] = 0.0
    return [torch.as_tensor(a.reshape(rows, 128), device=dev)
            for a in (f, err, alpha, y, valid, delta)]


def _same_bits(a, b):
    if a is None or b is None:
        return a is None and b is None
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _edge_views(dev, rows, seed, c):
    """_views with B2 and B3's edges planted, as far as `rows` reaches:
    row 0 has +-0 ties on the up side across lanes (+0.0 in lane 1, -0.0
    in lanes 17 and 30, everything else above zero), row 1 on the low
    side (-0.0 in lane 3, +0.0 in lane 20, everything else below zero),
    row 2 only -0.0 on the low side; row 3 has no I_up member, row 4 no
    I_low member, row 5 is all padding; rows 6 and 7 share their
    extremum (ties across the rows a block holds); the last 150 elements
    are padding. delta is -0.0 on rows 0-2, so f' keeps the zeros'
    signs."""
    f, err, alpha, y, valid, delta = _views(dev, rows, seed, c)
    cp = c[0] if isinstance(c, tuple) else c
    plant = {0: ([4, 68, 120], [0.0, -0.0, -0.0], 1.0),
             1: ([12, 80], [-0.0, 0.0], -1.0),
             2: ([8, 9], [-0.0, -0.0], -1.0)}
    for r, (cols, zeros, sign) in plant.items():
        if r >= rows:
            continue
        f[r] = sign * (1.0 + f[r].abs())
        alpha[r] = 0.5 * min(cp, 0.5)  # inside the box: both sets
        err[r] = 0.0
        delta[r] = -0.0
        f[r, cols] = torch.tensor(zeros, device=dev)
        valid[r] = 1.0
    if rows > 4:
        y[3:5] = 1.0
        alpha[3] = cp  # y = +1 at C: in no I_up
        alpha[4] = 0.0  # y = +1 at 0: in no I_low
        valid[3:5] = 1.0
    if rows > 5:
        valid[5] = 0.0
    if rows > 7:
        f[6:8] = 3.0
        f[6:8, 40:] = -3.0
        valid[6:8] = 1.0
        alpha[6:8] = 0.5 * min(cp, 0.5)
    return f, err, alpha, y, valid, delta


@pytest.mark.cuda
@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("rows", [1, 37, 472, 3912])
@pytest.mark.parametrize("c", [1.0, (2.0, 0.5)])
def test_fold_select_and_select_rows_kernels_bitwise(cuda, rows,
                                                     compensated, c):
    """B2 and B3 against their plain versions on the same CUDA tensors,
    bit for bit (one Kahan step or one add per element, comparisons
    only), at 1 row, 37, the headline's 472 and covtype scale's 3912, on
    views with +-0 ties across lanes, rows with no up or no low member,
    ties across rows and padded rows (_edge_views)."""
    f, err, alpha, y, valid, delta = _edge_views(cuda, rows, rows, c)
    tfs.fold_select.launches = tfs.select_rows.launches = 0
    got = tfs.fold_select(f, err, alpha, y, valid, delta, c,
                          compensated=compensated)
    want = tfs._fold_select(f, err, alpha, y, valid, delta, c, compensated)
    sel = tfs.select_rows(f, alpha, y, valid, c)
    torch.cuda.synchronize()
    assert tfs.fold_select.launches == tfs.select_rows.launches == 1
    assert all(_same_bits(g, w) for g, w in zip(got, want))
    assert all(_same_bits(g, w) for g, w in
               zip(sel, tfs._select_rows(f, alpha, y, valid, c)))
    if rows > 5:  # the planted edges reached the kernels' output
        up_vals, up_ids, low_vals, low_ids = sel
        assert float(up_vals[0]) == 0.0 and torch.signbit(up_vals[0])
        assert int(up_ids[0]) == 4
        assert float(low_vals[1]) == 0.0 and not torch.signbit(low_vals[1])
        assert int(low_ids[1]) == 128 + 12
        assert torch.signbit(low_vals[2]) and int(low_ids[2]) == 256 + 8
        assert float(up_vals[3]) == np.inf and int(up_ids[3]) == 3 * 128
        assert float(low_vals[4]) == -np.inf and int(low_ids[4]) == 4 * 128
        assert float(up_vals[5]) == np.inf and int(low_ids[5]) == 5 * 128


@pytest.mark.cuda
@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("rows", [1, 37, 473, 3912])
def test_fold_select_every_plan_matches_the_kept_one(cuda, rows,
                                                     compensated):
    """Every B2 / B3 launch plan (ops/fold_select.py FoldSelectPlan: warps
    a block 1, 2, 3, 4 and 8) covers every row once and gives B2's and
    B3's outputs bitwise those of the kept plan (fold_select_plan) and of
    the plain versions."""
    c = (2.0, 0.5)
    f, err, alpha, y, valid, delta = _edge_views(cuda, rows, 7 * rows, c)
    so = tfs.lib()
    kept = tfs.fold_select_plan(rows)
    want2 = tfs._fold_launch(f, err, alpha, y, valid, delta, c, compensated,
                             kept, so)
    want3 = tfs._select_launch(f, alpha, y, valid, c, kept, so)
    plain2 = tfs._fold_select(f, err, alpha, y, valid, delta, c, compensated)
    plain3 = tfs._select_rows(f, alpha, y, valid, c)
    assert all(_same_bits(g, w) for g, w in zip(want2, plain2))
    assert all(_same_bits(g, w) for g, w in zip(want3, plain3))
    for warps in (1, 2, 3, 4, 8):
        plan = tfs.FoldSelectPlan(warps, -(-rows // warps))
        got2 = tfs._fold_launch(f, err, alpha, y, valid, delta, c,
                                compensated, plan, so)
        got3 = tfs._select_launch(f, alpha, y, valid, c, plan, so)
        torch.cuda.synchronize()
        assert all(_same_bits(g, w) for g, w in zip(got2, want2)), plan
        assert all(_same_bits(g, w) for g, w in zip(got3, want3)), plan


@pytest.mark.cuda
@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("q,rows", [(16, 8), (100, 37), (256, 472)])
def test_fold_rows_select_kernel_matches_plain(cuda, q, rows, compensated):
    """B5: f' within rtol 1e-6 of the plain version plus 2e-6 of the
    contraction's absolute sum (the kernel sums coef @ K in order k, the
    GEMM in its own); candidates bitwise those of the plain emission from
    the kernel's own f' (and err')."""
    f, err, alpha, y, valid, _ = _views(cuda, rows, q)
    g = torch.Generator(device="cpu").manual_seed(q)
    k_rows = torch.rand((q, rows * 128), generator=g).to(cuda)
    coef = (torch.randn(q, generator=g) * 0.1).to(cuda)
    coef[::7] = 0.0  # dead slots
    tround.fold_rows_select.launches = 0
    got = tround.fold_rows_select(k_rows, coef, f, err, alpha, y, valid,
                                  1.0, compensated=compensated)
    want = tround._fold_rows_select(k_rows, coef, f, err, alpha, y, valid,
                                    1.0, compensated)
    torch.cuda.synchronize()
    assert tround.fold_rows_select.launches == 1
    scale = (coef.abs() @ k_rows).view(f.shape)
    assert bool(((got[0] - want[0]).abs()
                 <= 1e-6 * want[0].abs() + 2e-6 * scale).all())
    f_sel = got[0] if not compensated else got[0] - got[1]
    emitted = tfs.emit_row_candidates(f_sel, alpha, y, valid, 1.0)
    assert all(_same_bits(a, b) for a, b in zip(got[2:], emitted))


def _rows_inputs(dev, q, rows):
    """B5's inputs: the (rows, 128) views of _views, kernel rows in [0, 1)
    and coefficients with every seventh slot dead, made on the card."""
    f, err, alpha, y, valid, _ = _views(dev, rows, q + rows)
    g = torch.Generator(device=dev).manual_seed(q * 1000 + rows)
    k_rows = torch.rand((q, rows * 128), generator=g, device=dev)
    coef = torch.randn(q, generator=g, device=dev) * 0.1
    coef[::7] = 0.0
    return k_rows, coef, f, err, alpha, y, valid


@pytest.mark.cuda
@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("rows", [1, 37, 472, 473])
@pytest.mark.parametrize("q", [1, 3, 100, 256, 257, 1000, 8192])
def test_fold_rows_select_kernel_every_plan(cuda, q, rows, compensated):
    """B5 over the shapes its launch plan (ops/round.py fold_rows_plan)
    treats apart: one warp (q 1), fewer warps than 4 (q 3), short and
    long warp ranges, a last chunk of fewer rows (257, 1000), the largest
    q, one row and the headline's 472 rows and one more. f' within rtol
    1e-6 of the plain version plus 2e-6 of |coef| @ |K|; candidates
    bitwise the plain emission's from the kernel's own f' (and err')."""
    k_rows, coef, f, err, alpha, y, valid = _rows_inputs(cuda, q, rows)
    tround.fold_rows_select.launches = 0
    got = tround.fold_rows_select(k_rows, coef, f, err, alpha, y, valid,
                                  1.0, compensated=compensated)
    want = tround._fold_rows_select(k_rows, coef, f, err, alpha, y, valid,
                                    1.0, compensated)
    torch.cuda.synchronize()
    assert tround.fold_rows_select.launches == 1
    scale = (coef.abs() @ k_rows).view(f.shape)
    assert bool(((got[0] - want[0]).abs()
                 <= 1e-6 * want[0].abs() + 2e-6 * scale).all())
    f_sel = got[0] if not compensated else got[0] - got[1]
    emitted = tfs.emit_row_candidates(f_sel, alpha, y, valid, 1.0)
    assert all(_same_bits(a, b) for a, b in zip(got[2:], emitted))


@pytest.mark.cuda
@pytest.mark.parametrize("compensated", [False, True])
def test_fold_rows_select_kernel_is_deterministic(cuda, compensated):
    """Two B5 launches on the same inputs give the same bits: the warps'
    partial deltas are added in a fixed order."""
    args = _rows_inputs(cuda, 256, 472)
    got = [tround.fold_rows_select(*args, 1.0, compensated=compensated)
           for _ in range(2)]
    torch.cuda.synchronize()
    assert all(_same_bits(a, b) for a, b in zip(*got))


GATHER_SHAPES = ([(1000, d, q) for d in (10, 37, 784, 800)
                  for q in (2, 72, 256, 320)] + [(4096, 784, 256)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,gamma,degree,coef0", [
    ("rbf", 0.3, 3, 0.0), ("linear", 1.0, 3, 0.0), ("poly", 0.2, 3, 0.5),
    ("sigmoid", 0.1, 3, 0.25)])
@pytest.mark.parametrize("n,d,q", GATHER_SHAPES)
def test_gather_gram_kernel_matches_plain(cuda, n, d, q, kind, gamma,
                                          degree, coef0, dtype):
    """B4 against x[w] + kernel_rows + the Gram expression on the card:
    the sums run in another order than cuBLAS, so |dK| is held to
    gram_tolerance (the dots' worst-case rounding carried through each
    family's slope, plus 4 ulps of K for exp / tanh / pow); with float32
    X also to tf32x3_check against the float64 Gram. d covers
    rows of whole 16-byte chunks (784, 800: the cp.async path, 784 with a
    half-stage K tail) and ragged ones (10, 37: the element path); q one
    M tile short (2), past one (72), a full CTA (256) and two CTAs (320);
    n = 1000 ends inside a data tile; w repeats ids, as dead slots'
    filler does."""
    rng = np.random.default_rng(n + d + q)
    x = torch.as_tensor(rng.random((n, d)).astype(np.float32),
                        device=cuda).to(dtype)
    x_sq = squared_norms(x)
    w_np = rng.integers(0, n, q).astype(np.int32)
    w_np[q // 2] = w_np[0]
    w = torch.as_tensor(w_np, device=cuda)
    kp = KernelParams(kind, gamma, degree, coef0)
    tround.gather_gram.launches = 0
    k_rows, kb = tround.gather_gram(x, w, x_sq, x_sq[w], kp)
    p_rows, p_kb = tround._gather_gram(x, w, x_sq, x_sq[w], kp)
    torch.cuda.synchronize()
    assert tround.gather_gram.launches == 1
    for got, want in ((k_rows, p_rows), (kb, p_kb)):
        assert bool(((got - want).abs()
                     <= tround.gram_tolerance(x_sq, d, kp, want.abs())).all())
    if dtype == torch.float32:  # 3xTF32, not a cheaper product
        ref = tround.gram_f64(x, w, x_sq, x_sq[w], kp)
        err, err_p, limit = tround.tf32x3_check((k_rows, kb), (p_rows, p_kb),
                                                ref, x_sq, kp)
        assert err <= limit, (err, err_p, limit)


@pytest.mark.cuda
@pytest.mark.parametrize("knob", ["fused_fold", "fused_round",
                                  "pipeline_rounds"])
def test_fused_engine_on_card_reaches_cpu_optimum(cuda, knob):
    """A fused engine on the card (kernels B1-B5 as the engine uses them)
    reaches the optimum of the CPU plain engine: dual objective within
    rel 1e-4, SVs within 2%; every round launched its kernels."""
    x, y = make_blobs_binary(n=1500, d=24, seed=11, sep=1.0)
    cfg = SVMConfig(c=1.0, gamma=0.1, engine="block", working_set_size=32)
    counters = (tsub.solve_subproblem, tfs.fold_select, tfs.select_rows,
                tround.gather_gram, tround.fold_rows_select)
    for fn in counters:
        fn.launches = 0
    rg = solve(x, y, cfg.replace(**{knob: True}))
    rc = solve(x, y, cfg, device="cpu")
    rounds = rg.stats["outer_rounds"]
    assert rg.converged and rc.converged and rounds > 0
    assert rg.stats["n_pad"] == 2048
    want = {"fused_fold": (rounds, rounds, 0, 0, 0),
            "fused_round": (rounds, 0, 0, rounds, rounds),
            "pipeline_rounds": (rounds, 0, rounds + 1, 0, 0)}[knob]
    assert tuple(fn.launches for fn in counters) == want

    def obj(r):
        a, f = r.alpha.astype(np.float64), r.stats["f"].astype(np.float64)
        return float(a.sum() - 0.5 * np.sum(a * y * (f + y)))

    assert abs(obj(rg) - obj(rc)) <= 1e-4 * abs(obj(rc))
    assert abs(rg.n_sv - rc.n_sv) <= 0.02 * rc.n_sv


def _ulp_scale(f, scalars, k_hi, k_lo):
    """|f'| plus the two update terms' magnitudes: the scale an ulp of
    exp (or of one rounding) in either kernel value moves f' by."""
    return (f.abs() + (scalars[0] * k_hi).abs()
            + (scalars[1] * k_lo).abs())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rbf", "linear", "poly", "sigmoid"])
@pytest.mark.parametrize("rows", [1, 37, 511, 512, 513, 4096])
def test_fused_update_kernel_matches_plain(cuda, rows, kind):
    """B6 against its plain version on the same CUDA tensors: f' within
    two ulps of the update's scale (expf / tanhf / powf built with
    -fmad=false may differ from torch's by an ulp); the extrema and ids
    exactly those the plain reduction gives from the kernel's own f'."""
    f, _, alpha, y, valid, _ = _views(cuda, rows, rows + 5, c=(2.0, 0.5))
    rng = np.random.default_rng(rows)
    shp = f.shape
    d_hi, d_lo = (torch.as_tensor(rng.normal(size=shp).astype(np.float32),
                                  device=cuda) for _ in range(2))
    x_sq = torch.as_tensor(np.abs(rng.normal(size=shp)).astype(np.float32)
                           * 3, device=cuda)
    scalars = torch.tensor([0.37, -0.21, 1.3, 0.8], device=cuda)
    kp = KernelParams(kind, 0.3, 3, 0.5)
    c = (2.0, 0.5)
    tfu.fused_update_select.launches = 0
    got = tfu.fused_update_select(f, alpha, y, valid, d_hi, d_lo, x_sq,
                                  scalars, kp, c)
    want = tfu._fused_update_select(f, alpha, y, valid, d_hi, d_lo, x_sq,
                                    scalars, kp, c)
    torch.cuda.synchronize()
    assert tfu.fused_update_select.launches == 1
    scale = _ulp_scale(f, scalars,
                       kernel_from_dots(d_hi, x_sq, scalars[2], kp),
                       kernel_from_dots(d_lo, x_sq, scalars[3], kp))
    assert bool(((got[0] - want[0]).abs() <= 2.0 ** -22 * scale).all())
    own = tfu.reduce_candidates(*tfs.emit_row_candidates(got[0], alpha, y,
                                                         valid, c))
    assert all(_same_bits(g, w) for g, w in zip(got[1:], own))


@pytest.mark.cuda
def test_fused_update_kernel_ties_and_empty_sets(cuda):
    """Equal extrema in different blocks go to the lowest flat id, +-0
    ties report -0.0 (min) / +0.0 (max), and a set with no member
    reports +-inf with id 0 -- the rules of the plain version."""
    rows = 64
    shp = (rows, 128)
    z = torch.zeros(shp, device=cuda)
    f = torch.zeros(shp, device=cuda)
    f.view(-1)[5000] = -0.0
    f.view(-1)[3] = 0.0
    alpha = torch.full(shp, 0.5, device=cuda)
    y = torch.ones(shp, device=cuda)
    valid = torch.ones(shp, device=cuda)
    kp = KernelParams("linear")
    sc = torch.zeros(4, device=cuda)
    got = tfu.fused_update_select(f, alpha, y, valid, z, z, z, sc, kp, 1.0)
    want = tfu._fused_update_select(f, alpha, y, valid, z, z, z, sc, kp, 1.0)
    assert all(_same_bits(g, w) for g, w in zip(got, want))
    assert int(got[2]) == 0 and int(got[4]) == 0
    got = tfu.fused_update_select(f, alpha, y, torch.zeros_like(valid), z,
                                  z, z, sc, kp, 1.0)
    assert (float(got[1]), int(got[2]), float(got[3]), int(got[4])) == (
        float("inf"), 0, -float("inf"), 0)


def _b6_inputs(dev, rows, seed):
    """B6's (R, 128) views and scalars, rbf-sized dots."""
    f, _, alpha, y, valid, _ = _views(dev, rows, seed, c=(2.0, 0.5))
    rng = np.random.default_rng(seed)
    shp = f.shape
    d_hi, d_lo = (torch.as_tensor(rng.normal(size=shp).astype(np.float32),
                                  device=dev) for _ in range(2))
    x_sq = torch.as_tensor(np.abs(rng.normal(size=shp)).astype(np.float32)
                           * 3, device=dev)
    scalars = torch.tensor([0.37, -0.21, 1.3, 0.8], device=dev)
    return (f, alpha, y, valid, d_hi, d_lo, x_sq, scalars)


@pytest.mark.cuda
@pytest.mark.parametrize("zero_sign", [0.0, -0.0])
def test_fused_update_kernel_ties_across_blocks(cuda, zero_sign):
    """At n = 65536 (128 blocks of ops/fused_update.py fused_update_plan)
    equal extrema in different blocks go to the lowest flat id, and the
    +-0 rule holds across blocks: b_hi is -0.0 when any I_up member is
    -0.0, b_lo +0.0 when any I_low member is +0.0; bitwise the plain
    version."""
    rows = 512
    shp = (rows, 128)
    z = torch.zeros(shp, device=cuda)
    kp = KernelParams("linear")
    # f' = f + (-1) 0 + (-1) 0: f bit for bit, the sign of a zero kept.
    sc = torch.tensor([-1.0, -1.0, 0.0, 0.0], device=cuda)
    alpha = torch.full(shp, 0.5, device=cuda)
    y = torch.ones(shp, device=cuda)
    valid = torch.ones(shp, device=cuda)
    # Equal non-zero extrema, the lowest id in a later block than the
    # first one met by block order.
    f = torch.ones(shp, device=cuda)
    flat = f.view(-1)
    flat[[60000, 1000, 30000]] = -3.0
    flat[[50000, 700, 65535]] = 4.0
    got = tfu.fused_update_select(f, alpha, y, valid, z, z, z, sc, kp, 1.0)
    want = tfu._fused_update_select(f, alpha, y, valid, z, z, z, sc, kp, 1.0)
    assert all(_same_bits(g, w) for g, w in zip(got, want))
    assert (float(got[1]), int(got[2]), float(got[3]), int(got[4])) == (
        -3.0, 1000, 4.0, 700)
    # Zeros of one sign everywhere, the other sign in one late block.
    f = torch.full(shp, zero_sign, device=cuda)
    f.view(-1)[40000] = -zero_sign
    got = tfu.fused_update_select(f, alpha, y, valid, z, z, z, sc, kp, 1.0)
    want = tfu._fused_update_select(f, alpha, y, valid, z, z, z, sc, kp, 1.0)
    torch.cuda.synchronize()
    assert all(_same_bits(g, w) for g, w in zip(got, want))
    assert int(got[2]) == 0 and int(got[4]) == 0
    assert str(float(got[1])) == "-0.0" and str(float(got[3])) == "0.0"


@pytest.mark.cuda
def test_fused_update_kernel_on_two_streams(cuda):
    """Launches on two streams at once each get their own right result:
    the cross-block words are one set per (device, stream)."""
    kp = KernelParams("rbf", 0.3)
    sets = [_b6_inputs(cuda, 512, seed) for seed in (1, 2)]
    streams = [torch.cuda.Stream(cuda) for _ in sets]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(5):
        for i, (args, stream) in enumerate(zip(sets, streams)):
            with torch.cuda.stream(stream):
                got[i].append(tfu.fused_update_select(*args, kp, (2.0, 0.5)))
    torch.cuda.synchronize()
    for args, outs in zip(sets, got):
        own = tfu.reduce_candidates(*tfs.emit_row_candidates(
            outs[0][0], *args[1:4], (2.0, 0.5)))
        want = tfu._fused_update_select(*args, kp, (2.0, 0.5))
        assert (int(outs[0][2]), int(outs[0][4])) == (int(want[2]),
                                                      int(want[4]))
        for out in outs:
            assert all(_same_bits(g, w) for g, w in zip(out, outs[0]))
            assert all(_same_bits(g, w) for g, w in zip(out[1:], own))


@pytest.mark.cuda
def test_fused_update_result_survives_the_next_launch(cuda):
    """A result the wrapper returned is not overwritten by a later launch
    (a per-pair loop may read trip t's pair after queueing trip t + 1),
    and two launches on the same inputs give the same bits."""
    kp = KernelParams("rbf", 0.3)
    a, b = _b6_inputs(cuda, 512, 3), _b6_inputs(cuda, 512, 4)
    first = tfu.fused_update_select(*a, kp, (2.0, 0.5))
    kept = [t.clone() for t in first]
    other = tfu.fused_update_select(*b, kp, (2.0, 0.5))
    again = tfu.fused_update_select(*a, kp, (2.0, 0.5))
    torch.cuda.synchronize()
    assert (int(other[2]), int(other[4])) != (int(first[2]), int(first[4]))
    assert all(_same_bits(g, w) for g, w in zip(first, kept))
    assert all(_same_bits(g, w) for g, w in zip(again, first))


PER_PAIR = [dict(engine="xla"), dict(engine="xla", gram_resident=True),
            dict(engine="xla", cache_lines=64),
            dict(engine="xla", selection="second_order", cache_lines=64),
            dict(engine="xla", pair_batch=8),
            dict(engine="xla", compensated=True),
            dict(engine="pallas"), dict(engine="pallas", cache_lines=64)]


@pytest.mark.cuda
@pytest.mark.parametrize("kw", PER_PAIR,
                         ids=lambda kw: "-".join(f"{k}={v}"
                                                 for k, v in kw.items()))
def test_per_pair_engine_on_card_reaches_cpu_optimum(cuda, kw):
    """Each per-pair variant on the card converges to the optimum of the
    same variant on the CPU: dual objective within rel 1e-4, SVs within
    2%; engine="pallas" launches B6 once per trip queued (a masked trip
    too), the cache launches cache_fill once a lookup."""
    x, y = make_blobs_binary(n=3000, d=24, seed=11, sep=1.0)
    cfg = SVMConfig(c=1.0, gamma=0.1, **kw)
    tfu.fused_update_select.launches = 0
    tcf.cache_fill.launches = 0
    rg = solve(x, y, cfg)
    launches = tfu.fused_update_select.launches
    trips = rg.stats["trips_queued"]
    rc = solve(x, y, cfg, device="cpu")
    assert rg.converged and rc.converged
    assert launches == (trips if kw["engine"] == "pallas" else 0)
    assert rg.iterations <= trips * kw.get("pair_batch", 1)
    lookups = 2 if kw.get("selection") == "second_order" else 1
    assert tcf.cache_fill.launches == (
        lookups * trips if kw.get("cache_lines") else 0)
    assert rg.stats["gram_resident"] == bool(kw.get("gram_resident"))

    def obj(r):
        a, f = r.alpha.astype(np.float64), r.stats["f"].astype(np.float64)
        return float(a.sum() - 0.5 * np.sum(a * y * (f + y)))

    assert abs(obj(rg) - obj(rc)) <= 1e-4 * abs(obj(rc))
    assert abs(rg.n_sv - rc.n_sv) <= 0.02 * rc.n_sv


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 792), (10, 7), (33, 5), (1, 1)])
@pytest.mark.parametrize("p_dev", [2, 3, 4, 5, 8, 16])
def test_ring_gather_kernel_is_the_stack(cuda, p_dev, shape):
    """B7 on P logical shards of the card: every rank's output bitwise
    torch.stack(blocks), twice in a row, on the 16-byte and the
    word-by-word copy paths."""
    g = torch.Generator(device="cpu").manual_seed(p_dev)
    blocks = [torch.randn(shape, generator=g).to(cuda) for _ in range(p_dev)]
    blocks[0][0, 0] = -float("inf")
    tring.ring_gather.launches = 0
    for _ in range(2):
        got = tring.ring_gather(blocks)
        torch.cuda.synchronize()
        want = torch.stack(blocks)
        assert all(_same_bits(g_r, want) for g_r in got)
        blocks = [b + 1.0 for b in blocks]
    assert tring.ring_gather.launches == 2


@pytest.mark.cuda
def test_ring_calls_on_two_streams_do_not_share_flags(cuda):
    """Two meshes of the same P driven from two streams may overlap on the
    card: each call is bitwise the stack. B7 keeps no state between calls
    (no flag words; one ordinary launch ordered by its stream), so
    overlapping calls cannot meet."""
    g = torch.Generator(device="cpu").manual_seed(9)
    sets = [[torch.randn((256, 792), generator=g).to(cuda) for _ in range(4)]
            for _ in range(2)]
    streams = [torch.cuda.Stream(cuda) for _ in sets]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(5):
        for i, (blocks, stream) in enumerate(zip(sets, streams)):
            with torch.cuda.stream(stream):
                got[i].append(tring.ring_gather(blocks))
    torch.cuda.synchronize()
    for blocks, outs in zip(sets, got):
        want = torch.stack(blocks)
        assert all(_same_bits(r, want) for out in outs for r in out)


@pytest.mark.cuda
@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p_dev,rq,n_loc,d,kind", [
    (2, 16, 300, 10, "rbf"), (4, 64, 1000, 37, "rbf"),
    (4, 256, 2000, 784, "linear"), (8, 100, 129, 24, "poly"),
    (4, 512, 2000, 784, "rbf")])
def test_ring_fold_window_kernel_matches_plain(cuda, p_dev, rq, n_loc, d,
                                               kind, dtype, compensated):
    """B8 on P logical shards: the gathered windows bitwise the stack;
    f' (less err') held against the fold carried in float64 (the kernel
    and the library sum each dot and the contraction in their own
    orders): off it by no more than rtol 1e-6 plus 2e-6 of the
    contraction's absolute sum plus 4 times the largest error of the
    float32 plain version against the same yardstick."""
    rng = np.random.default_rng(p_dev * rq)
    kp = KernelParams(kind, 0.05, 2, 0.5)
    xs = [torch.as_tensor(rng.random((n_loc, d)).astype(np.float32),
                          device=cuda).to(dtype) for _ in range(p_dev)]
    x_sqs = [squared_norms(x) for x in xs]
    fs = [torch.as_tensor(rng.normal(size=n_loc).astype(np.float32),
                          device=cuda) for _ in range(p_dev)]
    errs = [f * 1e-7 for f in fs] if compensated else None
    pends = []
    for r in range(p_dev):
        rows = torch.as_tensor(rng.integers(0, n_loc, rq), device=cuda)
        coef = torch.as_tensor(rng.normal(0, 0.1, rq).astype(np.float32),
                               device=cuda)
        coef[::5] = 0.0
        tcol = torch.zeros(rq, device=cuda)
        tcol[0] = 17.0
        pends.append(torch.cat([xs[r][rows].float(), x_sqs[r][rows][:, None],
                                coef[:, None], tcol[:, None]], dim=1))
    tring.ring_fold_window.launches = 0
    gath, f_k, e_k = tring.ring_fold_window(pends, xs, x_sqs, fs, errs, kp)
    torch.cuda.synchronize()
    assert tring.ring_fold_window.launches == 1
    _, f_p, e_p = tring.ring_fold_window_plain(pends, xs, x_sqs, fs, errs, kp)
    want_g = torch.stack(pends)
    from dpsvm_tpu_torch.ops.kernels import kernel_rows
    for r in range(p_dev):
        assert _same_bits(gath[r], want_g)
        scale = torch.zeros_like(fs[r])
        for i in range(p_dev - 1):
            blk = want_g[(r + 1 + i) % p_dev]
            scale += blk[:, d + 1].abs() @ kernel_rows(
                xs[r], x_sqs[r], blk[:, :d].to(dtype), blk[:, d], kp).abs()
        ref = tring.fold_window_peers_f64(
            want_g, r, xs[r], x_sqs[r], fs[r],
            errs[r] if compensated else None, kp)
        got, plain = f_k[r].double(), f_p[r].double()
        if compensated:
            got, plain = got - e_k[r].double(), plain - e_p[r].double()
        tol = (1e-6 * ref.abs() + 2e-6 * scale
               + 4 * float((plain - ref).abs().max()))
        assert bool(((got - ref).abs() <= tol).all())
    assert (e_k is None) == (not compensated)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_fold_grid_is_what_its_shared_memory_allows(cuda, dtype):
    """The fold takes more than the default 48 KB of dynamic shared
    memory (about 130 KiB with bf16 X, 178 KiB with float32 X), so the
    occupancy query that sizes its cooperative grid must be asked with it:
    then one block fits an SM (a query for 0 bytes reports several, and
    the runtime refuses a grid of that size). The wrapper's grid is the
    query's, P x (blocks // P), and the launch is accepted at P = 2, 4,
    8."""
    import ctypes

    lib = tring._lib()
    which = 1 + int(dtype == torch.bfloat16)
    blocks = ctypes.c_int()
    with torch.cuda.device(cuda):
        assert lib.dpsvm_ring_max_blocks(which, ctypes.byref(blocks)) == 0
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert blocks.value == sms
    rng = np.random.default_rng(9)
    kp = KernelParams("rbf", 0.1)
    for p_dev in (2, 4, 8):
        xs = [torch.as_tensor(rng.random((700, 40)).astype(np.float32),
                              device=cuda).to(dtype) for _ in range(p_dev)]
        x_sqs = [squared_norms(x) for x in xs]
        fs = [torch.zeros(700, device=cuda) for _ in range(p_dev)]
        pends = [torch.cat([x[:48].float(), s[:48, None],
                            torch.full((48, 1), 0.5, device=cuda),
                            torch.zeros(48, 1, device=cuda)], dim=1)
                 for x, s in zip(xs, x_sqs)]
        chunks = tring._chunks(which, xs[0].device, p_dev,
                               tring._MAX_FOLD_CHUNKS)
        assert chunks == min(tring._MAX_FOLD_CHUNKS, sms // p_dev)
        gath, f_k, _ = tring.ring_fold_window(pends, xs, x_sqs, fs, None, kp)
        torch.cuda.synchronize()
        assert all(_same_bits(g, torch.stack(pends)) for g in gath)
        _, f_p, _ = tring.ring_fold_window_plain(pends, xs, x_sqs, fs, None,
                                                 kp)
        assert all(torch.allclose(a, b, rtol=1e-4, atol=1e-4)
                   for a, b in zip(f_k, f_p))


@pytest.mark.cuda
def test_ring_fold_zero_coef_window_leaves_f_bitwise(cuda):
    rng = np.random.default_rng(0)
    xs = [torch.as_tensor(rng.random((500, 20)).astype(np.float32),
                          device=cuda) for _ in range(4)]
    x_sqs = [squared_norms(x) for x in xs]
    fs = [torch.as_tensor(rng.normal(size=500).astype(np.float32),
                          device=cuda) for _ in range(4)]
    pends = [torch.cat([x[:32], s[:32, None], torch.zeros(32, 2, device=cuda)],
                       dim=1) for x, s in zip(xs, x_sqs)]
    _, f_k, _ = tring.ring_fold_window(pends, xs, x_sqs, fs, None,
                                       KernelParams("rbf", 0.1))
    assert all(_same_bits(a, b) for a, b in zip(f_k, fs))


MESH_RUNS = [dict(), dict(selection="second_order", compensated=True),
             dict(pair_batch=2), dict(local_working_sets=2, sync_rounds=2),
             dict(local_working_sets=2, compensated=True, dtype="bfloat16")]


@pytest.mark.cuda
@pytest.mark.parametrize("kw", MESH_RUNS,
                         ids=lambda kw: "-".join(f"{k}={v}" for k, v in
                                                 kw.items()) or "global")
@pytest.mark.parametrize("p_dev", [2, 4])
def test_mesh_engines_on_logical_shards_of_the_card(cuda, p_dev, kw):
    """The mesh block engines on P logical shards of one card: the global
    runner takes the same pairs and rounds and gives bitwise the same
    alpha with the ring exchange (kernel B7 every round) as without; the
    shard-local runner (kernel B8 every sync) reaches the same optimum;
    both reach the single-device CPU optimum."""
    x, y = make_blobs_binary(n=1500, d=24, seed=11, sep=1.0)
    cfg = SVMConfig(c=1.0, gamma=0.1, engine="block", working_set_size=32,
                    **kw)
    mesh = Mesh([torch.device("cuda", 0)] * p_dev)
    r0 = solve_mesh(x, y, cfg.replace(ring_exchange=False), mesh=mesh)
    for fn in (tsub.solve_subproblem, tring.ring_gather,
               tring.ring_fold_window):
        fn.launches = 0
    r1 = solve_mesh(x, y, cfg.replace(ring_exchange=True), mesh=mesh)
    rc = solve(x, y, cfg.replace(local_working_sets=None, sync_rounds=1),
               device="cpu")
    assert r0.converged and r1.converged and rc.converged
    assert r1.stats["mesh_devices"] == ["cuda:0"] * p_dev
    rounds = r1.stats["outer_rounds"]
    if "local_working_sets" in kw:
        syncs = r1.stats["shardlocal_syncs"]
        local_rounds = syncs * cfg.sync_rounds
        assert tring.ring_fold_window.launches == syncs > 0
        assert tring.ring_gather.launches == rounds - local_rounds
        assert tsub.solve_subproblem.launches \
            == p_dev * local_rounds + (rounds - local_rounds)
    else:
        assert tring.ring_gather.launches == rounds > 0
        assert tsub.solve_subproblem.launches == rounds
        assert tring.ring_fold_window.launches == 0
        assert r1.iterations == r0.iterations
        assert r0.stats["outer_rounds"] == rounds
        assert np.array_equal(r1.alpha.view(np.uint32),
                              r0.alpha.view(np.uint32))

    def obj(r):
        a, f = r.alpha.astype(np.float64), r.stats["f"].astype(np.float64)
        return float(a.sum() - 0.5 * np.sum(a * y * (f + y)))

    for r in (r0, r1):
        assert abs(obj(r) - obj(rc)) <= 1e-4 * abs(obj(rc))
        assert abs(r.n_sv - rc.n_sv) <= 0.02 * rc.n_sv


def _fill_case(cuda, n, d, dtype, case, seed=0):
    """A store of 5 lines plus the spare, filled with seeded values, and
    the arguments of one lookup's fill in `case`."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32),
                        device=cuda).to(dtype)
    store = torch.as_tensor(rng.normal(size=(6, n)).astype(np.float32),
                            device=cuda)
    i_hi, i_lo = int(rng.integers(0, n)), int(rng.integers(0, n))
    flags = {"double_miss": [1, 1, 0], "hi_miss": [1, 0, 0],
             "lo_miss": [0, 1, 0], "both_hit": [0, 0, 0],
             "masked": [0, 0, 0], "one_line_save": [0, 1, 1],
             "one": [1]}[case]
    dest = {"one_line_save": [5, 0], "one": [3]}.get(case, [1, 4])
    ids = [i_hi] if case == "one" else [i_hi, i_lo]
    on = functools.partial(torch.tensor, device=cuda)
    return (x, store, on(ids, dtype=torch.int64), on(dest, dtype=torch.int64),
            on(flags, dtype=torch.bool))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["double_miss", "hi_miss", "lo_miss",
                                  "both_hit", "masked", "one_line_save",
                                  "one"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(1, 1), (37, 7), (1000, 24), (4099, 784),
                                 (3000, 13)])
def test_cache_fill_kernel_matches_plain(cuda, n, d, dtype, case):
    """Kernel cache_fill against its plain version on the same inputs, in
    every case of a lookup (both miss, either miss, both hit, a masked
    trip, the one-line save, lookup_one): the lines it must not write
    bitwise untouched, the saved line bitwise, each computed row within
    2 d 2^-24 of the sum of |products| (another summation order than
    cuBLAS's); two launches give the same bits. d = 7 and 13 take the
    kernel's one-value loads, the others its 16-byte loads."""
    x, store, ids, dest, flags = _fill_case(cuda, n, d, dtype, case)
    want = store.clone()
    tcf._cache_fill(x, want, ids, dest, flags)
    got = store.clone()
    tcf.cache_fill.launches = 0
    tcf.cache_fill(x, got, ids, dest, flags)
    again = store.clone()
    tcf.cache_fill(x, again, ids, dest, flags)
    torch.cuda.synchronize()
    assert tcf.cache_fill.launches == 2
    assert torch.equal(got, again)
    xf = x.float()
    fl = flags.tolist()
    written = {int(dest[r]) for r in range(ids.shape[0]) if fl[r]}
    if len(fl) == 3 and fl[2]:
        written.add(int(dest[0]))
    for line in range(store.shape[0]):
        if line not in written:
            assert torch.equal(got[line], store[line]), line
    if len(fl) == 3 and fl[2]:
        assert torch.equal(got[int(dest[0])], store[int(dest[1])])
    for r in range(ids.shape[0]):
        if not fl[r]:
            continue
        line = int(dest[r])
        scale = (xf.abs() @ xf[int(ids[r])].abs()).double()
        err = (got[line].double() - want[line].double()).abs()
        assert bool((err <= 2 * d * 2.0 ** -24 * scale + 1e-30).all())
