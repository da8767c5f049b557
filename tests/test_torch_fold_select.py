"""The port's fused fold + select (dpsvm_tpu_torch/ops/fold_select.py,
plain versions of kernels B2 and B3) against the JAX package's
ops/pallas_fold_select.py run in interpret mode, on the same (R, 128)
views made with numpy from a seed.

f', err' and the four candidate arrays are held BITWISE (the float32
bits, so -0.0 and +0.0 differ), and so is the assembled working set
(w, slot_ok, b_hi, b_lo): the fold is one add or one Kahan step per
element and the selection is comparisons only."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpsvm_tpu.ops import pallas_fold_select as jfs
from dpsvm_tpu.ops.select import candidate_live_mask as jax_live_mask
from dpsvm_tpu.solver import block as jblock
from dpsvm_tpu_torch.ops import fold_select as tfs
from dpsvm_tpu_torch.ops.select import candidate_live_mask
from dpsvm_tpu_torch.solver import block as tblock

LANES = 128


def make_views(seed: int, rows: int, c, ties: bool):
    """(f, err, alpha, y, valid, delta) as (rows, 128) float32 arrays.

    Alpha sits at 0, at C and inside the box; the last rows are partly
    padding (valid 0). Row 0 has no I_up member (every y = +1 at C),
    row 1 no I_low member (every y = +1 at 0), row 2 neither (all
    padding). With `ties`, f and delta are multiples of 1/8, so the fold
    is exact and many values tie inside and across rows; zeros are +0.0
    only."""
    rng = np.random.default_rng(seed)
    n = rows * LANES
    cp, cn = c if isinstance(c, tuple) else (c, c)
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    c_row = np.where(y > 0, cp, cn).astype(np.float32)
    pick = rng.integers(0, 3, n)
    alpha = np.where(pick == 0, 0.0, np.where(pick == 1, c_row,
                     rng.random(n).astype(np.float32) * c_row))
    alpha = alpha.astype(np.float32)
    if ties:
        f = (np.round(rng.normal(size=n) * 8) / 8 + 0.0).astype(np.float32)
        delta = (np.round(rng.normal(size=n) * 4) / 8 + 0.0).astype(
            np.float32)
        err = np.zeros(n, np.float32)
    else:
        f = rng.normal(size=n).astype(np.float32)
        delta = (rng.normal(size=n) * 0.05).astype(np.float32)
        err = (rng.normal(size=n) * 1e-7).astype(np.float32)
    valid = np.ones(n, np.float32)
    valid[-LANES - 37:] = 0.0
    y[:LANES] = 1.0
    alpha[:LANES] = cp
    y[LANES:2 * LANES] = 1.0
    alpha[LANES:2 * LANES] = 0.0
    valid[2 * LANES:3 * LANES] = 0.0
    return [a.reshape(rows, LANES) for a in (f, err, alpha, y, valid, delta)]


def jx(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def bits(a):
    return np.asarray(a).view(np.uint32) if np.asarray(a).dtype == \
        np.float32 else np.asarray(a)


def assert_bitwise(port, ref):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        if r is None:
            assert p is None
            continue
        p = p.numpy() if torch.is_tensor(p) else np.asarray(p)
        np.testing.assert_array_equal(bits(p), bits(r))


CASES = [
    pytest.param(c, comp, ties, id=f"c{c}-{'kahan' if comp else 'plain'}"
                 f"-{'ties' if ties else 'random'}")
    for c in (1.0, (2.0, 0.5))
    for comp in (False, True)
    for ties in (False, True)
]


@pytest.mark.parametrize("c,compensated,ties", CASES)
def test_fold_select_bitwise_vs_jax(c, compensated, ties):
    f, err, alpha, y, valid, delta = make_views(3, 24, c, ties)
    ref = jfs.fold_select(*jx(f, err if compensated else None, alpha, y,
                             valid, delta),
                          c, compensated=compensated, interpret=True)
    port = tfs.fold_select(*(torch.as_tensor(a) for a in (f, err, alpha, y,
                                                          valid, delta)),
                           c, compensated=compensated)
    assert_bitwise(port, ref)
    # The planted rows: no I_up member -> +inf with the row's first id.
    assert port[2][0] == np.inf and port[3][0] == 0
    assert port[4][1] == -np.inf and port[5][1] == LANES
    assert port[2][2] == np.inf and port[5][2] == 2 * LANES


@pytest.mark.parametrize("c,ties", [(1.0, False), (1.0, True),
                                    ((2.0, 0.5), True)])
def test_select_rows_bitwise_vs_jax(c, ties):
    f, _, alpha, y, valid, _ = make_views(5, 16, c, ties)
    ref = jfs.select_rows(*(jnp.asarray(a) for a in (f, alpha, y, valid)),
                          c, interpret=True)
    port = tfs.select_rows(*(torch.as_tensor(a) for a in (f, alpha, y,
                                                          valid)), c)
    assert_bitwise(port, ref)


@pytest.mark.parametrize("h", [4, 8, 16])
@pytest.mark.parametrize("ties", [False, True])
def test_assemble_working_set_bitwise_vs_jax(h, ties):
    """Same candidates in, same (w, slot_ok, b_hi, b_lo) out: ties
    across rows go to the lowest candidate index, short sides fill with
    the empty rows' first ids."""
    f, err, alpha, y, valid, delta = make_views(7, 16, 1.0, ties)
    cands = jfs.fold_select(*jx(f, None, alpha, y, valid, delta), 1.0,
                            interpret=True)[2:]
    ref = jfs.assemble_working_set(*cands, h)
    port = tfs.assemble_working_set(
        *(torch.tensor(np.asarray(a)) for a in cands), h)
    assert_bitwise(port, ref)


def test_signed_zero_ties_match_jax():
    """+0.0 and -0.0 tie: the lowest id wins, the up side reports -0.0
    and the low side +0.0 when a member has that sign (XLA's minimum /
    maximum). select_rows reads f as it stands; in fold_select only
    -0.0 + -0.0 stays negative."""
    f, err, alpha, y, valid, delta = make_views(17, 8, 1.0, False)
    alpha[:] = 0.5
    f[3:, :] = 2.0
    f[3, [5, 9]] = [0.0, -0.0]  # up side (alpha interior: both sets)
    f[4, [3, 7]] = [-0.0, 0.0]
    f[5, [2, 4, 6]] = [-0.0, -0.0, 0.0]
    f[6, :] = -1.0
    f[6, [1, 8]] = [0.0, -0.0]  # low side maximum
    delta[:] = -0.0
    for args, jfn, tfn in (((f, alpha, y, valid), jfs.select_rows,
                            tfs.select_rows),
                           ((f, None, alpha, y, valid, delta),
                            jfs.fold_select, tfs.fold_select)):
        ref = jfn(*jx(*args), 1.0, interpret=True)
        port = tfn(*(None if a is None else torch.as_tensor(a)
                     for a in args), 1.0)
        assert_bitwise(port, ref)


def test_fold_delta_matches_kahan():
    f, err, _, _, _, delta = make_views(9, 8, 1.0, False)
    tf, te, ts = tfs.fold_delta(*(torch.as_tensor(a) for a in (f, err,
                                                               delta)))
    jf, je, js = jfs.fold_delta(*(jnp.asarray(a) for a in (f, err, delta)))
    assert_bitwise((tf, te, ts), (jf, je, js))
    pf, pe, ps = tfs.fold_delta(torch.as_tensor(f), None,
                                torch.as_tensor(delta))
    assert pe is None and ps is pf


@pytest.mark.parametrize("rule", ["mvp", "second_order"])
def test_select_block_valid_mask_matches_jax(rule):
    f, _, alpha, y, valid, _ = make_views(11, 8, 1.0, False)
    f, alpha, y = f.ravel(), alpha.ravel(), y.ravel()
    vb = valid.ravel() > 0
    ref = jblock.select_block(jnp.asarray(f), jnp.asarray(alpha),
                              jnp.asarray(y), 1.0, 64,
                              valid=jnp.asarray(vb), rule=rule)
    port = tblock.select_block(torch.as_tensor(f), torch.as_tensor(alpha),
                               torch.as_tensor(y), 1.0, 64,
                               valid=torch.as_tensor(vb), rule=rule)
    assert_bitwise(port, ref)
    w, ok = port[0].numpy(), port[1].numpy()
    assert vb[w[ok]].all()


@pytest.mark.parametrize("c", [1.0, (2.0, 0.5)])
def test_candidate_live_mask_matches_jax(c):
    _, _, alpha, y, _, _ = make_views(13, 2, c, False)
    ref = jax_live_mask(jnp.asarray(alpha.ravel()), jnp.asarray(y.ravel()),
                        c)
    port = candidate_live_mask(torch.as_tensor(alpha.ravel()),
                               torch.as_tensor(y.ravel()), c)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_cpu_runs_the_plain_versions_and_counts_nothing():
    f, err, alpha, y, valid, delta = (torch.as_tensor(a) for a in
                                      make_views(1, 8, 1.0, False))
    tfs.fold_select.launches = tfs.select_rows.launches = 0
    out = tfs.fold_select(f, err, alpha, y, valid, delta, 1.0,
                          compensated=True)
    plain = tfs._fold_select(f, err, alpha, y, valid, delta, 1.0, True)
    assert_bitwise(out, plain)
    assert_bitwise(tfs.select_rows(f, alpha, y, valid, 1.0),
                   tfs._select_rows(f, alpha, y, valid, 1.0))
    assert tfs.fold_select.launches == tfs.select_rows.launches == 0


def test_bad_views_and_devices_raise():
    f, err, alpha, y, valid, delta = (torch.as_tensor(a) for a in
                                      make_views(1, 8, 1.0, False))
    with pytest.raises(ValueError, match="contiguous"):
        tfs.select_rows(f, alpha.double(), y, valid, 1.0)
    with pytest.raises(ValueError, match=r"\(R, 128\)"):
        tfs.select_rows(f.view(-1), alpha, y, valid, 1.0)
    meta = [torch.empty((8, LANES), device="meta") for _ in range(5)]
    with pytest.raises(ValueError, match="unsupported device"):
        tfs.fold_select(meta[0], None, *meta[1:], 1.0)


def plan(rows: int, warps: int = 1):
    """A B2 / B3 launch plan of `warps` rows a block: the kept one
    (ops/fold_select.py fold_select_plan) or one of those chip_smoke.py
    --turns times beside it."""
    return tfs.FoldSelectPlan(warps, -(-rows // warps))


def _plan_ok(p, rows: int) -> bool:
    """A B2 / B3 launch plan as csrc/fold_select.cu maps it: thread t of
    block b works on row b * warps + t // 32 and returns when that row is
    past the last. Every row is taken by exactly one warp, every lane of
    a warp takes the same row (so the exit is warp-uniform and redux.sync
    sees the full warp), no block is without a row, and a block fits the
    kernel's bounds. The kernel uses no shared memory, so it is within
    the 227 KB a block may have at any plan."""
    threads = p.warps * 32
    t = np.arange(p.blocks * threads)
    row = (t // threads) * p.warps + (t % threads) // 32
    live = row < rows
    hits = np.bincount(row[live], minlength=rows) // 32
    per_warp = row.reshape(-1, 32)
    return (bool((hits == 1).all())
            and bool((per_warp == per_warp[:, :1]).all())
            and bool((live.reshape(-1, 32) == live.reshape(-1, 32)[:, :1])
                     .all())
            and bool((np.arange(p.blocks) * p.warps < rows).all())
            and 1 <= p.warps <= 8 and threads <= 1024)


ROWS = list(range(1, 300)) + [472, 473, 3911, 3912, 4097]


def test_fold_select_plan_covers_every_row_once():
    bad = [r for r in ROWS if not _plan_ok(tfs.fold_select_plan(r), r)]
    assert not bad, bad[:5]


@pytest.mark.parametrize("warps", [2, 3, 4, 8])
def test_other_plans_cover_every_row_once(warps):
    """The plans chip_smoke.py --turns times beside the kept one."""
    bad = [r for r in ROWS if not _plan_ok(plan(r, warps), r)]
    assert not bad, bad[:5]


def test_fold_select_plan_at_the_main_path_shapes():
    """The kept plan: one-warp blocks, one row each; 472 blocks at the
    60000-row headline and 3912 at covtype scale (500000 rows)."""
    assert tfs.fold_select_plan(472) == (1, 472)
    assert tfs.fold_select_plan(3912) == (1, 3912)
    with pytest.raises(ValueError):
        tfs.fold_select_plan(0)


@pytest.mark.parametrize("compensated", [False, True])
def test_candidate_buffer_rows_are_the_plain_candidates(compensated):
    """cand_outputs: the four candidate tensors are the rows of one (4, R)
    buffer of 32-bit words, word k of row r at k * R + r. Written in that
    layout from the plain version's candidates, they come back with the
    plain version's dtypes, shapes and bits. A check of the wrapper's
    views only: that csrc/fold_select.cu store_row writes this layout is
    shown by the card tests (test_torch_cuda.py), which compare the
    kernels' outputs with the plain versions bit for bit."""
    f, err, alpha, y, valid, delta = (torch.as_tensor(a) for a in
                                      make_views(19, 12, (2.0, 0.5), True))
    for want in (tfs._select_rows(f, alpha, y, valid, (2.0, 0.5)),
                 tfs._fold_select(f, err, alpha, y, valid, delta,
                                  (2.0, 0.5), compensated)[2:]):
        buf, got = tfs.cand_outputs(12, torch.device("cpu"))
        assert buf.shape == (4, 12) and buf.dtype == torch.int32
        flat = buf.view(-1)
        for k, w in enumerate(want):
            flat[k * 12:(k + 1) * 12] = w.view(torch.int32)
        assert [g.dtype for g in got] == [w.dtype for w in want] == [
            torch.float32, torch.int32, torch.float32, torch.int32]
        assert all(g.shape == w.shape == (12,) for g, w in zip(got, want))
        assert_bitwise(got, [w.numpy() for w in want])


def test_refusals_are_unchanged():
    """The wrappers refuse what the kernels do not take, on any device:
    another dtype, shape or device, a view that is not contiguous; none
    falls back. The box bounds reach the kernels as float32 values."""
    f, err, alpha, y, valid, delta = (torch.as_tensor(a) for a in
                                      make_views(1, 8, 1.0, False))
    wide = torch.zeros((8, 2 * LANES))
    cases = [((f[:, :LANES - 1].contiguous(), alpha, y, valid), "(R, 128)"),
             ((f, alpha, y, valid[:, :LANES - 1].contiguous()), "contiguous"),
             ((f, alpha.double(), y, valid), "contiguous"),
             ((f, wide[:, ::2], y, valid), "contiguous"),
             ((f, alpha, y[:4], valid), "contiguous")]
    for args, match in cases:
        with pytest.raises(ValueError, match=re.escape(match)):
            tfs.select_rows(*args, 1.0)
        with pytest.raises(ValueError, match=re.escape(match)):
            tfs.fold_select(args[0], err, *args[1:], delta, 1.0,
                            compensated=True)
    with pytest.raises(ValueError, match="contiguous"):
        tfs.fold_select(f, err.t().contiguous().t(), alpha, y, valid, delta,
                        1.0, compensated=True)
    assert tfs.c_consts((0.1, 2.0)) == (float(np.float32(0.1)), 2.0)
    assert tfs.c_consts(0.1) == (float(np.float32(0.1)),) * 2
