"""The port's ring exchange (dpsvm_tpu_torch/ops/ring.py: the plain
versions of kernels B7 and B8 and their wrappers) against the JAX
package's ring kernels (dpsvm_tpu/ops/ring.py) run in interpret mode
under shard_map on the forced host devices, as tests/test_ring.py runs
them.

B7 moves bits: plain == stack == JAX's ring_gather, bitwise, and the
candidate block the port puts on the ring equals JAX's lane for lane. B8:
the gathered windows bitwise; f' within rtol 1e-6 plus 2e-6 of the
contraction's absolute sum of JAX's kernel (two libraries sum the
products in different orders), and bitwise the port's own
ring_exchange=False sync. The CUDA kernels run only on the card:
tests/test_torch_cuda.py holds them against these plain versions there.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dpsvm_tpu.ops import ring as jring
from dpsvm_tpu.ops.kernels import KernelParams as JKernelParams
from dpsvm_tpu.parallel import dist_block as jdb
from dpsvm_tpu.parallel import mesh as jmesh
from dpsvm_tpu_torch.ops import ring as tring
from dpsvm_tpu_torch.ops.kernels import KernelParams, kernel_rows
from dpsvm_tpu_torch.parallel import dist_block as tdb
from dpsvm_tpu_torch.parallel.mesh import Mesh, pad_rows

SHARD = P(jmesh.DATA_AXIS)
REP = P()


def _jax_sharded(fn, p_dev, in_specs, out_specs, *args):
    mapped = jax.jit(jmesh.mesh_shard_map(
        fn, jmesh.make_data_mesh(p_dev), in_specs, out_specs, check=False))
    return [np.asarray(o) for o in mapped(*map(jnp.asarray, args))]


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


# ---- B7 ----------------------------------------------------------------


@pytest.mark.parametrize("p_dev", [2, 4, 8])
def test_ring_gather_plain_is_the_stack_and_jaxs(p_dev):
    """Every rank ends with all P blocks in rank order: the stack, and
    the bits JAX's ring kernel delivers, special values included."""
    rng = np.random.default_rng(p_dev)
    blocks = rng.standard_normal((p_dev, 6, 11)).astype(np.float32)
    blocks[:, 0, 0] = -np.inf
    blocks[:, 1, 1] = -0.0
    blocks[:, 2, 2] = 1e-42  # a float32 denormal
    (jout,) = _jax_sharded(
        lambda b: (jring.ring_gather(b[0], p_dev, interpret=True)[None],),
        p_dev, (SHARD,), (SHARD,), blocks)  # (P, P, L, lanes): rank-major
    tring.ring_gather.launches = 0
    outs = tring.ring_gather([torch.tensor(b) for b in blocks])
    plain = tring.ring_gather_plain([torch.tensor(b) for b in blocks])
    assert tring.ring_gather.launches == 0  # CPU tensors: the plain version
    assert len(outs) == len(plain) == p_dev
    for r in range(p_dev):
        np.testing.assert_array_equal(_bits(outs[r]), _bits(blocks))
        np.testing.assert_array_equal(_bits(plain[r]), _bits(blocks))
        np.testing.assert_array_equal(_bits(jout[r]), _bits(blocks))


@functools.lru_cache(maxsize=None)
def _state(p_dev, dtype="float32", n=296, d=10, c=1.0, seed=0):
    """A padded mid-solve state as numpy: (x, y, alpha, f, valid)."""
    from dpsvm_tpu.data.synth import make_blobs_binary
    from dpsvm_tpu.ops.kernels import kernel_matrix

    x, y = make_blobs_binary(n=n, d=d, seed=3, sep=1.2)
    if dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    rng = np.random.default_rng(seed)
    alpha = np.clip(rng.normal(0.4, 0.5, n), 0, c).astype(np.float32)
    k = np.asarray(kernel_matrix(x, x, JKernelParams("rbf", 0.2)))
    f = ((alpha * y) @ k - y).astype(np.float32)
    pad = pad_rows(n, p_dev) - n
    valid = np.arange(n + pad) < n
    return (np.pad(x, ((0, pad), (0, 0))),
            np.pad(y.astype(np.float32), (0, pad), constant_values=1.0),
            np.pad(alpha, (0, pad)),
            np.pad(f, (0, pad), constant_values=-1.0), valid)


def _shards(p_dev, *arrays):
    n_loc = arrays[0].shape[0] // p_dev
    return [[torch.tensor(a[r * n_loc:(r + 1) * n_loc]) for r in range(p_dev)]
            for a in arrays]


@pytest.mark.parametrize("p_dev,q", [(2, 16), (4, 32)])
def test_ring_block_lanes_and_selection_are_jaxs(p_dev, q, monkeypatch):
    """The (2h, d + 5 + 3) block each shard puts on the ring equals the
    JAX package's lane for lane (rows, scalars, score, the two id lanes),
    and the selection made from the gathered blocks is JAX's:
    (w, slot_ok, b_hi, b_lo, wdata) bitwise."""
    c = (1.0, 1.0)
    x, y, alpha, f, valid = _state(p_dev)
    x_sq = (x * x).sum(axis=1).astype(np.float32)
    kd = np.ones_like(x_sq)
    seen = {}
    real = jring.ring_gather

    def spy(blk, ndev, axis_name=jmesh.DATA_AXIS, interpret=False):
        jax.debug.callback(
            lambda b, i: seen.__setitem__(int(i), np.asarray(b)), blk,
            jax.lax.axis_index(axis_name))
        return real(blk, ndev, axis_name=axis_name, interpret=interpret)

    monkeypatch.setattr(jring, "ring_gather", spy)

    def jfn(f_, a_, y_, v_, x_, xsq_, kd_):
        data = jnp.concatenate(
            [x_, jnp.stack([xsq_, kd_, a_, y_, f_], axis=1)], axis=1)
        return jdb._select_block_mesh_ring(f_, a_, y_, v_, c, q, data,
                                           p_dev, True)

    jw, jok, jbh, jbl, jwd = _jax_sharded(
        jfn, p_dev, (SHARD,) * 7, (REP,) * 5, f, alpha, y, valid, x, x_sq, kd)
    jax.effects_barrier()
    assert sorted(seen) == list(range(p_dev))

    f_s, a_s, y_s, v_s, x_s, xsq_s, kd_s = _shards(
        p_dev, f, alpha, y, valid, x, x_sq, kd)
    cols = [(xsq_s[r], kd_s[r], a_s[r], y_s[r], f_s[r]) for r in range(p_dev)]
    for r in range(p_dev):
        blk = tdb.ring_block(f_s[r], a_s[r], y_s[r], v_s[r], c, q, x_s[r],
                             cols[r], r)
        assert blk.shape == (q, x.shape[1] + 5 + 3)
        np.testing.assert_array_equal(_bits(blk), _bits(seen[r]))
    mesh = Mesh(["cpu"] * p_dev)
    (tw, tok, tbh, tbl, twd), = tdb._select_block_mesh_ring(
        mesh, f_s, a_s, y_s, v_s, c, q, x_s, cols)
    np.testing.assert_array_equal(tw.numpy(), jw)
    np.testing.assert_array_equal(tok.numpy(), jok)
    np.testing.assert_array_equal(_bits(twd), _bits(jwd))
    assert _bits(tbh) == _bits(jbh) and _bits(tbl) == _bits(jbl)
    # ... and it is the all_gather path's selection.
    (w0, ok0, bh0, bl0), = tdb._select_block_mesh(mesh, f_s, a_s, y_s, v_s,
                                                  c, q)
    assert torch.equal(tw, w0) and torch.equal(tok, ok0)
    assert _bits(tbh) == _bits(bh0) and _bits(tbl) == _bits(bl0)


def test_ring_ids_survive_the_two_float_lanes():
    """Global ids up to 2^31 - 1 ride as a 19-bit and a 12-bit value."""
    g = torch.tensor([0, 1, 4095, 4096, 59999, 2 ** 24 + 1, 2 ** 31 - 1])
    hi, lo = (g >> 12).float(), (g & 0xFFF).float()
    assert torch.equal((hi.to(torch.int64) << 12) | lo.to(torch.int64), g)


# ---- B8 ----------------------------------------------------------------


def _windows(p_dev, rq, dtype, kind, seed=0, zero_coef=False):
    """Per-rank windows (R q, d + 3) of real rows with random coefs, and
    the shard state: numpy (pend (P, rq, d+3), x, x_sq, f, err)."""
    x, y, alpha, f, valid = _state(p_dev, dtype)
    rng = np.random.default_rng(seed)
    n_pad, d = x.shape
    n_loc = n_pad // p_dev
    x_sq = (x * x).sum(axis=1).astype(np.float32)
    pend = np.zeros((p_dev, rq, d + 3), np.float32)
    for r in range(p_dev):
        rows = r * n_loc + rng.choice(n_loc, rq, replace=False)
        pend[r, :, :d] = x[rows]
        pend[r, :, d] = x_sq[rows]
        coef = rng.normal(0, 0.3, rq).astype(np.float32)
        coef[::5] = 0.0  # dead slots
        pend[r, :, d + 1] = 0.0 if zero_coef else coef
        pend[r, 0, d + 2] = float(rng.integers(0, 64))
    err = rng.normal(0, 1e-7, n_pad).astype(np.float32)
    return pend, x, x_sq, f, err


def _tol(pend, r, x_loc, x_sq_loc, d, kp, want):
    """rtol 1e-6 of f' plus 2e-6 of the contraction's absolute sum."""
    p_dev = pend.shape[0]
    scale = torch.zeros_like(want)
    for i in range(p_dev - 1):
        blk = torch.tensor(pend[(r + 1 + i) % p_dev])
        scale += blk[:, d + 1].abs() @ kernel_rows(
            x_loc, x_sq_loc, blk[:, :d].to(x_loc.dtype), blk[:, d], kp).abs()
    return 1e-6 * want.abs() + 2e-6 * scale


@pytest.mark.parametrize("compensated", [False, True],
                         ids=["plain", "kahan"])
@pytest.mark.parametrize("p_dev,rq,dtype,kind", [
    (2, 16, "float32", "rbf"), (4, 32, "float32", "rbf"),
    (4, 16, "bfloat16", "rbf"), (2, 32, "float32", "linear"),
    (4, 16, "float32", "poly")])
def test_ring_fold_window_plain_against_jax(p_dev, rq, dtype, kind,
                                            compensated):
    pend, x, x_sq, f, err = _windows(p_dev, rq, dtype, kind)
    d = x.shape[1]
    kp_args = (kind, 0.2, 2, 0.5)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def jfn(pend_, x_, xsq_, f_, err_):
        g, f2, e2 = jring.ring_fold_window(
            pend_[0], x_.astype(jdt), xsq_, f_,
            err_ if compensated else None, JKernelParams(*kp_args), p_dev,
            compensated=compensated, interpret=True)
        return g[None], f2, (e2 if compensated else f2)

    jg, jf, je = _jax_sharded(jfn, p_dev, (SHARD,) * 5, (SHARD,) * 3,
                              pend, x, x_sq, f, err)
    kp = KernelParams(*kp_args)
    x_s, xsq_s, f_s, e_s = _shards(p_dev, x, x_sq, f, err)
    x_s = [t.to(tdt) for t in x_s]
    pends = [torch.tensor(p) for p in pend]
    tring.ring_fold_window.launches = 0
    tg, tf, te = tring.ring_fold_window(pends, x_s, xsq_s, f_s,
                                        e_s if compensated else None, kp)
    assert tring.ring_fold_window.launches == 0
    assert (te is None) == (not compensated)
    n_loc = len(f) // p_dev
    for r in range(p_dev):
        np.testing.assert_array_equal(_bits(tg[r]), _bits(pend))
        np.testing.assert_array_equal(_bits(jg[r]), _bits(pend))
        want = torch.tensor(jf[r * n_loc:(r + 1) * n_loc])
        tol = _tol(pend, r, x_s[r], xsq_s[r], d, kp, want)
        assert bool(((tf[r] - want).abs() <= tol).all())
        if compensated:
            want_eff = want - torch.tensor(je[r * n_loc:(r + 1) * n_loc])
            assert bool((((tf[r] - te[r]) - want_eff).abs() <= tol).all())
        # ... and the port's own all_gather sync, bitwise.
        f0, e0 = tring.fold_window_peers(
            torch.stack(pends), r, x_s[r], xsq_s[r], f_s[r],
            e_s[r] if compensated else None, kp)
        assert torch.equal(tf[r], f0)
        assert e0 is None if not compensated else torch.equal(te[r], e0)


@pytest.mark.parametrize("compensated", [False, True],
                         ids=["plain", "kahan"])
@pytest.mark.parametrize("p_dev,rq,dtype,kind", [
    (4, 32, "float32", "rbf"), (4, 16, "bfloat16", "rbf"),
    (2, 32, "float32", "linear"), (4, 16, "float32", "poly")])
def test_float64_fold_tells_a_wrong_fold_from_rounding(p_dev, rq, dtype,
                                                       kind, compensated):
    """The rule the card's kernel is held to (tests/test_torch_cuda.py,
    chip_smoke.py): a float32 fold may be off the fold carried in float64
    by rtol 1e-6 plus 2e-6 of the contraction's absolute sum plus 4 times
    the plain version's largest error. The plain version summed in another
    order passes; a fold that reads a neighbouring row's squared norm, or
    that misses one peer on a few rows, does not."""
    pend, x, x_sq, f, err = _windows(p_dev, rq, dtype, kind, seed=3)
    d = x.shape[1]
    kp = KernelParams(kind, 0.2, 2, 0.5)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    x_s, xsq_s, f_s, e_s = _shards(p_dev, x, x_sq, f, err)
    x_s = [t.to(tdt) for t in x_s]
    if not compensated:
        e_s = [None] * p_dev
    g = torch.tensor(pend)

    def effective(fe):
        f2, e2 = fe
        return f2.double() if e2 is None else f2.double() - e2.double()

    def reordered(r):  # the same fold, each window contracted backwards
        return tring.fold_window_peers(g.flip(1), r, x_s[r], xsq_s[r],
                                       f_s[r], e_s[r], kp)

    def wrong_norm(r):  # row i's kernel value from row i + 1's |q|^2
        bad = g.clone()
        bad[:, :, d] = g[:, :, d].roll(1, dims=1)
        return tring.fold_window_peers(bad, r, x_s[r], xsq_s[r], f_s[r],
                                       e_s[r], kp)

    def missed_rows(r):  # the first 8 rows never see the last peer
        f2, e2 = tring.fold_window_peers(g, r, x_s[r], xsq_s[r], f_s[r],
                                         e_s[r], kp)
        dead = g.clone()
        dead[(r - 1) % p_dev, :, d + 1] = 0.0
        f1, e1 = tring.fold_window_peers(dead, r, x_s[r], xsq_s[r], f_s[r],
                                         e_s[r], kp)
        return (torch.cat([f1[:8], f2[8:]]),
                None if e2 is None else torch.cat([e1[:8], e2[8:]]))

    for r in range(p_dev):
        ref = tring.fold_window_peers_f64(g, r, x_s[r], xsq_s[r], f_s[r],
                                          e_s[r], kp)
        plain = effective(tring.fold_window_peers(g, r, x_s[r], xsq_s[r],
                                                  f_s[r], e_s[r], kp))
        dp = float((plain - ref).abs().max())
        assert dp <= 1e-5 * float(ref.abs().max())  # float32 rounding only
        tol = (_tol(pend, r, x_s[r], xsq_s[r], d, kp, ref.float()).double()
               + 4 * dp)
        assert bool(((effective(reordered(r)) - ref).abs() <= tol).all())
        wrong = [missed_rows] + ([wrong_norm] if kind == "rbf" else [])
        for fold in wrong:
            assert not bool(((effective(fold(r)) - ref).abs() <= tol).all())


@pytest.mark.parametrize("p_dev", [2, 4])
def test_zero_coef_window_leaves_f_bitwise(p_dev):
    """A window of all-zero coefs (every shard's local gap closed) folds
    nothing: f comes back bit for bit."""
    pend, x, x_sq, f, err = _windows(p_dev, 16, "float32", "rbf",
                                     zero_coef=True)
    x_s, xsq_s, f_s = _shards(p_dev, x, x_sq, f)
    _, tf, te = tring.ring_fold_window(
        [torch.tensor(p) for p in pend], x_s, xsq_s, f_s, None,
        KernelParams("rbf", 0.2))
    assert te is None
    for r in range(p_dev):
        np.testing.assert_array_equal(_bits(tf[r]), _bits(f_s[r]))


def test_wrappers_reject_what_the_kernels_do_not_take():
    blk = [torch.zeros(4, 7) for _ in range(2)]
    with pytest.raises(ValueError, match="2 <= P"):
        tring.ring_gather(blk[:1])
    with pytest.raises(ValueError, match="float32"):
        tring.ring_gather([b.double() for b in blk])
    with pytest.raises(ValueError, match="contiguous"):
        tring.ring_gather([torch.zeros(7, 4).t() for _ in range(2)])
    with pytest.raises(ValueError, match="shards lie on"):
        tring.ring_gather([blk[0], blk[1].to("meta")])
    x = [torch.zeros(8, 4) for _ in range(2)]
    v = [torch.zeros(8) for _ in range(2)]
    kp = KernelParams("rbf", 0.5)
    with pytest.raises(ValueError, match=r"\(R q, 7\) windows"):
        tring.ring_fold_window([torch.zeros(4, 6)] * 2, x, v, v, None, kp)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tring.ring_fold_window(blk, [t.double() for t in x], v, v, None, kp)
    with pytest.raises(ValueError, match="vectors per shard"):
        tring.ring_fold_window(blk, x, v, [torch.zeros(7)] * 2, None, kp)
    with pytest.raises(ValueError, match="feature kernels"):
        tring.ring_fold_window(blk, x, v, v, None,
                               KernelParams("precomputed"))
    g, f2, e2 = tring.ring_fold_window(blk, x, v, v, v, kp)
    assert g[0].shape == (2, 4, 7) and len(f2) == len(e2) == 2


@pytest.mark.parametrize("shape", [(256, 792), (10, 7), (33, 5), (1, 1)])
@pytest.mark.parametrize("aligned", [True, False])
def test_gather_plan_covers_every_word_once(shape, aligned):
    """B7's launch plan splits the P x P x count output words: block
    (x, s) copies units [x per, min((x + 1) per, units)) of rank s's block
    into slot s of every rank's output, a unit 4 words when vec. Every
    word of every rank's every slot is written exactly once, for P in
    2..16, on the 16-byte and the word-by-word paths."""
    count = shape[0] * shape[1]
    plan = tring.gather_plan(count, aligned)
    assert plan.vec == (aligned and count % 4 == 0)
    scale = 4 if plan.vec else 1
    assert plan.units * scale == count
    assert plan.per == plan.threads * tring._GATHER_UNROLL
    # One slot's words by the blocks x of its column of the grid.
    hits = np.zeros(count, np.int64)
    for x in range(plan.chunks):
        lo, hi = x * plan.per, min((x + 1) * plan.per, plan.units)
        assert lo < hi  # no idle block
        hits[lo * scale:hi * scale] += 1
    assert (hits == 1).all()
    for p_dev in range(2, 17):
        # Each block writes its words into slot s of each of the P ranks.
        out = np.zeros((p_dev, p_dev, count), np.int64)
        for s in range(p_dev):
            out[:, s] += hits
        assert (out == 1).all()
