"""The port's one-pass round (dpsvm_tpu_torch/ops/round.py, plain versions
of kernels B4 and B5) against the JAX package's ops/pallas_round.py run in
interpret mode, on the same inputs made with numpy from a seed.

Kernel values come from matmuls that XLA and torch sum in other orders,
and exp/tanh/pow differ by a few ulps between them, so K rows, K(W, W)
and the folded f are held within rtol 1e-6 (non-negative features and
coef0 >= 0, so no dot or gamma * dot + coef0 cancels). The per-row
candidates are held bitwise against the plain fold_select fed the same
contraction."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpsvm_tpu.ops import kernels as jk
from dpsvm_tpu.ops import pallas_round as jround
from dpsvm_tpu_torch.ops import fold_select as tfs
from dpsvm_tpu_torch.ops import kernels as tk
from dpsvm_tpu_torch.ops import round as tround

KERNELS = [("rbf", 0.3, 3, 0.0), ("linear", 1.0, 3, 0.0),
           ("poly", 0.2, 3, 0.5), ("sigmoid", 0.1, 3, 0.25)]
RTOL = 1e-6


def _inputs(dtype, n=1024, d=20, q=32, seed=6):
    """x (n, d) stored in `dtype` (both packages see the same rounded
    values), q working-set ids with repeats, and their squared norms."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, d)).astype(np.float32)
    if dtype == "bfloat16":
        import ml_dtypes

        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    w = rng.integers(0, n, q).astype(np.int32)
    w[3] = w[7]  # a repeated id, as dead filler slots give
    return x, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,gamma,degree,coef0", KERNELS)
def test_gather_gram_matches_jax(kind, gamma, degree, coef0, dtype):
    x, w = _inputs(dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jx, tx = jnp.asarray(x, jdt), torch.as_tensor(x).to(tdt)
    jsq = jk.squared_norms(jx)
    tsq = torch.tensor(np.asarray(jsq))
    jkp = jk.KernelParams(kind, gamma, degree, coef0)
    tkp = tk.KernelParams(kind, gamma, degree, coef0)
    jw = jnp.asarray(w)
    j_rows, j_kb = jround.gather_gram(jx, jw, jsq, jnp.take(jsq, jw), jkp,
                                      interpret=True)
    tw = torch.as_tensor(w)
    t_rows, t_kb = tround.gather_gram(tx, tw, tsq, tsq[tw], tkp)
    assert t_rows.shape == (32, 1024) and t_kb.shape == (32, 32)
    assert t_rows.dtype == t_kb.dtype == torch.float32
    np.testing.assert_allclose(t_rows.numpy(), np.asarray(j_rows), rtol=RTOL)
    np.testing.assert_allclose(t_kb.numpy(), np.asarray(j_kb), rtol=RTOL)
    # ... and against the JAX package's own stage oracle (take +
    # kernel_rows), which the interpret-mode kernel meets only within
    # rounding on this JAX.
    oracle = jk.kernel_rows(jx, jsq, jnp.take(jx, jw, axis=0),
                            jnp.take(jsq, jw), jkp)
    np.testing.assert_allclose(t_rows.numpy(), np.asarray(oracle),
                               rtol=RTOL)


def _fold_inputs(seed, q=16, rows=16, compensated=False):
    rng = np.random.default_rng(seed)
    n = rows * 128
    k_rows = rng.random((q, n)).astype(np.float32)
    coef = (rng.normal(size=q) * 0.1).astype(np.float32)
    f = rng.normal(size=(rows, 128)).astype(np.float32)
    err = (rng.normal(size=(rows, 128)) * 1e-4).astype(np.float32) \
        if compensated else None
    alpha = np.clip(rng.normal(0.5, 0.5, n), 0, 1.5).astype(np.float32)
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    valid = np.ones(n, np.float32)
    valid[-200:] = 0.0
    return (k_rows, coef, f, err, alpha.reshape(rows, 128),
            y.reshape(rows, 128), valid.reshape(rows, 128))


def _t(a):
    return None if a is None else torch.as_tensor(a)


@pytest.mark.parametrize("compensated", [False, True])
def test_fold_rows_select_matches_jax(compensated):
    args = _fold_inputs(4, compensated=compensated)
    ref = jround.fold_rows_select(
        *(None if a is None else jnp.asarray(a) for a in args), 1.5,
        compensated=compensated, interpret=True)
    port = tround.fold_rows_select(*map(_t, args), 1.5,
                                   compensated=compensated)
    np.testing.assert_allclose(port[0].numpy(), np.asarray(ref[0]),
                               rtol=RTOL, atol=1e-7)
    if compensated:
        np.testing.assert_allclose(port[1].numpy(), np.asarray(ref[1]),
                                   atol=1e-6)
    else:
        assert port[1] is None and ref[1] is None
    # Candidates: bitwise those of the plain fold_select fed coef @ K.
    k_rows, coef, f, err, alpha, y, valid = map(_t, args)
    want = tfs.fold_select(f, err, alpha, y, valid,
                           (coef @ k_rows).view(f.shape), 1.5,
                           compensated=compensated)
    for p, w in zip(port, want):
        if w is None:
            assert p is None
        else:
            assert torch.equal(p.view(torch.int32) if p.is_floating_point()
                               else p, w.view(torch.int32)
                               if w.is_floating_point() else w)
    # Most rows pick the same candidate as JAX (f' differs by rounding).
    assert (port[3].numpy() == np.asarray(ref[3])).mean() > 0.9


def test_cpu_runs_the_plain_versions_and_counts_nothing():
    x, w = _inputs("float32", n=256, d=6, q=8)
    tx = torch.as_tensor(x)
    tsq = tk.squared_norms(tx)
    tw = torch.as_tensor(w)
    kp = tk.KernelParams("rbf", 0.5)
    tround.gather_gram.launches = tround.fold_rows_select.launches = 0
    k_rows, kb = tround.gather_gram(tx, tw, tsq, tsq[tw], kp)
    p_rows, p_kb = tround._gather_gram(tx, tw, tsq, tsq[tw], kp)
    assert torch.equal(k_rows, p_rows) and torch.equal(kb, p_kb)
    assert tround.gather_gram.launches == 0
    with pytest.raises(ValueError, match="int32"):
        tround.gather_gram(tx, tw.long(), tsq, tsq[tw], kp)
    with pytest.raises(ValueError, match="feature kernels"):
        tround.gather_gram(tx, tw, tsq, tsq[tw],
                           tk.KernelParams("precomputed"))
    with pytest.raises(ValueError, match="unsupported device"):
        tround.gather_gram(tx.to("meta"), tw.to("meta"), tsq.to("meta"),
                           tsq[tw].to("meta"), kp)


def _headline_like(dtype, kind, n=2048, d=784, q=64, seed=7):
    """Headline-shaped rows (make_mnist_like, d = 784), stored in `dtype`,
    q working-set ids with a repeat, and K(W, :), K(W, W) carried in
    float64 from the stored values."""
    from dpsvm_tpu_torch.data.synth import make_mnist_like

    x, _ = make_mnist_like(n=n, d=d, seed=seed)
    tx = torch.as_tensor(x).to(torch.bfloat16 if dtype == "bfloat16"
                               else torch.float32)
    rng = np.random.default_rng(seed)
    w = torch.as_tensor(rng.integers(0, n, q).astype(np.int32))
    w[q // 2] = w[0]
    kp = tk.KernelParams(kind, 0.125)
    x64 = tx.double()
    sq64 = (x64 * x64).sum(1)

    def k64(rows):
        v = x64[rows] @ x64.t()
        if kind == "rbf":
            v = torch.exp(-kp.gamma * (sq64[rows][:, None] + sq64[None, :]
                                       - 2.0 * v).clamp(min=0.0))
        return v, v[:, rows]

    return tx, w, kp, k64(w)


def _within(got, ref, x_sq, d, kp):
    return all(bool(((g.double() - r).abs()
                     <= tround.gram_tolerance(x_sq, d, kp, r.abs())).all())
               for g, r in zip(got, ref))


@pytest.mark.parametrize("kind", ["rbf", "linear"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gram_tolerance_tells_a_wrong_tiling_from_rounding(dtype, kind):
    """The rule kernel B4 is held to on the card (gram_tolerance, in
    tests/test_torch_cuda.py and chip_smoke.py): a float32 evaluation of
    K(W, :) and K(W, W) summed in any order passes against the float64
    Gram on headline-shaped data (d = 784, q = 64); the bugs a tiled
    kernel is likely to have do not pass: the K tail dropped (the last 16
    columns of d: 784 = 24 x 32 + 16), one working-set slot fed its
    neighbour's row, and the last data row of a 128-row tile zeroed."""
    x, w, kp, ref = _headline_like(dtype, kind)
    d = x.shape[1]
    x_sq = tk.squared_norms(x)
    qsq = x_sq[w]
    plain = tround.gather_gram(x, w, x_sq, qsq, kp)
    assert _within(plain, ref, x_sq, d, kp)

    def rows_of(qx, xx):
        return (tk.kernel_from_dots(tk.mm_f32(qx, xx.t()), x_sq, qsq, kp),
                tk.kernel_from_dots(tk.mm_f32(qx, qx.t()), qsq, qsq, kp))

    # The K tail never loaded: the dots miss the last 16 columns.
    short = rows_of(x[w][:, :d - 16], x[:, :d - 16])
    # Slot 5 gathers row w[6] (its own squared norm kept).
    slot = int(np.flatnonzero((w[1:] != w[:-1]).numpy())[4])
    w_bad = w.clone()
    w_bad[slot] = w[slot + 1]
    neighbour = rows_of(x[w_bad], x)
    # The last row of the first 128-row data tile never stored.
    k_rows, kb = plain
    torn = k_rows.clone()
    torn[:, 127] = 0.0
    for bad in (short, neighbour, (torn, kb)):
        assert not _within(bad, ref, x_sq, d, kp)


def _tf32_rna(a):
    """cvt.rna.tf32.f32 in numpy: float32 rounded to 10 mantissa bits,
    ties away from zero (on the magnitude's bits), low 13 bits zero."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _mma_add(acc, terms):
    """A model of one mma.sync into a float32 accumulator, pessimistic
    about the tensor core's adds: the exact products `terms` (k, M, N)
    and `acc` are aligned to the largest exponent among them with 24
    significant bits, truncated there, summed, and the sum is rounded
    toward zero to float32 (the MMA does not round to nearest)."""
    allt = np.concatenate([acc.astype(np.float64)[None], terms])
    _, e = np.frexp(np.abs(allt).max(0))
    ulp = np.ldexp(1.0, e - 24)
    s = (np.trunc(allt / ulp) * ulp).sum(0)
    f = s.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(s)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _emulated_dots(a, wi, passes):
    """The dots X[w] X^T of csrc/mma_tile.cuh's float32 path: per 32-deep
    stage a fresh float32 partial sum, into which each 8-deep step adds
    one m16n8k8 MMA for each (A part, B part) of `passes` ("h" = hi,
    "l" = lo, each tf32), in that order; each stage's partial is added
    to the running dot by an IEEE float32 add."""
    hi = _tf32_rna(a)
    lo = _tf32_rna(a - hi)
    parts = {"h": hi.astype(np.float64), "l": lo.astype(np.float64)}
    d = a.shape[1]
    acc = np.zeros((len(wi), a.shape[0]), np.float32)
    for k0 in range(0, d, 32):
        part = np.zeros_like(acc)
        for k in range(k0, min(k0 + 32, d), 8):
            ks = slice(k, min(k + 8, d))
            for pa, pb in passes:
                terms = (parts[pa][wi, ks].T[:, :, None]
                         * parts[pb][:, ks].T[:, None, :])
                part = _mma_add(part, terms)
        acc = acc + part
    return acc


THREE = (("l", "h"), ("h", "l"), ("h", "h"))  # lo.hi + hi.lo + hi.hi
ONE = (("h", "h"),)  # one-pass TF32


@functools.lru_cache(maxsize=None)
def _tf32_case(case):
    """Float32 rows, working-set ids, and the emulated 3xTF32 and
    one-pass TF32 dots: "headline" (make_mnist_like, n = 2048, d = 784,
    q = 64) or "ragged" (uniform rows, n = 1000, d = 37, q = 72, as in
    the card's tile-edge test)."""
    if case == "headline":
        x, w, _, _ = _headline_like("float32", "linear")
    else:
        rng = np.random.default_rng(37)
        x = torch.as_tensor(rng.random((1000, 37)).astype(np.float32))
        w = torch.as_tensor(rng.integers(0, 1000, 72).astype(np.int32))
    a, wi = x.numpy(), w.numpy()
    return x, w, _emulated_dots(a, wi, THREE), _emulated_dots(a, wi, ONE)


def _k_of(dots, x, w, kp):
    x_sq = tk.squared_norms(x)
    qsq = x_sq[w]
    dots = torch.as_tensor(dots)
    return (tk.kernel_from_dots(dots, x_sq, qsq, kp),
            tk.kernel_from_dots(dots[:, w.long()], qsq, qsq, kp))


def test_3xtf32_split_keeps_float32_dots_within_gram_tolerance():
    """The numerics of B4's and B8's float32 path (csrc/mma_tile.cuh):
    hi = rna(a), lo = rna(a - hi) rebuild each float32 value within 2^-22
    relative; dots summed from the three tf32 products lo.hi + hi.lo +
    hi.hi as the kernel sums them (_emulated_dots) keep the kernel values
    within gram_tolerance of the float64 Gram on headline-shaped data,
    rbf and linear.

    One-pass TF32 (hi.hi alone) has errors random in sign, so on this
    data it too lies inside the worst-case gram_tolerance, whose bound
    lies between the two per-product bounds (2^-10 |a b| summed, and
    3 . 2^-22 |a b|): gram_tolerance alone cannot tell them apart.
    tf32x3_check can (the next test)."""
    x, w, three, _ = _tf32_case("headline")
    a = x.numpy()
    hi = _tf32_rna(a)
    lo = _tf32_rna(a - hi)
    a64 = a.astype(np.float64)
    rebuilt = hi.astype(np.float64) + lo.astype(np.float64)
    assert np.all(np.abs(rebuilt - a64) <= 2.0 ** -22 * np.abs(a64))

    d = a.shape[1]
    x_sq = tk.squared_norms(x)
    for kind in ("rbf", "linear"):
        kp = tk.KernelParams(kind, 0.125)
        _, _, _, ref = _headline_like("float32", kind)
        assert _within(_k_of(three, x, w, kp), ref, x_sq, d, kp)
    tol = tround.gram_tolerance(x_sq, d, tk.KernelParams("linear"), 0.0)
    wi = w.numpy()
    sum_ab = float(np.abs(a64[wi]).dot(np.abs(a64).T).max())
    assert 2.0 ** -10 * sum_ab > tol > 3 * 2.0 ** -22 * sum_ab


@pytest.mark.parametrize("kind", ["rbf", "linear", "poly", "sigmoid"])
@pytest.mark.parametrize("case", ["headline", "ragged"])
def test_tf32x3_check_passes_3xtf32_and_refuses_one_pass(case, kind):
    """The check B4's float32 path is held to on the card (tf32x3_check,
    in chip_smoke.py and tests/test_torch_cuda.py): the kernel's error
    against the float64 Gram within 4x the plain version's own plus the
    3xTF32 product error. The emulated 3xTF32 kernel (per-stage partial
    sums, truncating MMA adds) passes it; one-pass TF32 does not, by a
    wide margin."""
    x, w, three, one = _tf32_case(case)
    x_sq = tk.squared_norms(x)
    # sigmoid's gamma keeps tanh off its saturation (K = 1 in float32).
    gamma, degree, coef0 = {"rbf": (0.125, 3, 0.0), "linear": (1.0, 3, 0.0),
                            "poly": (0.2, 3, 0.5),
                            "sigmoid": (1.0 / float(x_sq.max()), 3, 0.25)
                            }[kind]
    kp = tk.KernelParams(kind, gamma, degree, coef0)
    qsq = x_sq[w]
    plain = tround.gather_gram(x, w, x_sq, qsq, kp)
    ref = tround.gram_f64(x, w, x_sq, qsq, kp)
    err, err_p, limit = tround.tf32x3_check(_k_of(three, x, w, kp), plain,
                                            ref, x_sq, kp)
    assert err <= limit
    err1, _, _ = tround.tf32x3_check(_k_of(one, x, w, kp), plain, ref,
                                     x_sq, kp)
    assert err1 > 4 * limit


SMS = 132  # the H100's streaming multiprocessors
SM_SMEM = 233_472  # shared memory of one SM (228 KB), 1 KB of it per block


def _rows_plan_ok(q: int, rows: int) -> bool:
    """Kernel B5's launch (ops/round.py fold_rows_plan), as
    csrc/fold_select.cu fold_rows_kernel maps it: block b folds columns
    [128 b, 128 b + 128), lane l columns 4 l .. 4 l + 3; warp w the kernel
    rows k_range(q, warps, w). Every column once, every k in exactly one
    warp's range, no warp without rows, the shared memory within a
    block's limit and equal to what the kernel lays out."""
    p = tround.fold_rows_plan(q, rows)
    cols = (np.arange(p.blocks)[:, None, None] * 128
            + np.arange(32)[None, :, None] * 4 + np.arange(4)).ravel()
    col_hits = np.bincount(cols, minlength=rows * 128)
    ks = [k for w in range(p.warps) for k in tround.k_range(q, p.warps, w)]
    return (p.blocks == rows and len(col_hits) == rows * 128
            and bool((col_hits == 1).all()) and sorted(ks) == list(range(q))
            and all(len(tround.k_range(q, p.warps, w)) > 0
                    for w in range(p.warps))
            and 1 <= p.warps <= 8 and 1 <= p.chunk <= 32 and p.stages >= 1
            and p.smem == tround.fold_rows_smem(q, p.warps, p.chunk,
                                                p.stages)
            and p.smem <= tround.SMEM_LIMIT)


_QS = sorted(set(range(1, 70)) | {100, 127, 128, 129, 255, 256, 257, 1000,
                                  1023, 1024, 1025, 4095, 4096, 4097, 8191,
                                  8192})


@pytest.mark.parametrize("rows", [1, 2, 37, 471, 472, 473, 1024])
def test_fold_rows_plan_covers_every_column_and_k_once(rows):
    """q from 1 to 8192 (every q to 69, then the edges of 128 and of the
    largest q) at sampled row counts."""
    bad = [q for q in _QS if not _rows_plan_ok(q, rows)]
    assert not bad, bad[:5]


def test_fold_rows_plan_fills_the_card_at_the_headline():
    """At the fused round's headline (q 256, n_pad 60416: 472 rows) every
    SM gets blocks, all 472 fit on the card at once (shared memory and
    threads), and each SM keeps at least 32 KB of kernel rows in flight."""
    p = tround.fold_rows_plan(256, 472)
    per_sm = min(SM_SMEM // (p.smem + 1024), 2048 // (32 * p.warps))
    assert p.blocks >= SMS and per_sm * SMS >= p.blocks
    in_flight = p.warps * p.stages * p.chunk * 512
    assert (p.blocks // SMS) * in_flight >= 32 * 1024
    with pytest.raises(ValueError, match="q <= 8192"):
        tround.fold_rows_plan(8193, 472)
    with pytest.raises(ValueError, match="1 <= q"):
        tround.fold_rows_plan(0, 472)
