"""The port's one-pass round (dpsvm_tpu_torch/ops/round.py, plain versions
of kernels B4 and B5) against the JAX package's ops/pallas_round.py run in
interpret mode, on the same inputs made with numpy from a seed.

Kernel values come from matmuls that XLA and torch sum in other orders,
and exp/tanh/pow differ by a few ulps between them, so K rows, K(W, W)
and the folded f are held within rtol 1e-6 (non-negative features and
coef0 >= 0, so no dot or gamma * dot + coef0 cancels). The per-row
candidates are held bitwise against the plain fold_select fed the same
contraction."""

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
