"""The active-set ("shrinking") engine on one device
(dpsvm_tpu_torch/solver/block.py run_chunk_block_active) against the JAX
package's _run_chunk_block_active on the same inputs.

Contracts: the cycle's first selection (select_block with q = m) is the
JAX package's bit for bit; whole solves meet the port's contract against
the JAX package's active solve (dual rel 1e-4, SV count 2%, |db| 5e-3)
and the JAX tests' against the plain block engine (tests/
test_block_engine.py:237-290: dual rel 1e-3); the pair budget is exact;
checkpoints stop and resume; the CLI's --active-set-size and
--reconcile-rounds reach the engine."""

import warnings

import numpy as np
import pytest

from dpsvm_tpu.config import SVMConfig as JaxConfig
from dpsvm_tpu.solver.block import select_block as jax_select_block
from dpsvm_tpu.solver.smo import solve as jax_solve
from dpsvm_tpu_torch import SVMConfig, SVMModel, cli, solve
from dpsvm_tpu_torch.data.synth import make_blobs_binary
from dpsvm_tpu_torch.ops.select import extrema_np
from dpsvm_tpu_torch.solver.block import select_block

KW = dict(c=1.0, gamma=0.1, epsilon=1e-3, max_iter=100_000, engine="block",
          working_set_size=32)


@pytest.fixture(scope="module")
def blobs():
    return make_blobs_binary(n=600, d=12, seed=11, sep=1.0)


def cpu(x, y, cfg, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return solve(x, y, cfg, device="cpu", **kw)


def jax_run(x, y, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jax_solve(x, y, JaxConfig(**{**KW, **kw}))


def _obj(r, y):
    a = np.asarray(r.alpha, np.float64)
    f = np.asarray(r.stats["f"], np.float64)
    return float(a.sum() - 0.5 * np.sum(a * y * (f + y)))


def _contract(rt, rj, y):
    assert rt.converged and rj.converged
    assert abs(_obj(rt, y) - _obj(rj, y)) <= 1e-4 * abs(_obj(rj, y))
    assert abs(rt.n_sv - rj.n_sv) <= max(2, 0.02 * rj.n_sv)
    assert abs(rt.b - rj.b) <= 5e-3


@pytest.mark.parametrize("m,k", [(64, 4), (256, 2), (4096, 8)])
def test_active_block_matches_plain_optimum(blobs, m, k):
    """Against the JAX package's active solve with the same (m, k), and
    against the plain block engine as the JAX test holds it."""
    x, y = blobs
    ra = cpu(x, y, SVMConfig(**KW, active_set_size=m, reconcile_rounds=k))
    _contract(ra, jax_run(x, y, active_set_size=m, reconcile_rounds=k), y)
    rb = cpu(x, y, SVMConfig(**KW))
    assert abs(ra.n_sv - rb.n_sv) <= max(2, 0.01 * rb.n_sv)
    assert abs(_obj(ra, y) - _obj(rb, y)) <= 1e-3 * abs(_obj(rb, y))
    # m clamped to [q, n]; rounds count every inner round.
    assert ra.stats["active_set_size"] == min(m, len(y))
    assert ra.stats["outer_rounds"] > 0


def test_active_block_class_weights_and_pair_batch(blobs):
    """Class weights (the JAX test's second half) and pair_batch=2 (the
    JAX package's tests/test_pair_batch.py:190) inside the cycle."""
    x, y = blobs
    for kw in (dict(weight_pos=2.0, weight_neg=0.5, active_set_size=128),
               dict(pair_batch=2, active_set_size=256)):
        _contract(cpu(x, y, SVMConfig(**KW, **kw)), jax_run(x, y, **kw), y)


def test_active_block_budget_cap_exact(blobs):
    """max_iter exactly, and a budget exit reports the refreshed extrema
    of the final state, in both packages."""
    x, y = blobs
    cfg = dict(active_set_size=64, max_iter=37)
    r = cpu(x, y, SVMConfig(**{**KW, **cfg}))
    rj = jax_run(x, y, **cfg)
    assert r.iterations == rj.iterations == 37
    assert not r.converged and not rj.converged
    b_hi, b_lo = extrema_np(r.stats["f"], r.alpha, y, KW["c"])
    assert r.b_hi == b_hi and r.b_lo == b_lo


def test_active_block_rejected_on_nonblock_engines():
    for cls in (SVMConfig, JaxConfig):
        with pytest.raises(ValueError, match="block-engine knob"):
            cls(engine="xla", active_set_size=64)
        with pytest.raises(ValueError, match="reconcile_rounds"):
            cls(engine="block", reconcile_rounds=0)


def test_first_cycle_selection_is_jaxs(blobs):
    """The cycle's active selection, select_block with q = m, from the
    same mid-solve state (ties included): the JAX package's ids, live
    mask and extrema bit for bit; and one cycle of one round from the
    start takes the JAX package's pairs."""
    import jax.numpy as jnp
    import torch

    x, y = blobs
    mid = cpu(x, y, SVMConfig(**{**KW, "max_iter": 300}))
    f = (np.round(mid.stats["f"] * 8) / 8).astype(np.float32)
    for m in (64, 256):
        tw, tok, tbh, tbl = select_block(
            torch.tensor(f), torch.tensor(mid.alpha),
            torch.tensor(y.astype(np.float32)), (1.0, 1.0), m)
        jw, jok, jbh, jbl = jax_select_block(
            jnp.asarray(f), jnp.asarray(mid.alpha),
            jnp.asarray(y.astype(np.float32)), (1.0, 1.0), m)
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        assert float(tbh) == float(jbh) and float(tbl) == float(jbl)
    kw = dict(active_set_size=128, reconcile_rounds=1, inner_iters=8,
              max_iter=8)
    r1 = cpu(x, y, SVMConfig(**{**KW, **kw}))
    rj = jax_run(x, y, **kw)
    assert r1.iterations == rj.iterations == 8
    np.testing.assert_array_equal(np.nonzero(r1.alpha)[0],
                                  np.nonzero(rj.alpha)[0])
    np.testing.assert_allclose(r1.alpha, rj.alpha, rtol=1e-5, atol=1e-6)


def test_active_checkpoint_stop_and_resume(blobs, tmp_path):
    """An observed active solve stopped after its second chunk with a
    file every chunk resumes to the uninterrupted solve's optimum."""
    x, y = blobs
    cfg = SVMConfig(**KW, active_set_size=128, reconcile_rounds=4,
                    chunk_iters=256, checkpoint_every=1)
    p = str(tmp_path / "a.npz")
    seen = []

    def stop(*_):
        seen.append(1)
        return len(seen) >= 2

    part = cpu(x, y, cfg, checkpoint_path=p, callback=stop)
    assert not part.converged and part.stats["chunks"] == 2
    res = cpu(x, y, cfg, checkpoint_path=p, resume=True)
    full = cpu(x, y, cfg.replace(checkpoint_every=0))
    assert res.iterations > part.iterations
    _contract(res, full, y)


def test_active_warns_and_cli_reaches_the_engine(blobs, tmp_path):
    """The JAX package's warning (without its TPU figures) on one
    device; the CLI's --active-set-size / --reconcile-rounds train the
    API's model bit for bit, on one device and on a CPU mesh."""
    from dpsvm_tpu_torch import Mesh, train
    from dpsvm_tpu_torch.data.loader import save_csv

    x, y = blobs
    cfg = SVMConfig(**KW, active_set_size=64, reconcile_rounds=2)
    with pytest.warns(UserWarning, match="never beat the plain block"):
        solve(x, y, cfg, device="cpu")
    csv = str(tmp_path / "t.csv")
    save_csv(csv, x, y)
    flags = ["train", "-f", csv, "-c", "1", "-g", "0.1", "--engine",
             "block", "--working-set-size", "32", "--active-set-size",
             "64", "--reconcile-rounds", "2", "-q", "--device", "cpu"]
    for extra, kw in (([], dict(device="cpu")),
                      (["--backend", "mesh", "--num-devices", "2"],
                       dict(backend="mesh", mesh=Mesh(["cpu"] * 2)))):
        m = str(tmp_path / f"m{len(extra)}.txt")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert cli.main(flags + extra + ["-m", m]) == 0
            api, res = train(x, y, cfg, **kw)
        assert res.stats["active_set_size"] == 64
        np.testing.assert_array_equal(SVMModel.load(m).dual_coef,
                                      api.dual_coef)
