"""The per-pair engines' chunk on the device (solver/smo.py queue_trips):
no trip reads the host. The host queues TRIPS trips and reads once; a
trip queued after the loop's stop is masked and changes nothing, so a
solve is bitwise the same with TRIPS = 1 and TRIPS = 256 (alpha, f,
f_err, the pair and hit counters, the extrema) on every per-pair
configuration, and a chunk reads the host at most ceil(trips / TRIPS) +
1 times (analysis/op_facts.py Recorder, transfers.host_reads)."""

import math

import numpy as np
import pytest
import torch

from dpsvm_tpu_torch import SVMConfig, solve, train_nusvc
from dpsvm_tpu_torch.analysis.op_facts import Recorder
from dpsvm_tpu_torch.ops.kernels import KernelParams
from dpsvm_tpu_torch.solver import chunks
from dpsvm_tpu_torch.solver import smo as tsmo

BASE = dict(c=1.0, gamma=0.1)
ROWS = 200
RUNNERS = ("run_chunk", "run_chunk_micro", "run_chunk_pallas")

CONFIGS = {
    "mvp": dict(),
    "nu": dict(selection="nu"),
    "second_order": dict(selection="second_order"),
    "cache": dict(cache_lines=8),
    "second_order-cache": dict(selection="second_order", cache_lines=4),
    "compensated": dict(compensated=True, weight_pos=2.0, weight_neg=0.5),
    "gram": dict(gram_resident=True),
    "precomputed": dict(kernel="precomputed"),
    "micro4": dict(pair_batch=4),
    "micro8-compensated": dict(pair_batch=8, compensated=True),
    "pallas": dict(engine="pallas"),
    "pallas-cache": dict(engine="pallas", cache_lines=8),
}


@pytest.fixture(scope="module")
def rows(blobs_small):
    """The first ROWS rows of the small blobs, and their RBF Gram (the
    precomputed configuration's X)."""
    x, y = blobs_small
    x, y = x[:ROWS], y[:ROWS]
    sq = (x * x).sum(1)
    gram = np.exp(-BASE["gamma"] * np.maximum(
        sq[:, None] + sq[None, :] - 2.0 * x @ x.T, 0.0)).astype(np.float32)
    return x, y, gram


def _runs(monkeypatch, trips: int) -> list:
    """Set TRIPS and wrap the runners: returns the list each runner call
    appends (final state, trips it queued, host reads it made) to."""
    monkeypatch.setattr(tsmo, "TRIPS", trips)
    calls = []
    for name in RUNNERS:
        def wrap(*args, _fn=getattr(tsmo, name), **kw):
            tally = kw["tally"]
            t0, r0 = tally["trips"], tally["reads"]
            st = _fn(*args, **kw)
            calls.append((st, tally["trips"] - t0, tally["reads"] - r0))
            return st
        monkeypatch.setattr(tsmo, name, wrap)
    return calls


def _solve(rows, kw, **extra):
    x, y, gram = rows
    if kw.get("selection") == "nu":  # the nu duals' rule: their trainer
        return train_nusvc(x, y, nu=0.2, config=SVMConfig(**BASE),
                           device="cpu", **extra)[1]
    return solve(gram if kw.get("kernel") == "precomputed" else x, y,
                 SVMConfig(**BASE, **kw), device="cpu", **extra)


def _bits(t):
    return None if t is None else t.contiguous().view(torch.int32).clone()


def _state_bits(st) -> dict:
    return {"alpha": _bits(st.alpha), "f": _bits(st.f),
            "f_err": _bits(st.f_err), "b_hi": _bits(st.b_hi),
            "b_lo": _bits(st.b_lo), "it": int(st.it), "hits": int(st.hits)}


def _same(a: dict, b: dict) -> bool:
    """Every entry equal: tensors bit for bit, ints and None as such."""
    return all(torch.equal(a[k], b[k]) if torch.is_tensor(a[k])
               and torch.is_tensor(b[k]) else a[k] == b[k] for k in a)


@pytest.mark.parametrize("name", CONFIGS)
def test_trips_between_reads_do_not_move_the_result(monkeypatch, rows,
                                                    name):
    kw = CONFIGS[name]
    out = {}
    for trips in (1, 256):
        calls = _runs(monkeypatch, trips)
        res = _solve(rows, kw)
        st, queued, reads = calls[-1]
        out[trips] = (_state_bits(st), res)
        assert res.converged
        assert res.stats["trips_queued"] == queued
        # One read a batch: every trip at TRIPS = 1, one in 256 at 256.
        assert reads == math.ceil(queued / trips)
    (s1, r1), (s256, r256) = out[1], out[256]
    assert _same(s1, s256), name
    assert r1.iterations == r256.iterations == s1["it"]
    assert r1.stats["cache_hits"] == r256.stats["cache_hits"] == s1["hits"]
    assert r1.b == r256.b
    np.testing.assert_array_equal(r1.alpha, r256.alpha)
    # Trips queued past the stop (at 256) are masked, so they are more.
    assert r256.stats["trips_queued"] >= r1.stats["trips_queued"]


@pytest.mark.parametrize("name", ["mvp", "second_order-cache", "micro4",
                                  "pallas-cache"])
def test_host_reads_per_chunk(monkeypatch, rows, name):
    """An observed solve (chunks of 40 pairs, TRIPS = 8): the chunk loop
    records at most ceil(trips / 8) + 1 host reads a chunk, the runners'
    batch reads and the chunk's own read of (pairs, b_hi, b_lo), and no
    implicit synchronization (an op whose output shape reads the
    device: nonzero, boolean indexing)."""
    calls = _runs(monkeypatch, 8)
    seen = {}
    run_chunks = chunks.run_chunks

    def recorded(*args, **kw):
        with Recorder() as rec:
            out = run_chunks(*args, **kw)
        seen["reads"], seen["syncs"] = rec.host_reads, rec.syncs
        return out

    monkeypatch.setattr(chunks, "run_chunks", recorded)
    res = _solve(rows, {**CONFIGS[name], "chunk_iters": 40},
                 callback=lambda it, b_hi, b_lo, state: None)
    assert res.converged and res.stats["chunks"] == len(calls) > 2
    bound = sum(math.ceil(queued / 8) + 1 for _, queued, _ in calls)
    assert seen["reads"] == res.stats["host_reads"] <= bound
    assert seen["syncs"] == 0
    # A chunk that ends on the pair budget queues no masked trip.
    k = CONFIGS[name].get("pair_batch", 1)
    assert all(queued == math.ceil(40 / k) for _, queued, _ in calls[:-1])


@pytest.mark.parametrize("selection", ["mvp", "second_order"])
def test_masked_trips_change_nothing(monkeypatch, blobs_small, selection):
    """A runner that does not know the pair count on the host queues
    whole batches: the trips past max_iter are masked, and the state is
    bitwise the one of exactly max_iter trips queued one by one."""
    x, y = blobs_small
    xt, yt = torch.as_tensor(x), torch.as_tensor(y.astype(np.float32))
    x_sq = (xt * xt).sum(1)
    kp = KernelParams("rbf", BASE["gamma"])
    out = []
    for trips in (1, 64):
        monkeypatch.setattr(tsmo, "TRIPS", trips)
        st = tsmo.init_pair_state(yt, cache_lines=6)
        tally = {}
        st = tsmo.run_chunk(xt, yt, x_sq, torch.ones_like(x_sq), None, st,
                            37, kp, (1.0, 1.0), 1e-3, 1e-12, selection,
                            tally=tally)
        out.append((_state_bits(st), st.cache, tally))
    (a, ca, ta), (b, cb, tb) = out
    assert a["it"] == b["it"] == 37
    assert ta["trips"] == 37 and tb["trips"] == 64
    assert _same(a, b)
    for f in ("store", "keys", "ticks"):
        assert torch.equal(getattr(ca, f), getattr(cb, f))
