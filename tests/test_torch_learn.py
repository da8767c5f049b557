"""The continuous-learning loop of the port (dpsvm_tpu_torch/learn.py)
against the JAX package's dpsvm_tpu/learn.py, on the CPU: the streams
(bit for bit the JAX package's), warm generations that save pairs
against a measured cold baseline, the flagged estimate, publishing into
the port's ServingEngine by hot swap with no request dropped, the
engine's learn counters, and `cli learn` (--smoke, forwarding, --obs
refused). Generation 0 is held against the JAX package's within the
port's whole-solve contract (SV count 2%, b 5e-3)."""

import json

import numpy as np
import pytest

from dpsvm_tpu import learn as jlearn
from dpsvm_tpu.config import SVMConfig as JaxConfig
from dpsvm_tpu.ops.kernels import KernelParams as JaxKP
from dpsvm_tpu_torch import learn
from dpsvm_tpu_torch.config import ServeConfig, SVMConfig
from dpsvm_tpu_torch.ops.kernels import KernelParams

KW = dict(c=1.0, gamma=1.0 / 6, epsilon=1e-3, max_iter=50_000)
CFG = SVMConfig(**KW)
KP = KernelParams(CFG.kernel, 1.0 / 6, CFG.degree, CFG.coef0)


def _stream(gens=2, rows=160, d=6, seed=0, drift=0.15):
    return learn.synthetic_stream(seed, d, rows, gens, drift)


# ------------------------------------------------------------ streams

def test_synthetic_stream_is_jaxs():
    incs = list(_stream(gens=3, rows=50, d=4))
    jincs = list(jlearn.synthetic_stream(0, 4, 50, 3, 0.15))
    assert len(incs) == 3
    for (x, y), (jx, jy) in zip(incs, jincs):
        assert x.shape == (50, 4) and y.shape == (50,)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    assert not np.array_equal(incs[0][1], incs[1][1])  # it drifts


def test_file_stream_chunks_and_validation(tmp_path):
    x = np.arange(30, dtype=np.float32).reshape(10, 3)
    y = np.array([0, 1] * 5)
    p = tmp_path / "stream.npz"
    np.savez(p, x=x, y=y)
    chunks = list(learn.file_stream(str(p), 4))
    assert [c[0].shape[0] for c in chunks] == [4, 4, 2]
    for (a, b), (ja, jb) in zip(chunks, jlearn.file_stream(str(p), 4)):
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(b, jb)
    np.savez(tmp_path / "bad.npz", x=x, y=np.arange(10) % 3)
    with pytest.raises(ValueError, match="binary-only"):
        list(learn.file_stream(str(tmp_path / "bad.npz"), 4))
    np.savez(tmp_path / "short.npz", x=x, y=y[:5])
    with pytest.raises(ValueError, match="rows"):
        list(learn.file_stream(str(tmp_path / "short.npz"), 4))


# ----------------------------------------------------- the warm loop

def test_run_learn_warm_generations_save_pairs(tmp_path):
    summary = learn.run_learn(_stream(gens=2, rows=200), CFG,
                              str(tmp_path / "models"), KP,
                              cold_baseline=True, device="cpu")
    assert summary["generations"] == 2
    g0, g1 = summary["gens"]
    assert g0["seed_sv"] == 0 and not g0["estimated"]
    assert g1["seed_sv"] > 0 and not g1["estimated"]
    assert g1["rows"] == g1["seed_sv"] + 200  # concat(prev SVs, fresh)
    assert g1["pairs_saved"] == g1["pairs_cold"] - g1["pairs"] > 0
    assert summary["pairs_saved_total"] == g1["pairs_saved"]
    for g in (0, 1):
        assert (tmp_path / "models" / f"gen_{g:04d}.npz").exists()
    # Generation 0 against the JAX package's (the same cold solve).
    jsum = jlearn.run_learn(jlearn.synthetic_stream(0, 6, 200, 1, 0.15),
                            JaxConfig(**KW), str(tmp_path / "jax"),
                            JaxKP("rbf", 1.0 / 6))
    jg0 = jsum["gens"][0]
    assert abs(g0["sv"] - jg0["sv"]) <= max(1, 0.02 * jg0["sv"])
    from dpsvm_tpu_torch.models.svm_model import SVMModel

    port0 = SVMModel.load(g0["path"])
    jax0 = SVMModel.load(jg0["path"])
    assert abs(port0.b - jax0.b) <= 5e-3


def test_run_learn_estimated_baseline_flagged(tmp_path):
    summary = learn.run_learn(_stream(gens=2, rows=120), CFG,
                              str(tmp_path / "m"), KP, cold_baseline=False,
                              device="cpu")
    g0, g1 = summary["gens"]
    assert g1["estimated"] is True
    assert g1["pairs_cold"] == int(round(g0["pairs"] / g0["rows"]
                                         * g1["rows"]))


# ------------------------------------- publishing: hot swap, no drops

def test_run_learn_publishes_with_zero_downtime(tmp_path):
    """Every generation is published through register / swap into the
    port's engine, the post-swap probe answers ok, requests in flight
    across a swap are neither dropped nor failed, and the counters land
    on the engine's registry."""
    from dpsvm_tpu_torch.serving import ServingEngine

    eng = ServingEngine(ServeConfig(buckets=(16, 64)), device="cpu")
    inflight, done = {}, {}
    orig_drain = eng.drain

    def drain_accumulating():
        out = orig_drain()
        done.update(out)
        return out

    eng.drain = drain_accumulating

    def hammer(g, model, info):
        for _ in range(3):  # enqueued, not drained: they ride the swap
            inflight[eng.submit(np.asarray(model.sv_x[:4], np.float32),
                                model="learn")] = g
        eng.pump()

    try:
        summary = learn.run_learn(_stream(gens=3, rows=120), CFG,
                                  str(tmp_path / "m"), KP,
                                  cold_baseline=True, engine=eng,
                                  on_generation=hammer, device="cpu")
        eng.drain()
    finally:
        eng.close()
    assert summary["generations"] == 3
    assert all(g["probe_verdict"] == "ok" for g in summary["gens"])
    assert eng.hot_swaps.value == 2  # gen 0 registers, 1 and 2 swap
    for t, g in inflight.items():
        assert t in done, f"ticket from gen {g} dropped across the swap"
        assert done[t].verdict == "ok"

    def count(name):
        return eng.metrics.counter(name).value

    assert count("learn.generations_total") == 3
    assert count("learn.pairs_total") == summary["pairs_total"]
    assert count("learn.pairs_saved_total") == summary["pairs_saved_total"]


# ----------------------------------------------------------- the CLI

def test_cli_learn_smoke(tmp_path, monkeypatch, capsys):
    """`cli learn --smoke` through the port's cli.main: two generations,
    the measured cold baseline, the in-process engine, pairs saved > 0
    and the post-swap probes served."""
    from dpsvm_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    assert cli.main(["learn", "--smoke", "--device", "cpu",
                     "--model-dir", str(tmp_path / "m")]) == 0
    out = capsys.readouterr().out
    assert "learn smoke PASS" in out and "probe=ok" in out


def test_cli_forwards_learn_and_refuses_obs(tmp_path, monkeypatch, capsys):
    from dpsvm_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    rc = cli.main(["learn", "--generations", "2", "--rows", "96", "--d",
                   "4", "--cold-baseline", "--json", "--device", "cpu",
                   "--model-dir", str(tmp_path / "m")])
    assert rc == 0
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload["generations"] == 2
    assert payload["gens"][1]["seed_sv"] > 0
    # --obs, once refused (item 11), writes the learn run log: one
    # generation event per generation, which obs report's learn column
    # reads.
    from dpsvm_tpu_torch.obs.analyze import (load_runs, render_report,
                                             summarize_run)

    runs = str(tmp_path / "runs")
    assert cli.main(["learn", "--obs", "--obs-dir", runs, "--device",
                     "cpu", "--generations", "2", "--rows", "96", "--d",
                     "4", "--model-dir", str(tmp_path / "m2")]) == 0
    learn = [r for r in load_runs([runs]) if r.manifest["tool"] == "learn"]
    assert len(learn) == 1
    assert [e["name"] for e in learn[0].events] == ["generation"] * 2
    assert "gen=2" in render_report([summarize_run(learn[0])])
