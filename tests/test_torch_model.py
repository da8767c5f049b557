"""Models across the two packages: files written by either load in the
other, decision functions agree, the port's CLI round-trips a CSV, and
state carried across with dpsvm_tpu_torch.convert decides and selects as
the JAX package does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpsvm_tpu.config import SVMConfig as JaxConfig
from dpsvm_tpu.models.svm_model import SVMModel as JaxModel
from dpsvm_tpu.ops.kernels import KernelParams as JaxKP
from dpsvm_tpu.predict import decision_function as jax_decision
from dpsvm_tpu.solver import block as jblock
from dpsvm_tpu.train import train as jax_train
from dpsvm_tpu_torch import SVMModel, accuracy, decision_function, predict
from dpsvm_tpu_torch import cli
from dpsvm_tpu_torch.convert import block_state_from_reference, model_from_reference
from dpsvm_tpu_torch.data import load_csv, make_blobs_binary, save_csv
from dpsvm_tpu_torch.ops.kernels import KernelParams
from dpsvm_tpu_torch.solver import block as tblock


@pytest.fixture(scope="module")
def jax_model():
    x, y = make_blobs_binary(n=400, d=8, seed=2, sep=1.5)
    model, _ = jax_train(x[:300], y[:300],
                         JaxConfig(c=2.0, gamma=0.2, engine="block",
                                   working_set_size=32), backend="single")
    return model, x[300:], y[300:]


def _same_model(a, b):
    np.testing.assert_array_equal(a.sv_x, b.sv_x)
    np.testing.assert_array_equal(a.sv_alpha, b.sv_alpha)
    np.testing.assert_array_equal(a.sv_y, b.sv_y)
    assert float(a.b) == float(b.b) or np.float32(a.b) == np.float32(b.b)
    assert a.kernel.kind == b.kernel.kind
    assert np.float32(a.kernel.gamma) == np.float32(b.kernel.gamma)


@pytest.mark.parametrize("ext", ["txt", "npz"])
def test_files_load_in_either_package(jax_model, tmp_path, ext):
    jm, _, _ = jax_model
    p_jax = str(tmp_path / f"jax.{ext}")
    jm.save(p_jax)
    port = SVMModel.load(p_jax)
    _same_model(port, jm)
    p_port = str(tmp_path / f"port.{ext}")
    port.save(p_port)
    # The text files differ in digits (the JAX package's native writer
    # prints 9 significant digits, the port repr() of the float32 value);
    # both round-trip the same float32 values, which _same_model checks.
    _same_model(JaxModel.load(p_port), jm)


def test_text_model_one_line_header_loads(tmp_path):
    p = tmp_path / "seq.txt"
    p.write_text("0.5\n0.25,1,1.0,2.0\n0.75,-1,0.0,1.0\n")
    m = SVMModel.load(str(p))
    assert m.b == 0.0 and m.n_sv == 2 and m.kernel.gamma == 0.5
    np.testing.assert_array_equal(m.dual_coef, [0.25, -0.75])


@pytest.mark.parametrize("kind", ["rbf", "poly"])
def test_decision_function_matches_jax(jax_model, kind):
    jm, xq, yq = jax_model
    if kind != "rbf":
        jm = JaxModel(jm.sv_x, jm.sv_alpha, jm.sv_y, jm.b,
                      JaxKP("poly", 0.1, 3, 1.0))
    pm = model_from_reference(jm)
    d32_j = np.asarray(jax_decision(jm, xq, precision="float32"))
    d32_t = decision_function(pm, xq, precision="float32", device="cpu")
    np.testing.assert_allclose(d32_t, d32_j, rtol=1e-5, atol=1e-5)
    d64_j = np.asarray(jax_decision(jm, xq, precision="float64"))
    d64_t = decision_function(pm, xq, precision="float64", device="cpu")
    np.testing.assert_allclose(d64_t, d64_j, rtol=1e-12, atol=1e-12)
    assert d64_t.dtype == np.float64
    np.testing.assert_array_equal(
        predict(pm, xq, device="cpu"), np.where(d64_j >= 0, 1, -1))
    assert accuracy(pm, xq, yq, device="cpu") == pytest.approx(
        float(np.mean(np.where(d64_j >= 0, 1, -1) == yq)))


def test_auto_precision_routes_extreme_coefficients(jax_model):
    jm, xq, _ = jax_model
    pm = model_from_reference(jm)
    big = SVMModel(pm.sv_x, pm.sv_alpha * 1e7, pm.sv_y, pm.b, pm.kernel)
    d = decision_function(big, xq, precision="auto", device="cpu")
    assert d.dtype == np.float64
    assert decision_function(pm, xq, precision="auto",
                             device="cpu").dtype == np.float32


def test_cli_train_test_round_trip(tmp_path, capsys):
    x, y = make_blobs_binary(n=160, d=5, seed=4, sep=1.8)
    train_csv, test_csv = str(tmp_path / "tr.csv"), str(tmp_path / "te.csv")
    save_csv(train_csv, x[:120], y[:120])
    save_csv(test_csv, x[120:], y[120:])
    xl, yl = load_csv(train_csv)
    np.testing.assert_array_equal(xl, x[:120])
    model_path = str(tmp_path / "m.txt")
    rc = cli.main(["train", "-f", train_csv, "-m", model_path, "-c", "1",
                   "-g", "0.2", "-e", "0.001", "--engine", "block",
                   "--working-set-size", "16", "--selection",
                   "second_order", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "converged at iteration" in out
    rc = cli.main(["test", "-f", test_csv, "-m", model_path,
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    acc = float(out.split("test accuracy: ")[1].split()[0])
    assert acc >= 0.9
    # The JAX package reads the port's model and scores it the same.
    jm = JaxModel.load(model_path)
    d_j = np.asarray(jax_decision(jm, x[120:], precision="float64"))
    assert float(np.mean(np.where(d_j >= 0, 1, -1) == y[120:])) == \
        pytest.approx(acc, abs=1e-4)


def test_cli_refuses_unported_engine(tmp_path, capsys):
    x, y = make_blobs_binary(n=20, d=3, seed=1)
    csv = str(tmp_path / "d.csv")
    save_csv(csv, x, y)
    # The block engine's pair batch and the pipelined rounds on the mesh
    # are ported; the out-of-core stream on the mesh is not.
    rc = cli.main(["train", "-f", csv, "-m", str(tmp_path / "m.txt"),
                   "--engine", "block", "--pair-batch", "2", "--device",
                   "cpu", "--working-set-size", "8"])
    assert rc == 0
    mesh = ["--engine", "block", "--backend", "mesh", "--num-devices", "2",
            "--device", "cpu", "--working-set-size", "8"]
    rc = cli.main(["train", "-f", csv, "-m", str(tmp_path / "m.txt"),
                   "--pipeline-rounds", "on", *mesh])
    assert rc == 0
    rc = cli.main(["train", "-f", csv, "-m", str(tmp_path / "m.txt"),
                   "--ooc", *mesh])
    assert rc == 2
    assert "ROADMAP" in capsys.readouterr().err


def test_converted_block_state_selects_the_same_next_round(blobs_medium):
    """A JAX BlockState a few rounds into a solve, carried across,
    gives the same next-round working set and extrema in both packages."""
    from dpsvm_tpu.ops.kernels import (KernelParams as JKP, kernel_diag,
                                       squared_norms)
    from dpsvm_tpu.solver.smo import init_state

    x, y = blobs_medium
    yf = jnp.asarray(y, jnp.float32)
    xj = jnp.asarray(x)
    kp = JKP("rbf", 0.1)
    x_sq = squared_norms(xj)
    st = init_state(len(y), yf, 1)
    st = jblock.BlockState(st.alpha, st.f, st.b_hi, st.b_lo, st.it,
                           jnp.int32(0), jnp.zeros_like(st.f))
    st = jblock.run_chunk_block(xj, yf, x_sq, kernel_diag(x_sq, kp), None,
                                st, jnp.int32(10_000), kp, (1.0, 1.0), 1e-3,
                                1e-12, 64, 128, 3)
    assert int(st.rounds) == 3
    pst = block_state_from_reference(st, "cpu")
    assert int(pst.pairs) == int(st.pairs) and int(pst.rounds) == 3
    np.testing.assert_array_equal(pst.alpha.numpy(), np.asarray(st.alpha))
    np.testing.assert_array_equal(pst.f_err.numpy(), np.asarray(st.f_err))
    f_eff = st.f - st.f_err
    for rule in ("mvp", "second_order"):
        jw, jok, jbh, jbl = jblock.select_block(f_eff, st.alpha, yf, 1.0,
                                                64, rule=rule)
        tw, tok, tbh, tbl = tblock.select_block(
            pst.f - pst.f_err, pst.alpha, torch.as_tensor(y, dtype=torch.float32),
            1.0, 64, rule=rule)
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        assert float(tbh) == float(jbh) and float(tbl) == float(jbl)


def test_converted_model_keeps_fields(jax_model):
    jm, _, _ = jax_model
    pm = model_from_reference(jm)
    _same_model(pm, jm)
    assert isinstance(pm.kernel, KernelParams)


def test_platt_pair_survives_the_port(tmp_path):
    """Fault C.19: a calibrated JAX model (prob_a / prob_b) saved to .npz,
    loaded and saved again by the port, loads in JAX still calibrated;
    the port refuses to write it as text, as JAX does."""
    rng = np.random.default_rng(0)
    sv = rng.normal(size=(5, 3)).astype(np.float32)
    jm = JaxModel(sv, np.ones(5, np.float32), np.array([1, -1, 1, -1, 1],
                  np.int32), 0.1, JaxKP("rbf", 0.5), prob_a=-1.5, prob_b=0.2)
    jm.save(str(tmp_path / "j.npz"))
    tm = SVMModel.load(str(tmp_path / "j.npz"))
    assert tm.has_probability and (tm.prob_a, tm.prob_b) == (-1.5, 0.2)
    tm.save(str(tmp_path / "t.npz"))
    back = JaxModel.load(str(tmp_path / "t.npz"))
    assert back.has_probability
    assert (back.prob_a, back.prob_b) == (jm.prob_a, jm.prob_b)
    conv = model_from_reference(jm)
    assert (conv.prob_a, conv.prob_b) == (-1.5, 0.2)
    with pytest.raises(ValueError, match="Platt") as et:
        tm.save(str(tmp_path / "t.txt"))
    with pytest.raises(ValueError, match="Platt") as ej:
        jm.save(str(tmp_path / "j.txt"))
    assert str(et.value) == str(ej.value)
    # Uncalibrated models write no pair, in either package.
    plain = SVMModel(sv, np.ones(5, np.float32), jm.sv_y, 0.1,
                     KernelParams("rbf", 0.5))
    plain.save(str(tmp_path / "p.npz"))
    assert not JaxModel.load(str(tmp_path / "p.npz")).has_probability
    assert not SVMModel.load(str(tmp_path / "p.npz")).has_probability
