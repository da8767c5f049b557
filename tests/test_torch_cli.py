"""The port's CLI against the JAX package's (dpsvm_tpu.cli.main) on the
same CSV and LIBSVM files: every feature-kernel family and the class
weights. Each package's model decides identically under the other, the
-o files of `test` match, and --precision float64 matches. Then the
state flags (--checkpoint, --checkpoint-every, --checkpoint-keep,
--resume, --chunk-iters), --backend reference|native, --bf16-gram and
the refusals. Mirrors tests/test_cli.py's train/test cases."""

import os

import numpy as np
import pytest

from dpsvm_tpu import cli as jax_cli
from dpsvm_tpu.models.svm_model import SVMModel as JaxModel
from dpsvm_tpu.predict import decision_function as jax_dec
from dpsvm_tpu_torch import SVMModel, cli, decision_function
from dpsvm_tpu_torch.data.synth import make_blobs_binary
from dpsvm_tpu_torch.utils.checkpoint import (checkpoint_generations,
                                              load_checkpoint_state)


def _write(tmp_path, n=160, d=6, seed=3):
    x, y = make_blobs_binary(n=n, d=d, seed=seed, sep=1.2)
    csv = str(tmp_path / "d.csv")
    lsv = str(tmp_path / "d.libsvm")
    with open(csv, "w") as fh:
        for xi, yi in zip(x, y):
            fh.write(f"{int(yi)}," + ",".join("%.9g" % v for v in xi) + "\n")
    with open(lsv, "w") as fh:
        for xi, yi in zip(x, y):
            fh.write(" ".join([str(int(yi))] + [
                f"{j + 1}:{v:.9g}" for j, v in enumerate(xi) if v != 0])
                + "\n")
    return x, y, csv, lsv


@pytest.fixture
def data(tmp_path):
    return _write(tmp_path)


KERNELS = [
    ["--kernel", "rbf", "-g", "0.2"],
    ["--kernel", "linear"],
    ["--kernel", "poly", "--degree", "2", "--coef0", "1", "-g", "0.1"],
    ["--kernel", "sigmoid", "--coef0", "0.5", "-g", "0.05"],
    ["--kernel", "rbf", "-g", "0.2", "-w1", "2", "-w-1", "0.5"],
]


def _train(main, path, model, extra, device=()):
    rc = main(["train", "-f", path, "-m", model, "-c", "1", "-e", "0.001",
               "-q", *extra, *device])
    assert rc == 0


@pytest.mark.parametrize("kernel", KERNELS,
                         ids=lambda k: "-".join(k[1:2] + k[-2:]))
@pytest.mark.parametrize("fmt", ["csv", "libsvm"])
def test_models_decide_identically_under_the_other(data, tmp_path, kernel,
                                                   fmt):
    x, y, csv, lsv = data
    path = csv if fmt == "csv" else lsv
    # .npz: the reference text format holds RBF models only.
    pm, jm = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    _train(cli.main, path, pm, kernel, ("--device", "cpu"))
    _train(jax_cli.main, path, jm, kernel)
    # Each package's model file decides the same under the other.
    port_model = SVMModel.load(pm)
    np.testing.assert_allclose(
        jax_dec(JaxModel.load(pm), x),
        decision_function(port_model, x, device="cpu"), rtol=1e-5,
        atol=1e-5)
    np.testing.assert_allclose(
        decision_function(SVMModel.load(jm), x, device="cpu"),
        jax_dec(JaxModel.load(jm), x), rtol=1e-5, atol=1e-5)
    # The two packages' models: the whole-solve contract.
    pd = decision_function(port_model, x, device="cpu")
    jd = jax_dec(JaxModel.load(jm), x)
    assert np.mean(np.sign(pd) == np.sign(jd)) >= 0.99
    assert abs(port_model.n_sv - JaxModel.load(jm).n_sv) <= \
        max(2, 0.1 * JaxModel.load(jm).n_sv)
    assert port_model.kernel.kind == kernel[1]


@pytest.mark.parametrize("precision", ["float32", "float64", "auto"])
@pytest.mark.parametrize("fmt", ["auto", "csv", "libsvm"])
def test_test_outputs_match_jax(data, tmp_path, precision, fmt):
    """`test` of one model file by both CLIs: the same -o labels and the
    same accuracy line, at every precision and input format."""
    x, y, csv, lsv = data
    m = str(tmp_path / "m.txt")
    _train(jax_cli.main, csv, m, KERNELS[0])
    path = lsv if fmt == "libsvm" else csv
    outs = {}
    for name, main, dev in (("port", cli.main, ["--device", "cpu"]),
                            ("jax", jax_cli.main, [])):
        o = str(tmp_path / f"{name}.out")
        assert main(["test", "-f", path, "-m", m, "-o", o, "--format", fmt,
                     "--precision", precision, *dev]) == 0
        outs[name] = open(o).read()
    assert outs["port"] == outs["jax"]
    assert len(outs["port"].split()) == len(y)


def test_float64_decisions_match_jax(data, tmp_path):
    x, y, csv, _ = data
    m = str(tmp_path / "m.txt")
    _train(cli.main, csv, m, KERNELS[0], ("--device", "cpu"))
    got = decision_function(SVMModel.load(m), x, precision="float64",
                            device="cpu")
    want = jax_dec(JaxModel.load(m), x, precision="float64")
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_libsvm_and_csv_train_the_same_model(data, tmp_path):
    x, y, csv, lsv = data
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    _train(cli.main, csv, a, ["--engine", "block", "--working-set-size",
                              "16"], ("--device", "cpu"))
    _train(cli.main, lsv, b, ["--engine", "block", "--working-set-size",
                              "16", "--format", "auto"], ("--device", "cpu"))
    ma, mb = SVMModel.load(a), SVMModel.load(b)
    np.testing.assert_array_equal(ma.sv_x, mb.sv_x)
    np.testing.assert_array_equal(ma.dual_coef, mb.dual_coef)
    assert ma.b == mb.b


def test_svr_and_oneclass_output_files_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(80, 3)).astype(np.float32)
    z = np.sin(x[:, 0]).astype(np.float32)
    p = str(tmp_path / "r.csv")
    with open(p, "w") as fh:
        for xi, zi in zip(x, z):
            fh.write("%.9g," % zi + ",".join("%.9g" % v for v in xi) + "\n")
    for svm_type in ("eps-svr", "one-class"):
        m = str(tmp_path / f"{svm_type}.npz")
        assert jax_cli.main(["train", "-f", p, "-m", m, "-t", svm_type,
                             "-g", "0.5", "-q"]) == 0
        outs = {}
        for name, main, dev in (("port", cli.main, ["--device", "cpu"]),
                                ("jax", jax_cli.main, [])):
            o = str(tmp_path / f"{name}.out")
            assert main(["test", "-f", p, "-m", m, "-o", o, *dev]) == 0
            outs[name] = np.loadtxt(o)
        np.testing.assert_allclose(outs["port"], outs["jax"], atol=1e-5)
        # --precision is a binary-classifier flag, in both packages.
        assert cli.main(["test", "-f", p, "-m", m, "--precision",
                         "float64", "--device", "cpu"]) == 2


def test_checkpoint_flags_and_resume(data, tmp_path):
    """--checkpoint / --checkpoint-every / --checkpoint-keep write the
    rotating generations; --resume from a file the JAX CLI wrote
    continues the solve."""
    x, y, csv, _ = data
    ck = str(tmp_path / "ck.npz")
    m = str(tmp_path / "m.txt")
    base = ["-g", "0.2", "--chunk-iters", "32", "--checkpoint", ck,
            "--checkpoint-every", "32", "--checkpoint-keep", "2"]
    _train(cli.main, csv, m, base, ("--device", "cpu"))
    assert [os.path.basename(g) for g in checkpoint_generations(ck)] == \
        ["ck.npz", "ck.npz.1"]
    its = [load_checkpoint_state(g).iteration
           for g in checkpoint_generations(ck)]
    assert its[0] > its[1] > 0
    # The JAX CLI writes a mid-solve checkpoint; the port resumes it.
    jck = str(tmp_path / "j.npz")
    assert jax_cli.main(["train", "-f", csv, "-m", str(tmp_path / "j.txt"),
                         "-c", "1", "-g", "0.2", "-n", "48",
                         "--chunk-iters", "16", "--checkpoint", jck,
                         "--checkpoint-every", "16", "-q"]) == 0
    assert load_checkpoint_state(jck).iteration == 48
    r = str(tmp_path / "r.txt")
    assert cli.main(["train", "-f", csv, "-m", r, "-c", "1", "-g", "0.2",
                     "--checkpoint", jck, "--resume", "--device",
                     "cpu"]) == 0
    np.testing.assert_allclose(SVMModel.load(r).b, SVMModel.load(m).b,
                               atol=1e-3)


def test_progress_lines_unless_quiet(data, tmp_path, capsys):
    x, y, csv, _ = data
    m = str(tmp_path / "m.txt")
    assert cli.main(["train", "-f", csv, "-m", m, "-g", "0.2",
                     "--chunk-iters", "64", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "loaded 160 examples" in out and "[single-device] iter=" in out
    assert cli.main(["train", "-f", csv, "-m", m, "-g", "0.2", "-q",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "loaded" not in out and "iter=" not in out


@pytest.mark.parametrize("backend", ["reference", "native"])
def test_host_backends_through_the_cli(data, tmp_path, backend):
    x, y, csv, _ = data
    pm, jm = str(tmp_path / "p.txt"), str(tmp_path / "j.txt")
    _train(cli.main, csv, pm, ["-g", "0.2", "--backend", backend],
           ("--device", "cpu"))  # the device of the accuracy line
    _train(jax_cli.main, csv, jm, ["-g", "0.2", "--backend", backend])
    a, b = SVMModel.load(pm), SVMModel.load(jm)
    np.testing.assert_array_equal(a.sv_x, b.sv_x)
    np.testing.assert_array_equal(a.dual_coef, b.dual_coef)
    assert cli.main(["train", "-f", csv, "-m", pm, "--backend", backend,
                     "--engine", "block"]) == 2


def test_bf16_gram_flag(data, tmp_path, capsys):
    x, y, csv, _ = data
    m = str(tmp_path / "m.txt")
    _train(cli.main, csv, m, ["-g", "0.2", "--bf16-gram", "--engine",
                              "block", "--working-set-size", "16"],
           ("--device", "cpu"))
    assert cli.main(["train", "-f", csv, "-m", m, "--bf16-gram", "--dtype",
                     "bfloat16", "--device", "cpu"]) == 2
    assert "use one or the other" in capsys.readouterr().err


@pytest.mark.parametrize("argv,match", [
    (["--retry-faults", "0"], "item 11"),
    (["--kernel", "precomputed"], "item 6"),
    (["-t", "nu-svc", "-w1", "2"], "not applicable"),
    (["--format", "libsvm", "-t", "eps-svr"], "regression targets"),
])
def test_refusals(data, tmp_path, capsys, argv, match):
    x, y, csv, lsv = data
    path = lsv if "libsvm" in argv else csv
    rc = cli.main(["train", "-f", path, "-m", str(tmp_path / "m.txt"),
                   "-q", "--device", "cpu", *argv])
    assert rc == 2
    assert match in capsys.readouterr().err


def test_test_width_rules_match_jax(data, tmp_path, capsys):
    """A wider CSV needs -a to consent; -a must be the model's width."""
    x, y, csv, _ = data
    m = str(tmp_path / "m.txt")
    _train(cli.main, csv, m, ["-g", "0.2"], ("--device", "cpu"))
    wide = str(tmp_path / "w.csv")
    with open(wide, "w") as fh:
        for xi, yi in zip(x, y):
            fh.write(f"{int(yi)}," + ",".join("%.9g" % v for v in xi)
                     + ",0.5\n")
    for main, dev in ((cli.main, ["--device", "cpu"]), (jax_cli.main, [])):
        assert main(["test", "-f", wide, "-m", m, *dev]) == 2
        assert main(["test", "-f", wide, "-m", m, "-a", "6", *dev]) == 0
        assert main(["test", "-f", wide, "-m", m, "-a", "5", *dev]) == 2
