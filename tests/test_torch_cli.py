"""The port's CLI against the JAX package's (dpsvm_tpu.cli.main) on the
same CSV and LIBSVM files: every feature-kernel family and the class
weights. Each package's model decides identically under the other, the
-o files of `test` match, and --precision float64 matches. Then the
state flags (--checkpoint, --checkpoint-every, --checkpoint-keep,
--resume, --chunk-iters), --backend reference|native, --bf16-gram and
the refusals; multiclass files (--multiclass, --fleet-size), -v, -b and
--kernel precomputed, each against the JAX CLI on the same file. Mirrors
tests/test_cli.py's train/test cases."""

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


@pytest.mark.parametrize("flags", [
    ["--ooc", "--ooc-tile-rows", "64"],
    ["--ooc", "--ooc-tile-rows", "64", "--ooc-cache-lines", "64"],
    ["--ooc", "--ooc-tile-rows", "32", "--ooc-shrink", "on",
     "--active-set-size", "64"],
], ids=["ooc", "cache", "shrink"])
def test_ooc_flags_train_like_the_api_and_jax(data, tmp_path, capsys, flags):
    """--ooc and its knobs reach SVMConfig: the CLI model is the API's
    ooc solve bit for bit, and within the contract of the JAX CLI's."""
    from dpsvm_tpu_torch import SVMConfig, train

    x, y, csv, _ = data
    block = ["--engine", "block", "--working-set-size", "16", "-g", "0.2"]
    m, jm = str(tmp_path / "m.npz"), str(tmp_path / "jm.npz")
    _train(cli.main, csv, m, block + flags, ("--device", "cpu"))
    _train(jax_cli.main, csv, jm, block + flags)
    kw = dict(ooc=True, ooc_tile_rows=int(flags[2]))
    if "--ooc-cache-lines" in flags:
        kw["ooc_cache_lines"] = 64
    if "--ooc-shrink" in flags:
        kw.update(ooc_shrink=True, active_set_size=64)
    api, res = train(x, y, SVMConfig(c=1.0, epsilon=1e-3, gamma=0.2,
                                     engine="block", working_set_size=16,
                                     **kw), device="cpu")
    assert res.stats["ooc"]
    got, want = SVMModel.load(m), SVMModel.load(jm)
    np.testing.assert_array_equal(got.dual_coef, api.dual_coef)
    assert got.b == np.float32(api.b)
    assert abs(got.sv_x.shape[0] - want.sv_x.shape[0]) <= max(
        1, 0.02 * want.sv_x.shape[0])
    assert abs(got.b - want.b) <= 5e-3


@pytest.mark.parametrize("argv,match", [
    # The active-set engine without --ooc runs (match None): the model
    # is the API's with the same knobs, --reconcile-rounds included.
    (["--active-set-size", "64", "--reconcile-rounds", "4", "--engine",
      "block"], None),
    (["--ooc", "--engine", "xla"], "block-engine path"),
    (["--ooc-shrink", "on", "--engine", "block"], "set ooc=True"),
    (["--ooc", "--engine", "block", "--backend", "mesh", "--num-devices",
      "2"], "item 10b"),
])
def test_ooc_refusals(data, tmp_path, capsys, argv, match):
    """--ooc on the mesh names item 10b, and bad combinations say what
    SVMConfig says; --active-set-size without --ooc trains the active-set
    engine."""
    from dpsvm_tpu_torch import SVMConfig, train

    x, y, csv, _ = data
    m = str(tmp_path / "m.txt")
    rc = cli.main(["train", "-f", csv, "-m", m, "-q", "--device", "cpu",
                   "-c", "1", "-g", "0.2", "-e", "0.001",
                   "--working-set-size", "16", *argv])
    if match is None:
        assert rc == 0
        api, res = train(x, y, SVMConfig(
            c=1.0, gamma=0.2, epsilon=1e-3, engine="block",
            working_set_size=16, active_set_size=64, reconcile_rounds=4),
            device="cpu")
        assert res.stats["active_set_size"] == 64
        got = SVMModel.load(m)
        np.testing.assert_array_equal(got.dual_coef, api.dual_coef)
        return
    assert rc == 2
    assert match in capsys.readouterr().err


@pytest.mark.parametrize("argv,match", [
    (["--retry-faults", "0"], "item 11"),
    (["-t", "nu-svc", "-w1", "2"], "not applicable"),
    (["--format", "libsvm", "-t", "eps-svr"], "regression targets"),
    (["--kernel", "precomputed", "-t", "nu-svc"], "supports c-svc only"),
    (["--kernel", "precomputed", "-b", "1"], "not supported with --kernel"),
    (["--kernel", "precomputed", "--backend", "native"],
     "single or mesh backend"),
    (["-b", "1", "-t", "eps-svr"], "applies to classifiers only"),
    (["--kernel", "precomputed"], "square (n, n) Gram"),
    (["-v", "1"], "N >= 2 folds"),
    (["-v", "3", "-t", "one-class"], "not defined for one-class"),
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


def _refusal_texts(argv, tmp_path, capsys, path):
    """The stderr lines of both CLIs refusing `argv` on `path` (each must
    exit 2)."""
    texts = []
    for main, dev in ((cli.main, ["--device", "cpu"]), (jax_cli.main, [])):
        rc = main(["train", "-f", path, "-m", str(tmp_path / "m.txt"), "-q",
                   *argv, *dev])
        assert rc == 2
        texts.append(capsys.readouterr().err.strip())
    return texts


@pytest.mark.parametrize("argv", [
    ["--kernel", "precomputed", "-t", "nu-svc"],
    ["-b", "1", "-t", "eps-svr"],
    ["--kernel", "precomputed"],
    ["-v", "1"],
], ids=["pre-nusvc", "b-svr", "pre-nonsquare", "v1"])
def test_new_refusals_say_what_jax_says(data, tmp_path, capsys, argv):
    _, _, csv, _ = data
    port, jax = _refusal_texts(argv, tmp_path, capsys, csv)
    assert port.replace("dpsvm_tpu_torch", "dpsvm_tpu") == jax


def _csv(path, x, y):
    with open(path, "w") as fh:
        for xi, yi in zip(x, y):
            fh.write(f"{int(yi)}," + ",".join("%.9g" % v for v in xi) + "\n")
    return str(path)


@pytest.fixture
def multiclass_file(tmp_path):
    from dpsvm_tpu_torch.data.synth import make_mnist_multiclass

    x, y = make_mnist_multiclass(n=150, d=16, seed=4, n_classes=3)
    return x, y, _csv(tmp_path / "mc.csv", x, y)


@pytest.mark.parametrize("strategy", ["ovr", "ovo"])
@pytest.mark.parametrize("fleet", ["16", "1"], ids=["fleet", "sequential"])
def test_multiclass_train_and_test_match_jax(multiclass_file, tmp_path,
                                             strategy, fleet):
    """A 3-class file trains the OvR / OvO bundle (through the fleet, or
    sequentially with --fleet-size 1); each package's bundle predicts the
    same -o labels under the other's `test`, and the two packages'
    labels agree."""
    from dpsvm_tpu.models.multiclass import MulticlassSVM as JaxMC
    from dpsvm_tpu.models.multiclass import predict_multiclass as jax_pred
    from dpsvm_tpu_torch.models.multiclass import (MulticlassSVM,
                                                   predict_multiclass)

    x, y, path = multiclass_file
    flags = ["-g", "0.1", "--multiclass", strategy, "--fleet-size", fleet]
    pm, jm = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    _train(cli.main, path, pm, flags, ("--device", "cpu"))
    _train(jax_cli.main, path, jm, flags)
    po, jo = str(tmp_path / "p.out"), str(tmp_path / "j.out")
    assert cli.main(["test", "-f", path, "-m", jm, "-o", po, "--device",
                     "cpu"]) == 0
    assert jax_cli.main(["test", "-f", path, "-m", jm, "-o", jo]) == 0
    np.testing.assert_array_equal(np.loadtxt(po), np.loadtxt(jo))
    port_labels = predict_multiclass(MulticlassSVM.load(pm), x,
                                     device="cpu")
    np.testing.assert_array_equal(port_labels, jax_pred(JaxMC.load(pm), x))
    agree = np.mean(port_labels == jax_pred(JaxMC.load(jm), x))
    assert agree >= 0.98


def test_multiclass_refusals_match_jax(multiclass_file, tmp_path, capsys):
    _, _, path = multiclass_file
    for argv in (["-t", "nu-svc"], ["-w1", "2"], ["-b", "1"]):
        port, jax = _refusal_texts(argv, tmp_path, capsys, path)
        assert port == jax and "does not compose with" in port


def _cv_line(main, argv, capsys, dev=()):
    assert main(["train", *argv, "-q", *dev]) == 0
    out = capsys.readouterr().out
    return [ln for ln in out.splitlines() if ln.startswith("Cross")]


@pytest.mark.parametrize("kind", ["c-svc", "multiclass", "eps-svr"])
def test_cross_validation_matches_jax(data, multiclass_file, tmp_path,
                                      capsys, kind):
    """-v 4 prints LibSVM's lines and writes no model; the folds are the
    JAX CLI's, so the held-out scores agree within one row's worth (and
    the SVR MSE within 2%)."""
    x, y, csv, _ = data
    if kind == "multiclass":
        csv = multiclass_file[2]
        n = len(multiclass_file[1])
    elif kind == "eps-svr":
        z = np.sin(x[:, 0]) + 0.2 * x[:, 1]
        csv = _csv(tmp_path / "z.csv", x, np.round(z * 1000))
        n = len(z)
    else:
        n = len(y)
    m = str(tmp_path / "cv.txt")
    argv = ["-f", csv, "-m", m, "-v", "4", "-g", "0.2"]
    if kind == "eps-svr":
        argv += ["-t", "eps-svr", "-p", "10", "-c", "100"]
    port = _cv_line(cli.main, argv, capsys, ("--device", "cpu"))
    jax = _cv_line(jax_cli.main, argv, capsys)
    assert not os.path.exists(m)
    assert [ln.split("=")[0] for ln in port] == [
        ln.split("=")[0] for ln in jax]
    vals = [(float(a.split("=")[1].strip(" %")),
             float(b.split("=")[1].strip(" %"))) for a, b in zip(port, jax)]
    if kind == "eps-svr":
        assert abs(vals[0][0] - vals[0][1]) <= 0.02 * vals[0][1]
    else:
        assert abs(vals[0][0] - vals[0][1]) <= 100.0 / n + 1e-9


def test_probability_train_and_test_match_jax(data, tmp_path, capsys):
    """-b 1: the model carries the Platt pair (within 1e-3 of the JAX
    CLI's on the same file: the fold refits part as whole solves do);
    test -b 1 writes 'label p(+1)' lines whose probabilities lie in
    [0, 1] and rise with the decision, and each package's `test` reads
    the other's model to within 1e-5."""
    x, y, csv, _ = data
    pm, jm = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    _train(cli.main, csv, pm, ["-g", "0.2", "-b", "1"], ("--device", "cpu"))
    _train(jax_cli.main, csv, jm, ["-g", "0.2", "-b", "1"])
    port_m, jax_m = SVMModel.load(pm), JaxModel.load(jm)
    assert abs(port_m.prob_a - jax_m.prob_a) <= 1e-3
    assert abs(port_m.prob_b - jax_m.prob_b) <= 1e-3
    assert port_m.prob_a > 0
    po, jo = str(tmp_path / "p.out"), str(tmp_path / "j.out")
    assert cli.main(["test", "-f", csv, "-m", jm, "-b", "1", "-o", po,
                     "--device", "cpu"]) == 0
    assert jax_cli.main(["test", "-f", csv, "-m", jm, "-b", "1", "-o",
                         jo]) == 0
    assert open(po).readline() == open(jo).readline() == "label p(+1)\n"
    p_port, p_jax = np.loadtxt(po, skiprows=1), np.loadtxt(jo, skiprows=1)
    np.testing.assert_allclose(p_port, p_jax, atol=1e-5)
    dec = decision_function(SVMModel.load(jm), x, device="cpu")
    prob = p_port[np.argsort(dec, kind="stable"), 1]
    assert prob.min() >= 0 and prob.max() <= 1
    assert np.all(np.diff(prob) >= 0)
    assert cli.main(["test", "-f", csv, "-m", str(tmp_path / "p.npz"),
                     "-b", "1", "--precision", "float64", "--device",
                     "cpu"]) == 0
    capsys.readouterr()


def test_precomputed_train_and_test_match_jax(data, tmp_path):
    """--kernel precomputed: the training file's columns are the Gram;
    each package's .npz model predicts the other's `test` -o labels, and
    the two packages' models hold the same support set within 2%."""
    from dpsvm_tpu.models.precomputed import PrecomputedSVCModel as JaxPre
    from dpsvm_tpu_torch.models.precomputed import PrecomputedSVCModel

    x, y, _, _ = data
    x64 = x.astype(np.float64)
    sq = (x64 ** 2).sum(1)
    g = np.exp(-0.2 * np.maximum(sq[:, None] + sq[None] - 2 * x64 @ x64.T,
                                 0.0))
    path = _csv(tmp_path / "g.csv", g, y)
    pm, jm = str(tmp_path / "p"), str(tmp_path / "j")
    for main, m, dev in ((cli.main, pm, ["--device", "cpu"]),
                         (jax_cli.main, jm, [])):
        assert main(["train", "-f", path, "-m", m, "--kernel",
                     "precomputed", "-c", "1", "-e", "0.001", "-q",
                     "--engine", "block", "--working-set-size", "16",
                     *dev]) == 0
    port_m = PrecomputedSVCModel.load(pm + ".npz")
    jax_m = JaxPre.load(jm + ".npz")
    assert abs(port_m.n_sv - jax_m.n_sv) <= max(1, 0.02 * jax_m.n_sv)
    outs = []
    for main, m, dev in ((cli.main, jm, ["--device", "cpu"]),
                         (jax_cli.main, pm, [])):
        o = str(tmp_path / f"{len(outs)}.out")
        assert main(["test", "-f", path, "-m", m + ".npz", "-o", o,
                     *dev]) == 0
        outs.append(np.loadtxt(o))
    np.testing.assert_array_equal(outs[0], jax_m.predict(g))
    np.testing.assert_array_equal(outs[1], port_m.predict(g,
                                                          device="cpu"))


# ------------------------------------------------------------------ serve

def _serve_stdin(main, argv, text, monkeypatch, capsys):
    import io

    capsys.readouterr()
    monkeypatch.setattr("sys.stdin", io.StringIO(text))
    rc = main(["serve", *argv])
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_serve_registry_roundtrip_matches_jax(multiclass_file, tmp_path,
                                              monkeypatch, capsys):
    """`serve --registry` over stdin, with a mid-stream swap, a routed
    row, a bad row and a journal: the port's labels are JAX's line for
    line, and a restart on the journal alone serves the swapped
    version."""
    x, _, path = multiclass_file
    flags = ["-g", "0.1", "--multiclass", "ovo"]
    m1, m2 = str(tmp_path / "m1.npz"), str(tmp_path / "m2.npz")
    _train(cli.main, path, m1, flags, ("--device", "cpu"))
    _train(jax_cli.main, path, m2, flags + ["-c", "3"])
    rows = [",".join("%.9g" % v for v in r) for r in x[:6]]
    text = "\n".join(rows[:3] + ["", f"swap a={m2}", f"a|{rows[3]}",
                                 "1,2,oops", rows[4], ""]) + "\n"
    outs = {}
    for pkg, main, dev in (("port", cli.main, ["--device", "cpu"]),
                           ("jax", jax_cli.main, [])):
        jp = str(tmp_path / f"{pkg}.journal")
        rc, out, err = _serve_stdin(
            main, ["--registry", f"a={m1}", "--journal", jp, "--buckets",
                   "16,64", *dev], text, monkeypatch, capsys)
        assert rc == 0, err
        assert "swapped a -> v2" in err and "skipped bad query line" in err
        outs[pkg] = out
        rc, out, err = _serve_stdin(
            main, ["--journal", jp, "--buckets", "16,64", *dev],
            rows[5] + "\n", monkeypatch, capsys)
        assert rc == 0 and "rehydrated 1 model(s)" in err
        outs[pkg + " rehydrated"] = out
    assert outs["port"] == outs["jax"]
    assert len(outs["port"].splitlines()) == 5
    assert outs["port rehydrated"] == outs["jax rehydrated"]


def test_serve_v1_and_server_bench(multiclass_file, tmp_path, monkeypatch,
                                   capsys):
    import json

    x, _, path = multiclass_file
    m = str(tmp_path / "m.npz")
    _train(cli.main, path, m, ["-g", "0.1", "--multiclass", "ovr"],
           ("--device", "cpu"))
    text = "\n".join(",".join("%.9g" % v for v in r) for r in x[:5]) + "\n"
    labels = []
    for main, dev in ((cli.main, ["--device", "cpu"]), (jax_cli.main, [])):
        rc, out, _ = _serve_stdin(main, ["-m", m, "--buckets", "16", *dev],
                                  text, monkeypatch, capsys)
        assert rc == 0
        labels.append(out)
    assert labels[0] == labels[1] and len(labels[0].splitlines()) == 5
    recs = []
    for main, dev in ((cli.main, ["--device", "cpu"]), (jax_cli.main, [])):
        rc, out, _ = _serve_stdin(
            main, ["-m", m, "--server-bench", "--requests", "16",
                   "--buckets", "16,64", "-q", *dev], "", monkeypatch,
            capsys)
        assert rc == 0
        recs.append(json.loads(out.strip().splitlines()[-1]))
    assert set(recs[0]) == set(recs[1])
    assert recs[0]["rows"] == recs[1]["rows"]


@pytest.mark.parametrize("flag", [["--obs"], ["--obs-dir", "runs"]])
def test_serve_refuses_obs_naming_item_11(tmp_path, capsys, flag):
    rc = cli.main(["serve", "--registry", "a=/dev/null", "--device", "cpu",
                   *flag])
    assert rc == 2
    assert "ROADMAP queue A item 11" in capsys.readouterr().err


def test_serve_refusals_match_jax(tmp_path, capsys):
    for argv in (["--registry", "noequals"],
                 ["--listen", "nohostport", "--registry", "m=/dev/null"],
                 ["--registry", "a=x.npz", "-m", "x.npz"]):
        texts = []
        for main, dev in ((cli.main, ["--device", "cpu"]),
                          (jax_cli.main, [])):
            assert main(["serve", *argv, *dev]) == 2
            texts.append(capsys.readouterr().err.strip())
        assert texts[0] == texts[1], argv


def test_smoke_command_on_cpu_shards(capsys, monkeypatch):
    """`smoke` (the JAX package's bring-up check): the known 3x3 matvec
    on the device and a sum over the mesh, here --num-devices 4 logical
    shards of the CPU; the JAX package's command passes on its forced
    host devices. Without --device and without a card: a message, exit
    code 2."""
    import torch

    assert cli.main(["smoke", "--device", "cpu", "--num-devices", "4"]) == 0
    out = capsys.readouterr().out
    assert "platform=cpu devices=1" in out
    assert "cpu: matvec OK" in out
    assert "mesh(4) ['cpu', 'cpu', 'cpu', 'cpu'] psum OK" in out
    assert jax_cli.main(["smoke", "--num-devices", "4"]) == 0
    assert "psum OK" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert cli.main(["smoke"]) == 2
    assert "--device cpu" in capsys.readouterr().err
