"""The port's data surface against the JAX package's: sniff_format,
load_data, parse_libsvm / libsvm_to_csv, the native CSV parser (built by
the port into build/torch_native/) against the NumPy path, and the
synthetic generators. Everything here is host NumPy, so it is held bit
for bit. Mirrors tests/test_data_io.py and tests/test_native_seq.py's
loader cases."""

import os

import numpy as np
import pytest

from dpsvm_tpu.data import converters as jconv
from dpsvm_tpu.data import loader as jload
from dpsvm_tpu.data import synth as jsynth
from dpsvm_tpu_torch.data import converters as tconv
from dpsvm_tpu_torch.data import loader as tload
from dpsvm_tpu_torch.data import synth as tsynth
from dpsvm_tpu_torch.utils import native


def _same(a, b):
    for u, v in zip(a, b):
        assert u.dtype == v.dtype and u.shape == v.shape
        np.testing.assert_array_equal(u, v)


def _rows(seed=0, n=40, d=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[rng.random((n, d)) < 0.5] = 0.0
    y = np.where(rng.random(n) < 0.5, 1, -1).astype(np.int32)
    return x, y


def _write_libsvm(path, x, y, extra=""):
    with open(path, "w") as fh:
        for xi, yi in zip(x, y):
            toks = [f"{j + 1}:{v!r}" for j, v in enumerate(xi.tolist())
                    if v != 0.0]
            fh.write(" ".join([str(int(yi))] + toks) + "\n")
        fh.write(extra)


def _write_csv(path, x, y, fmt="%.9g"):
    with open(path, "w") as fh:
        for xi, yi in zip(x, y):
            fh.write(f"{int(yi)}," + ",".join(fmt % v for v in xi) + "\n")


@pytest.fixture
def files(tmp_path):
    x, y = _rows()
    csv, lsv = str(tmp_path / "d.csv"), str(tmp_path / "d.libsvm")
    _write_csv(csv, x, y)
    _write_libsvm(lsv, x, y, extra="\n-1\n")  # a blank line, a bare label
    bare = str(tmp_path / "bare.txt")
    with open(bare, "w") as fh:
        fh.write("1\n-1\n")
    return x, y, csv, lsv, bare


def test_sniff_format_matches_jax(files):
    *_, csv, lsv, bare = files
    for path, want in ((csv, "csv"), (lsv, "libsvm"), (bare, "csv")):
        assert tload.sniff_format(path) == jload.sniff_format(path) == want


@pytest.mark.parametrize("kw", [dict(), dict(num_features=4),
                                dict(num_features=12), dict(num_rows=9)])
def test_parse_libsvm_bitwise(files, kw):
    _, _, _, lsv, _ = files
    _same(tconv.parse_libsvm(lsv, **kw), jconv.parse_libsvm(lsv, **kw))


def test_parse_libsvm_quirks_bitwise(tmp_path):
    """Rows the one-pass reader hands to the token-by-token one: a
    repeated index (the last wins), signed or padded indices, underscores
    and odd value spellings."""
    p = str(tmp_path / "q.libsvm")
    with open(p, "w") as fh:
        fh.write("1 3:1 3:2 1:0.5\n-1 +2:5 007:1e-3\n1 4:1_0 2:-inf\n"
                 "-1 1:nan 9:.5\n1\n")
    for kw in (dict(), dict(num_features=5)):
        _same(tconv.parse_libsvm(p, **kw), jconv.parse_libsvm(p, **kw))


@pytest.mark.parametrize("bad", ["x 1:2\n", "1.5 1:2\n", "1 0:2\n",
                                 "inf 1:1\n", "1 1:2:3\n", "1 a:2\n",
                                 "1 1.0:2\n", "1 2:x\n"])
def test_parse_libsvm_refusals_match_jax(tmp_path, bad):
    p = str(tmp_path / "bad.libsvm")
    with open(p, "w") as fh:
        fh.write(bad)
    with pytest.raises(ValueError) as je:
        jconv.parse_libsvm(p)
    with pytest.raises(ValueError) as te:
        tconv.parse_libsvm(p)
    assert str(te.value) == str(je.value)
    assert str(te.value)


@pytest.mark.parametrize("fmt", ["auto", "csv", "libsvm"])
@pytest.mark.parametrize("which", ["csv", "libsvm"])
def test_load_data_bitwise(files, fmt, which):
    _, _, csv, lsv, _ = files
    path = csv if which == "csv" else lsv
    if fmt not in ("auto", which):
        # The wrong parser refuses the file (the native CSV parser with
        # an OSError), in both packages alike.
        with pytest.raises((ValueError, OSError)) as je:
            jload.load_data(path, fmt=fmt)
        with pytest.raises((ValueError, OSError)) as te:
            tload.load_data(path, fmt=fmt)
        assert type(te.value) is type(je.value)
        return
    _same(tload.load_data(path, fmt=fmt), jload.load_data(path, fmt=fmt))
    _same(tload.load_data(path, 10, 5, fmt=fmt),
          jload.load_data(path, 10, 5, fmt=fmt))


def test_load_data_libsvm_and_csv_agree(files):
    """The same rows as CSV (%.9g round-trips float32) and as LIBSVM load
    to the same arrays (the bare-label row aside)."""
    x, y, csv, lsv, _ = files
    xc, yc = tload.load_data(csv)
    xl, yl = tload.load_data(lsv, num_rows=len(y))
    _same((xc, yc), (x, y))
    _same((xl, yl), (x, y))


def test_load_data_refusals_match_jax(files):
    _, _, csv, lsv, _ = files
    for fn in (jload.load_data, tload.load_data):
        with pytest.raises(ValueError, match="regression targets"):
            fn(lsv, float_labels=True)
        with pytest.raises(ValueError, match="unknown data format"):
            fn(csv, fmt="arff")
        with pytest.raises(ValueError, match="expected 999"):
            fn(csv, num_rows=999)


def test_native_parser_is_built_into_build_dir(files):
    _, _, csv, _, _ = files
    parser = native.get_fastcsv()
    assert parser is not None, native.build_errors
    so = os.path.join(native.BUILD_DIR, "fastcsv.so")
    assert os.path.exists(so)
    assert os.path.join("build", "torch_native") in native.BUILD_DIR
    assert native.SRC_DIR.endswith(os.path.join("dpsvm_tpu_torch",
                                                "native"))
    assert parser.shape(csv) == (40, 8)


@pytest.mark.parametrize("fmt", ["%.9g", "%r", "%.3f"])
@pytest.mark.parametrize("float_labels", [False, True])
def test_native_csv_parser_bitwise_numpy_and_jax(tmp_path, fmt,
                                                 float_labels):
    x, y = _rows(seed=3, n=57, d=11)
    p = str(tmp_path / "n.csv")
    if fmt == "%r":
        tload.save_csv(p, x, y)
    else:
        _write_csv(p, x, y, fmt)
    xn, yn = native.get_fastcsv().parse(p)
    xp, yp = tload._load_csv_numpy(p, None)
    np.testing.assert_array_equal(xn, xp)
    np.testing.assert_array_equal(yn, yp.astype(np.int32))
    _same(tload.load_csv(p, float_labels=float_labels),
          jload.load_csv(p, float_labels=float_labels))
    _same(tload.load_csv(p, 20, 6), jload.load_csv(p, 20, 6))


def test_numpy_fallback_warns_and_agrees(files, monkeypatch):
    _, _, csv, _, _ = files
    want = tload.load_csv(csv)
    monkeypatch.setattr(native, "get_fastcsv", lambda: None)
    with pytest.warns(UserWarning, match="native CSV parser"):
        got = tload.load_csv(csv)
    _same(got, want)


def test_libsvm_to_csv_matches_jax(files, tmp_path):
    _, _, _, lsv, _ = files
    a, b = str(tmp_path / "t.csv"), str(tmp_path / "j.csv")
    assert tconv.libsvm_to_csv(lsv, a, 9) == jconv.libsvm_to_csv(lsv, b, 9)
    assert open(a).read() == open(b).read()


@pytest.mark.parametrize("name,kw", [
    ("make_covtype_like", dict(n=700)),
    ("make_covtype_like", dict(n=300, d=20, seed=5)),
    ("make_mnist_multiclass", dict(n=400, d=64)),
    ("make_mnist_multiclass", dict(n=200, d=30, seed=2, n_classes=3)),
    ("make_adult_like", dict(n=500)),
    ("make_adult_like", dict(n=300, d=40, seed=1, n_groups=5)),
    ("make_mnist_like", dict(n=300, d=50, label_flip=0.1)),
    ("make_blobs_binary", dict(n=200, d=9, seed=4, sep=0.7)),
])
def test_generators_bitwise(name, kw):
    _same(getattr(tsynth, name)(**kw), getattr(jsynth, name)(**kw))
