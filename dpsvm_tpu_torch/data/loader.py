"""Data IO in the reference's CSV format ``label,f1,...,fd`` and the
sparse LIBSVM format (counterpart of dpsvm_tpu/data/loader.py).

CSV is parsed by the native parser (native/fastcsv.cpp through
utils/native.py); where it cannot be built the NumPy parser reads the
file, with a warning. Both give the same arrays.
"""

from __future__ import annotations

import warnings

import numpy as np

from dpsvm_tpu_torch.utils import native


def sniff_format(path: str, max_lines: int = 32) -> str:
    """"csv" or "libsvm" from the leading non-empty lines: LIBSVM rows
    carry ``idx:val`` tokens, CSV rows commas. A LIBSVM row with no
    nonzero feature is a bare label, so several lines are examined; a
    file of label-only rows reads as csv."""
    seen = 0
    with open(path) as fh:
        for line in fh:
            if not line.strip():
                continue
            if ":" in line:
                return "libsvm"
            if "," in line:
                return "csv"
            seen += 1
            if seen >= max_lines:
                break
    return "csv"


def load_data(path: str, num_rows: int | None = None,
              num_features: int | None = None, float_labels: bool = False,
              fmt: str = "auto") -> tuple[np.ndarray, np.ndarray]:
    """Load CSV or LIBSVM -> (x (n, d) float32, y (n,)). fmt: "auto"
    (sniff_format), "csv" or "libsvm"."""
    if fmt == "auto":
        fmt = sniff_format(path)
    if fmt == "csv":
        return load_csv(path, num_rows, num_features, float_labels)
    if fmt != "libsvm":
        raise ValueError(f"unknown data format {fmt!r} (csv | libsvm | auto)")
    if float_labels:
        raise ValueError(
            "LIBSVM-format regression targets are not supported; convert "
            "to CSV first (data/converters.py libsvm_to_csv converts any "
            "integer-labelled file; non-integer regression targets need "
            "an external conversion)")
    from dpsvm_tpu_torch.data.converters import parse_libsvm

    x, y = parse_libsvm(path, num_features, num_rows=num_rows)
    if num_rows is not None and x.shape[0] < num_rows:
        raise ValueError(
            f"{path}: file has {x.shape[0]} rows, expected {num_rows}")
    return np.ascontiguousarray(x, np.float32), y


def load_csv(path: str, num_rows: int | None = None,
             num_features: int | None = None,
             float_labels: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Load ``label,f1,...,fd`` CSV -> (x (n, d) float32, y (n,)).

    Labels are int32 (the +-1 classification convention) unless
    `float_labels` is set: regression targets (SVR) keep the float32
    value, and take the NumPy parser (the native one returns int32
    labels). num_rows / num_features, when given, must match or bound the
    file contents; when omitted they are inferred."""
    parser = None if float_labels else native.get_fastcsv()
    if parser is not None:
        x, y = parser.parse(path, num_rows)
    else:
        if not float_labels:
            warnings.warn(
                "the native CSV parser could not be built "
                f"({native.build_errors.get('fastcsv', 'unknown error')}); "
                "parsing with NumPy, which is much slower", stacklevel=2)
        x, y = _load_csv_numpy(path, num_rows)
    if num_features is not None:
        if x.shape[1] < num_features:
            raise ValueError(
                f"{path}: file has {x.shape[1]} features, expected {num_features}")
        x = x[:, :num_features]
    if num_rows is not None and x.shape[0] < num_rows:
        raise ValueError(f"{path}: file has {x.shape[0]} rows, expected {num_rows}")
    return (np.ascontiguousarray(x, np.float32),
            y.astype(np.float32 if float_labels else np.int32))


def _load_csv_numpy(path: str, num_rows: int | None):
    data = np.loadtxt(path, delimiter=",", dtype=np.float32,
                      max_rows=num_rows, ndmin=2)
    if data.size == 0:
        raise ValueError(f"{path}: empty data file")
    return data[:, 1:], data[:, 0]


def save_csv(path: str, x: np.ndarray, y: np.ndarray) -> None:
    """Write the same ``label,f1,...,fd`` format."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y)
    with open(path, "w") as fh:
        for i in range(x.shape[0]):
            fh.write(f"{int(y[i])}," + ",".join(repr(float(v)) for v in x[i]) + "\n")
