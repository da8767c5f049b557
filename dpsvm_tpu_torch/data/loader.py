"""CSV data IO in the reference format ``label,f1,...,fd`` per line
(counterpart of the NumPy path of dpsvm_tpu/data/loader.py)."""

from __future__ import annotations

import numpy as np


def load_csv(path: str, num_rows: int | None = None,
             num_features: int | None = None,
             float_labels: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Load ``label,f1,...,fd`` CSV -> (x (n, d) float32, y (n,)).

    Labels are int32 (the +-1 classification convention) unless
    `float_labels` is set: regression targets (SVR) keep the float32
    value. num_rows / num_features, when given, must match or bound the
    file contents; when omitted they are inferred."""
    data = np.loadtxt(path, delimiter=",", dtype=np.float32,
                      max_rows=num_rows, ndmin=2)
    if data.size == 0:
        raise ValueError(f"{path}: empty data file")
    y = data[:, 0]
    x = data[:, 1:]
    if num_features is not None:
        if x.shape[1] < num_features:
            raise ValueError(
                f"{path}: file has {x.shape[1]} features, expected {num_features}")
        x = x[:, :num_features]
    if num_rows is not None and x.shape[0] < num_rows:
        raise ValueError(f"{path}: file has {x.shape[0]} rows, expected {num_rows}")
    return (np.ascontiguousarray(x, np.float32),
            y.astype(np.float32 if float_labels else np.int32))


def save_csv(path: str, x: np.ndarray, y: np.ndarray) -> None:
    """Write the same ``label,f1,...,fd`` format."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y)
    with open(path, "w") as fh:
        for i in range(x.shape[0]):
            fh.write(f"{int(y[i])}," + ",".join(repr(float(v)) for v in x[i]) + "\n")
