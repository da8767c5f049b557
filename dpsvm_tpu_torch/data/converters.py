"""LIBSVM-format conversion (counterpart of dpsvm_tpu/data/converters.py
parse_libsvm and libsvm_to_csv; the same file gives the same arrays)."""

from __future__ import annotations

import numpy as np


def _row_features(path: str, lineno: int, toks: list):
    """(idx int64, val float64) of one row's ``idx:val`` tokens: the JAX
    package's token loop, its errors and its last-wins rule for a
    repeated index."""
    feats = {}
    for tok in toks:
        idx_s, val_s = tok.split(":")
        idx = int(idx_s)
        if idx < 1:
            # idx 0 would write x[i, -1] below and scramble the last
            # column.
            raise ValueError(
                f"{path}:{lineno}: feature index {idx} — LIBSVM format is "
                "1-based; re-index 0-based files before loading")
        feats[idx] = float(val_s)
    return (np.array(list(feats), dtype=np.int64),
            np.array(list(feats.values()), dtype=np.float64))


def parse_libsvm(path: str, num_features: int | None = None,
                 num_rows: int | None = None):
    """Parse sparse LIBSVM lines ``label idx:val idx:val ...`` (1-based
    indices) into dense arrays: x float32 (n, d), y int32 class labels.
    d is `num_features` (wider indices are dropped) or the largest index
    seen. Reading stops after `num_rows` examples when given."""
    rows: list = []
    labels: list[int] = []
    max_idx = 0
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            if num_rows is not None and len(rows) >= num_rows:
                break
            parts = line.split()
            if not parts:
                continue
            try:
                lab_val = float(parts[0])
            except ValueError:
                raise ValueError(
                    f"{path}:{lineno}: label token {parts[0]!r} is not "
                    "numeric (comment/header lines are not supported)"
                ) from None
            # is_integer() is False for inf/nan; the bound keeps the
            # int32 conversion exact.
            if not (lab_val.is_integer() and abs(lab_val) < 2 ** 31):
                raise ValueError(
                    f"{path}:{lineno}: label {parts[0]!r} is not an int32 "
                    "class label (LIBSVM-format regression targets are not "
                    "supported; convert to CSV)")
            labels.append(int(lab_val))
            feats = _row_features(path, lineno, parts[1:])
            if len(feats[0]):
                max_idx = max(max_idx, int(feats[0].max()))
            rows.append(feats)
    d = num_features or max_idx
    x = np.zeros((len(rows), d), np.float32)
    for i, (idx, vals) in enumerate(rows):
        keep = idx <= d
        x[i, idx[keep] - 1] = vals[keep]
    return x, np.asarray(labels, np.int32)


def libsvm_to_csv(src: str, dst: str,
                  num_features: int | None = None) -> tuple[int, int]:
    """LIBSVM sparse file -> dense ``label,f1,...,fd`` CSV. Returns (n, d)."""
    from dpsvm_tpu_torch.data.loader import save_csv

    x, y = parse_libsvm(src, num_features)
    save_csv(dst, x, y)
    return x.shape
