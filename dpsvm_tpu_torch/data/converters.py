"""Data-prep converters (counterpart of dpsvm_tpu/data/converters.py):
LIBSVM parsing and conversion (the same file gives the same arrays), the
MNIST even/odd relabelling, and the module's CLI, which writes what the
JAX package's writes:

    python -m dpsvm_tpu_torch.data.converters adult in.libsvm out.csv
    python -m dpsvm_tpu_torch.data.converters mnist_even_odd in.csv out.csv
"""

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


def mnist_to_odd_even(x: np.ndarray, digits: np.ndarray,
                      scale: float = 255.0):
    """Digit labels -> +1 (even) / -1 (odd); pixels scaled by 1/scale,
    the relabelling of the reference's convert_mnist_to_odd_even.py."""
    y = np.where(np.asarray(digits) % 2 == 0, 1, -1).astype(np.int32)
    return (np.asarray(x, np.float32) / scale), y


def mnist_to_odd_even_csv(src: str, dst: str) -> tuple[int, int]:
    """CSV of ``digit,p1,...,p784`` -> the ``label,f1,...`` CSV of its
    even/odd relabelling. Returns (n, d)."""
    from dpsvm_tpu_torch.data.loader import load_csv, save_csv

    x, digits = load_csv(src)
    x, y = mnist_to_odd_even(x * 1.0, digits, scale=255.0)
    save_csv(dst, x, y)
    return x.shape


def main(argv=None) -> int:
    """The module's CLI (the reference's prep scripts
    scripts/convert_adult.py and scripts/convert_mnist_to_odd_even.py
    are directly runnable): `adult SRC DST [--num-features D]` or
    `mnist_even_odd SRC DST`."""
    import argparse

    ap = argparse.ArgumentParser(prog="dpsvm_tpu_torch.data.converters",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_a = sub.add_parser("adult",
                         help="sparse LIBSVM -> dense reference CSV")
    p_a.add_argument("src")
    p_a.add_argument("dst")
    p_a.add_argument("--num-features", type=int, default=None,
                     help="pad/clip feature width (default: max index "
                          "seen; the reference pins Adult to 123)")
    p_m = sub.add_parser("mnist_even_odd",
                         help="digit,pixels CSV -> +-1 even/odd CSV "
                              "with pixels scaled /255")
    p_m.add_argument("src")
    p_m.add_argument("dst")
    args = ap.parse_args(argv)
    if args.cmd == "adult":
        n, d = libsvm_to_csv(args.src, args.dst, args.num_features)
    else:
        n, d = mnist_to_odd_even_csv(args.src, args.dst)
    print(f"wrote {args.dst}: {n} rows x {d} features")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
