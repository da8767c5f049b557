"""ctypes bridges to the port's host-side native components (counterpart
of dpsvm_tpu/utils/native.py).

``native/fastcsv.cpp`` (the CSV parser) and ``native/seqsmo.cpp`` (the
sequential SMO trainer and predictor of backend="native") live in this
package and are compiled with g++ at first use into
``build/torch_native/<stem>.so`` at the root of the checkout (a directory
.gitignore lists). They are host code, not device kernels. Nothing is
built at import time. A failed build returns None and records the
compiler's diagnostic in ``build_errors``; the callers say what they do
then (the CSV loader warns and parses with NumPy; backend="native"
raises).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "native")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_native")

# The JAX package's flags, so both packages' host engines compute alike.
# Portable baseline on purpose: -march=native would pin the .so to the
# build host's ISA.
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_cache: dict = {}  # stem -> wrapper or None (failed)
build_errors: dict = {}


def build_so(stem: str) -> str | None:
    """Compile native/<stem>.cpp into build/torch_native/<stem>.so,
    rebuilding when the source is newer or the flags changed (a sidecar
    <stem>.so.flags holds them). Returns the path, or None with the
    diagnostic in build_errors[stem]."""
    src = os.path.join(SRC_DIR, f"{stem}.cpp")
    out = os.path.join(BUILD_DIR, f"{stem}.so")
    tag = out + ".flags"
    flags = " ".join(CXX_FLAGS)
    fresh = (os.path.exists(out)
             and os.path.getmtime(out) >= os.path.getmtime(src))
    if fresh:
        try:
            with open(tag) as fh:
                fresh = fh.read().strip() == flags
        except OSError:
            fresh = False
    if fresh:
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Build to a private name, then rename: a concurrent process never
    # loads a half-written library.
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, src, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, timeout=120,
                              text=True)
    except (subprocess.SubprocessError, OSError) as e:
        build_errors[stem] = f"{' '.join(cmd)}: {e}"
        return None
    if proc.returncode != 0:
        build_errors[stem] = (f"{' '.join(cmd)} exited {proc.returncode}:\n"
                              f"{proc.stderr}")
        return None
    os.replace(tmp, out)
    with open(tag, "w") as fh:
        fh.write(flags)
    build_errors.pop(stem, None)
    return out


class FastCsv:
    """Typed wrapper over the fastcsv C ABI."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.fastcsv_shape.restype = ctypes.c_int
        lib.fastcsv_shape.argtypes = [ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_long),
                                      ctypes.POINTER(ctypes.c_long)]
        lib.fastcsv_parse.restype = ctypes.c_long
        lib.fastcsv_parse.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                      ctypes.c_long,
                                      ctypes.POINTER(ctypes.c_float),
                                      ctypes.POINTER(ctypes.c_int)]

    def shape(self, path: str) -> tuple[int, int]:
        """(data lines, comma-separated fields of the first line)."""
        rows = ctypes.c_long()
        fields = ctypes.c_long()
        rc = self._lib.fastcsv_shape(path.encode(), ctypes.byref(rows),
                                     ctypes.byref(fields))
        if rc != 0:
            raise IOError(f"fastcsv_shape({path}) failed with code {rc}")
        return rows.value, fields.value

    def parse(self, path: str, num_rows: int | None = None):
        """(x (n, d) float32, y (n,) int32), at most num_rows rows."""
        rows, fields = self.shape(path)
        if num_rows is not None:
            rows = min(rows, num_rows)
        x = np.empty((rows, fields - 1), np.float32)
        y = np.empty((rows,), np.int32)
        got = self._lib.fastcsv_parse(
            path.encode(), rows, fields,
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            y.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        if got < 0:
            raise IOError(f"fastcsv_parse({path}) failed with code {got}")
        return x[:got], y[:got]


_KERNEL_KINDS = {"linear": 0, "rbf": 1, "poly": 2, "sigmoid": 3}


class SeqSMO:
    """Typed wrapper over the seqsmo C ABI: the sequential trainer and
    the decision function."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.seqsmo_train.restype = ctypes.c_long
        lib.seqsmo_train.argtypes = [
            f32p, ctypes.POINTER(ctypes.c_int), ctypes.c_long, ctypes.c_long,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_long, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, f32p, f32p, f32p]
        lib.seqsmo_decision.restype = ctypes.c_long
        lib.seqsmo_decision.argtypes = [
            f32p, f32p, ctypes.c_long, ctypes.c_long, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            f32p, ctypes.c_long, f32p]

    def train(self, x, y, *, c: float, gamma: float, epsilon: float,
              tau: float, max_iter: int, kernel: str = "rbf",
              degree: int = 3, coef0: float = 0.0,
              c_neg: float | None = None):
        """Returns (alpha, f, b, b_hi, b_lo, iterations, converged)."""
        x = np.ascontiguousarray(x, np.float32)
        y = np.ascontiguousarray(y, np.int32)
        if x.ndim != 2:
            raise ValueError(f"x must be 2-D (n, d), got shape {x.shape}")
        n, d = x.shape
        if y.shape != (n,):
            raise ValueError(f"y must have shape ({n},), got {y.shape}")
        alpha = np.empty((n,), np.float32)
        f = np.empty((n,), np.float32)
        scalars = np.empty((4,), np.float32)
        f32p = ctypes.POINTER(ctypes.c_float)
        it = self._lib.seqsmo_train(
            x.ctypes.data_as(f32p),
            y.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n, d,
            ctypes.c_float(c), ctypes.c_float(c if c_neg is None else c_neg),
            ctypes.c_float(gamma), ctypes.c_float(epsilon),
            ctypes.c_float(tau), max_iter, _KERNEL_KINDS[kernel], degree,
            ctypes.c_float(coef0), alpha.ctypes.data_as(f32p),
            f.ctypes.data_as(f32p), scalars.ctypes.data_as(f32p))
        if it < 0:
            raise ValueError(f"seqsmo_train failed with code {it}")
        return (alpha, f, float(scalars[0]), float(scalars[1]),
                float(scalars[2]), int(it), bool(scalars[3] > 0))

    def decision(self, sv_x, coef, b: float, q, *, gamma: float,
                 kernel: str = "rbf", degree: int = 3,
                 coef0: float = 0.0) -> np.ndarray:
        """f(q) = sum_j coef_j K(sv_j, q) - b, float32."""
        sv_x = np.ascontiguousarray(sv_x, np.float32)
        coef = np.ascontiguousarray(coef, np.float32)
        q = np.ascontiguousarray(q, np.float32)
        if sv_x.ndim != 2 or q.ndim != 2:
            raise ValueError(
                f"sv_x and q must be 2-D, got {sv_x.shape} and {q.shape}")
        n_sv, d = sv_x.shape
        if q.shape[1] != d:
            raise ValueError(
                f"q feature dim {q.shape[1]} != support-vector dim {d}")
        if coef.shape != (n_sv,):
            raise ValueError(
                f"coef must have shape ({n_sv},), got {coef.shape}")
        out = np.empty((q.shape[0],), np.float32)
        f32p = ctypes.POINTER(ctypes.c_float)
        rc = self._lib.seqsmo_decision(
            sv_x.ctypes.data_as(f32p), coef.ctypes.data_as(f32p), n_sv, d,
            ctypes.c_float(gamma), _KERNEL_KINDS[kernel], degree,
            ctypes.c_float(coef0), ctypes.c_float(b),
            q.ctypes.data_as(f32p), q.shape[0], out.ctypes.data_as(f32p))
        if rc < 0:
            raise ValueError(f"seqsmo_decision failed with code {rc}")
        return out


def _get(stem: str, wrapper):
    with _lock:
        if stem not in _cache:
            so = build_so(stem)
            obj = None
            if so is not None:
                try:
                    obj = wrapper(ctypes.CDLL(so))
                except (OSError, AttributeError) as e:
                    build_errors[stem] = f"loading {so}: {e}"
            _cache[stem] = obj
        return _cache[stem]


def get_fastcsv() -> FastCsv | None:
    """The native CSV parser, built at first use; None if it cannot be
    built or loaded."""
    return _get("fastcsv", FastCsv)


def get_seqsmo() -> SeqSMO | None:
    """The native sequential SMO engine, built at first use; None if it
    cannot be built or loaded."""
    return _get("seqsmo", SeqSMO)
