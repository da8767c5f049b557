"""The block round's fold after the kernel-row GEMM
(dpsvm_tpu_torch/ops/kernel_fold.py, csrc/kernel_fold.cu).

On the CPU, ``fold_kernel_rows`` and ``fold_block`` are bitwise
``coef @ kernel_rows(...)`` for every kernel kind (precomputed included),
the solve's ``stats["fold_kernel_rounds"]`` reads 0, the module imports
and folds without the CUDA toolkit, and the wrapper refuses what the
kernel does not take. The card's tests (marked ``cuda``) hold the kernel
against its plain version and a float64 contraction of the same kernel
values, check that a column slice folds bitwise as the same columns of
the whole fold, that the Kahan path is unchanged, and that the plain
block engine folds every round through the kernel. This file imports
neither jax nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_fold_rows_kernel.py
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dpsvm_tpu_torch import SVMConfig, solve
from dpsvm_tpu_torch.autotune import use_profile
from dpsvm_tpu_torch.data.synth import make_blobs_binary
from dpsvm_tpu_torch.ops import _build
from dpsvm_tpu_torch.ops import kernel_fold as kf
from dpsvm_tpu_torch.ops.kernels import (KernelParams, kernel_from_dots,
                                         kernel_rows, row_dots,
                                         squared_norms)
from dpsvm_tpu_torch.solver.block import fold_block
from dpsvm_tpu_torch.solver.smo import maybe_kahan

KINDS = {"rbf": KernelParams("rbf", 0.25),
         "linear": KernelParams("linear"),
         "poly": KernelParams("poly", 0.25, 3, 1.0),
         "sigmoid": KernelParams("sigmoid", 0.25, coef0=-0.5),
         "precomputed": KernelParams("precomputed")}
FEATURE_KINDS = [k for k in KINDS if k != "precomputed"]


def _bits(t):
    return t.view(torch.int32)


def _same_bits(a, b):
    return torch.equal(_bits(a), _bits(b))


def _round_inputs(kind, n=300, d=7, q=16, seed=0, dev="cpu",
                  dtype=torch.float32):
    """(x, x_sq, qx, qsq, coef, w): seeded rows (for precomputed, their
    rbf Gram as x), a working set w and coefficients with dead slots."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32) * 0.5,
                        device=dev)
    if kind == "precomputed":
        x = torch.exp(-0.25 * torch.cdist(x, x) ** 2)
    x = x.to(dtype)
    x_sq = squared_norms(x)
    w = torch.as_tensor(rng.choice(n, q, replace=False), device=dev)
    coef = torch.as_tensor(rng.normal(size=q).astype(np.float32), device=dev)
    coef[:: 5] = 0.0  # dead slots
    return x, x_sq, x[w], x_sq[w], coef, w


# ---- the CPU


@pytest.mark.parametrize("kind", list(KINDS))
def test_fold_kernel_rows_on_cpu_is_coef_at_kernel_rows(kind):
    x, x_sq, qx, qsq, coef, _ = _round_inputs(kind)
    kp = KINDS[kind]
    got = kf.fold_kernel_rows(x, x_sq, qx, qsq, coef, kp)
    assert _same_bits(got, coef @ kernel_rows(x, x_sq, qx, qsq, kp))
    if kind != "precomputed":
        dots = row_dots(x, qx)
        assert _same_bits(kf.fold_dots(dots, x_sq, qsq, coef, kp),
                          coef @ kernel_from_dots(dots, x_sq, qsq, kp))


@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("kind", list(KINDS))
def test_fold_block_on_cpu_is_the_plain_fold(kind, compensated):
    x, x_sq, qx, qsq, coef, w = _round_inputs(kind, seed=1)
    kp = KINDS[kind]
    n, q = x.shape[0], qx.shape[0]
    rng = np.random.default_rng(2)
    f = torch.as_tensor(rng.normal(size=n).astype(np.float32))
    f_err = (torch.as_tensor(rng.normal(size=n).astype(np.float32)) * 1e-7
             if compensated else None)
    alpha = torch.zeros(n)
    slot_ok = torch.ones(q, dtype=torch.bool)
    slot_ok[3] = False
    a_w = torch.full((q,), 0.5)
    a_got, f_got, e_got = fold_block(x, x_sq, qx, qsq, kp, f, f_err, coef,
                                     alpha, w, slot_ok, a_w)
    f_want, e_want = maybe_kahan(f, f_err,
                                 coef @ kernel_rows(x, x_sq, qx, qsq, kp))
    assert _same_bits(f_got, f_want)
    assert (e_got is None) == (not compensated)
    if compensated:
        assert _same_bits(e_got, e_want)
    assert a_got[w[3]] == 0.0 and bool((a_got[w[slot_ok]] == 0.5).all())


@pytest.mark.parametrize("kernel", ["rbf", "precomputed"])
def test_fold_kernel_rounds_reads_zero_on_the_cpu(kernel):
    x, y = make_blobs_binary(n=200, d=6, seed=4, sep=1.5)
    if kernel == "precomputed":
        x = np.exp(-0.2 * ((x[:, None] - x[None]) ** 2).sum(-1)).astype(
            np.float32)
    launches = kf.fold_dots.launches
    res = solve(x, y, SVMConfig(c=1.0, gamma=0.2, kernel=kernel,
                                engine="block", working_set_size=16),
                device="cpu")
    assert res.converged and res.stats["outer_rounds"] > 0
    assert res.stats["fold_kernel_rounds"] == 0
    assert kf.fold_dots.launches == launches


def test_module_imports_and_folds_without_nvcc(monkeypatch):
    # In a fresh interpreter with no nvcc on PATH, importing the module
    # (and the solver that calls it) builds nothing.
    env = {**os.environ, "PATH": ""}
    out = subprocess.run(
        [sys.executable, "-c",
         "import dpsvm_tpu_torch.solver.block\n"
         "from dpsvm_tpu_torch.ops import kernel_fold as kf\n"
         "print(kf._fn is None, kf.fold_dots.launches)"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "0"]
    # A CPU fold never reaches the build.

    def no_build(*a, **k):
        raise AssertionError("a CPU fold asked for the CUDA build")

    monkeypatch.setattr(_build, "load", no_build)
    x, x_sq, qx, qsq, coef, _ = _round_inputs("rbf")
    kf.fold_kernel_rows(x, x_sq, qx, qsq, coef, KINDS["rbf"])
    kf.fold_dots(row_dots(x, qx), x_sq, qsq, coef, KINDS["rbf"])


def _dots_case(q=8, n=40):
    rng = np.random.default_rng(5)
    mk = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32))
    return mk(q, n), mk(n), mk(q), mk(q)


FAULTS = {
    "dots float64": lambda d, xs, qs, c: (d.double(), xs, qs, c),
    "coef bfloat16": lambda d, xs, qs, c: (d, xs, qs, c.bfloat16()),
    "dots not contiguous": lambda d, xs, qs, c: (
        d.t().contiguous().t(), xs, qs, c),
    "x_sq strided": lambda d, xs, qs, c: (
        d, torch.stack([xs, xs], 1)[:, 0], qs, c),
    "x_sq short": lambda d, xs, qs, c: (d, xs[:-1], qs, c),
    "q_sq missing": lambda d, xs, qs, c: (d, xs, None, c),
    "dots 1-d": lambda d, xs, qs, c: (d[0], xs, qs, c),
    "meta device": lambda d, xs, qs, c: tuple(
        t.to("meta") for t in (d, xs, qs, c)),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_fold_dots_refuses_what_the_kernel_does_not_take(fault):
    args = FAULTS[fault](*_dots_case())
    with pytest.raises(ValueError):
        kf.fold_dots(*args, KINDS["rbf"])


def test_fold_dots_refuses_precomputed_and_other_devices():
    with pytest.raises(ValueError, match="feature kernels"):
        kf.fold_dots(*_dots_case(), KINDS["precomputed"])
    x, x_sq, qx, qsq, coef, _ = _round_inputs("rbf")
    meta = [t.to("meta") for t in (x, x_sq, qx, qsq, coef)]
    with pytest.raises(ValueError, match="unsupported device"):
        kf.fold_kernel_rows(*meta, KINDS["rbf"])


# ---- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU form")
    with use_profile(None):
        yield torch.device("cuda")


def _card_case(dev, q, n, kind, dtype, seed=0):
    """A real round's inputs on the card: seeded 16-wide rows (stored in
    `dtype`), q working-set rows among them, coefficients with dead slots,
    and the dots cuBLAS gives."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (0.3 * torch.randn((n, 16), generator=gen, device=dev)).to(dtype)
    x_sq = squared_norms(x)
    w = torch.randint(0, n, (q,), generator=gen, device=dev)
    coef = torch.randn((q,), generator=gen, device=dev)
    coef[::7] = 0.0
    return x, x_sq, x[w], x_sq[w].contiguous(), coef


def _bounds(dots, x_sq, qsq, coef, kp):
    """The float64 contraction of the plain version's kernel values and
    the kernel's bound against it: the 4-ulp term of ops/round.py
    gram_tolerance (exp / tanh / pow of two implementations) carried
    through the sum, plus q 2^-24 sum_k |coef_k K_kj| (one rounding a
    term of the float32 sum)."""
    kv = kernel_from_dots(dots, x_sq, qsq, kp).double()
    scale = coef.abs().double() @ kv.abs()
    q = coef.shape[0]
    return coef.double() @ kv, 4 * 2.0 ** -23 * scale, q * 2.0 ** -24 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("kind", FEATURE_KINDS)
@pytest.mark.parametrize("n", [1, 1000, 60007, 1 << 20])
@pytest.mark.parametrize("q", [2, 64, 256, 512])
def test_kernel_fold_matches_plain_and_float64(cuda, q, n, kind, dtype):
    kp = KINDS[kind]
    x, x_sq, qx, qsq, coef = _card_case(cuda, q, n, kind, dtype)
    dots = row_dots(x, qx)
    launches = kf.fold_dots.launches
    got = kf.fold_dots(dots, x_sq, qsq, coef, kp)
    torch.cuda.synchronize()
    assert kf.fold_dots.launches == launches + 1
    ref, ulps, sums = _bounds(dots, x_sq, qsq, coef, kp)
    assert bool(((got.double() - ref).abs() <= ulps + sums).all())
    plain = kf._fold_dots(dots, x_sq, qsq, coef, kp)
    assert bool(((got - plain).abs().double() <= ulps + 2 * sums).all())
    # The whole op: the same GEMM, then the same kernel.
    assert _same_bits(kf.fold_kernel_rows(x, x_sq, qx, qsq, coef, kp), got)
    # Every slot dead: an exact +0.0 everywhere.
    zero = kf.fold_dots(dots, x_sq, qsq, torch.zeros_like(coef), kp)
    assert _same_bits(zero, torch.zeros_like(zero))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", FEATURE_KINDS)
@pytest.mark.parametrize("lo,hi", [(0, 60007), (1, 60000), (3, 4099),
                                   (4096, 60004), (59999, 60007)])
def test_kernel_fold_column_slice_is_bitwise_the_whole(cuda, kind, lo, hi):
    """Column j's delta depends only on column j: a slice folded alone
    (through the 16-byte or the 4-byte path, whichever its length and
    alignment take) is bitwise those columns of the whole fold."""
    kp = KINDS[kind]
    x, x_sq, qx, qsq, coef = _card_case(cuda, 256, 60008, kind,
                                        torch.float32, seed=1)
    dots = row_dots(x, qx)
    whole = kf.fold_dots(dots, x_sq, qsq, coef, kp)
    part = kf.fold_dots(dots[:, lo:hi].contiguous(), x_sq[lo:hi], qsq, coef,
                        kp)
    assert _same_bits(part, whole[lo:hi])
    # A mesh shard's rows: the whole op on them is the same columns too.
    shard = kf.fold_kernel_rows(x[lo:hi], x_sq[lo:hi], qx, qsq, coef, kp)
    assert _same_bits(shard, kf.fold_dots(row_dots(x[lo:hi], qx),
                                          x_sq[lo:hi], qsq, coef, kp))


@pytest.mark.cuda
@pytest.mark.parametrize("compensated", [False, True])
def test_fold_block_on_card_folds_through_the_kernel(cuda, compensated):
    kp = KINDS["rbf"]
    n, q = 50000, 256
    x, x_sq, qx, qsq, coef = _card_case(cuda, q, n, "rbf", torch.float32, 2)
    w = torch.arange(q, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    f = torch.randn((n,), generator=gen, device=cuda)
    f_err = (1e-7 * torch.randn((n,), generator=gen, device=cuda)
             if compensated else None)
    slot_ok = torch.ones(q, dtype=torch.bool, device=cuda)
    launches = kf.fold_dots.launches
    _, f_got, e_got = fold_block(x, x_sq, qx, qsq, kp, f, f_err, coef,
                                 torch.zeros(n, device=cuda), w, slot_ok,
                                 torch.zeros(q, device=cuda))
    assert kf.fold_dots.launches == launches + 1
    delta = kf.fold_kernel_rows(x, x_sq, qx, qsq, coef, kp)
    f_want, e_want = maybe_kahan(f, f_err, delta)
    assert _same_bits(f_got, f_want)
    if compensated:
        assert _same_bits(e_got, e_want)
        ref, ulps, sums = _bounds(row_dots(x, qx), x_sq, qsq, coef, kp)
        total = f.double() - f_err.double() + ref
        got = f_got.double() - e_got.double()
        # Kahan's own rounding: a few ulps of the values it adds.
        step = 2.0 ** -22 * (f.double().abs() + ref.abs() + total.abs())
        assert bool(((got - total).abs() <= ulps + sums + step).all())


@pytest.mark.cuda
def test_kernel_fold_refuses_on_the_card(cuda):
    dots, x_sq, qsq, coef = (t.to(cuda) for t in _dots_case())
    kp = KINDS["rbf"]
    for args in ((dots.double(), x_sq, qsq, coef),
                 (dots, x_sq.cpu(), qsq, coef),
                 (dots.t().contiguous().t(), x_sq, qsq, coef),
                 (dots, x_sq, qsq, coef.half())):
        with pytest.raises(ValueError):
            kf.fold_dots(*args, kp)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["rbf", "linear", "precomputed"])
def test_fold_kernel_rounds_on_the_card(cuda, kernel):
    """The plain block engine folds every round through the kernel; a
    precomputed Gram keeps the plain fold."""
    x, y = make_blobs_binary(n=1200, d=24, seed=11, sep=1.0)
    if kernel == "precomputed":
        x = np.exp(-0.1 * ((x[:, None] - x[None]) ** 2).sum(-1)).astype(
            np.float32)
    cfg = SVMConfig(c=1.0, gamma=0.1, kernel=kernel, engine="block",
                    working_set_size=64)
    res = solve(x, y, cfg)
    rc = solve(x, y, cfg, device="cpu")
    assert res.converged and rc.converged
    rounds = res.stats["outer_rounds"]
    assert rounds > 0
    assert res.stats["fold_kernel_rounds"] == (
        0 if kernel == "precomputed" else rounds)
    assert rc.stats["fold_kernel_rounds"] == 0

    def obj(r):
        a, f = r.alpha.astype(np.float64), r.stats["f"].astype(np.float64)
        return float(a.sum() - 0.5 * np.sum(a * y * (f + y)))

    assert abs(obj(res) - obj(rc)) <= 1e-4 * abs(obj(rc))
