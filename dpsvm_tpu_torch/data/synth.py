"""Deterministic synthetic datasets (copies of the generators in
dpsvm_tpu/data/synth.py; the same seed gives bit-identical arrays).
Seeded NumPy only — no network, no files."""

from __future__ import annotations

import numpy as np


def make_blobs_binary(n: int, d: int, seed: int = 0,
                      sep: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """Two Gaussian blobs with +-1 labels; `sep` controls overlap."""
    rng = np.random.default_rng(seed)
    y = np.where(rng.random(n) < 0.5, 1, -1).astype(np.int32)
    centers = rng.normal(size=(2, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x += np.where(y[:, None] > 0, centers[0] * sep, centers[1] * sep)
    return x.astype(np.float32), y


def make_covtype_like(n: int, d: int = 54,
                      seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Covtype-shaped dense rows with a noisy first-feature decision
    rule (the JAX package's benchmark and stress data family)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) * 0.3).astype(np.float32)
    y = np.where(x[:, 0] + 0.2 * rng.standard_normal(n) > 0,
                 1, -1).astype(np.int32)
    return x, y


def make_mnist_like(n: int = 60_000, d: int = 784, seed: int = 7,
                    n_prototypes: int = 20, noise: float = 0.1,
                    label_flip: float = 0.0) -> tuple[np.ndarray, np.ndarray]:
    """An MNIST-even-odd-shaped stand-in: n x d in [0, 1], +-1 labels,
    from `n_prototypes` smooth class prototypes plus pixel noise.
    `label_flip` flips a seeded fraction of labels."""
    rng, x, proto_ids = _mnist_features(n, d, seed, n_prototypes, noise)
    y = np.where(proto_ids % 2 == 0, 1, -1).astype(np.int32)
    if label_flip > 0.0:
        flips = rng.random(n) < label_flip
        y = np.where(flips, -y, y).astype(np.int32)
    return x.astype(np.float32), y


def _mnist_features(n, d, seed, n_prototypes, noise):
    """The mnist-shaped feature geometry. Returns (rng, x, proto_ids); the
    rng is handed back so further draws stay in the same stream."""
    rng = np.random.default_rng(seed)
    protos = rng.random((n_prototypes, d)).astype(np.float32)
    k = 9
    kernel = np.ones(k, np.float32) / k
    for p in range(n_prototypes):
        protos[p] = np.convolve(protos[p], kernel, mode="same")
    proto_ids = rng.integers(0, n_prototypes, size=n)
    x = protos[proto_ids] + noise * rng.standard_normal((n, d)).astype(np.float32)
    np.clip(x, 0.0, 1.0, out=x)
    return rng, x.astype(np.float32), proto_ids


def make_mnist_multiclass(n: int = 60_000, d: int = 784, seed: int = 7,
                          n_prototypes: int = 20, noise: float = 0.1,
                          n_classes: int = 10) -> tuple[np.ndarray,
                                                        np.ndarray]:
    """make_mnist_like before the even/odd collapse: the same features,
    labelled by prototype id modulo `n_classes` (int32 class ids)."""
    _, x, proto_ids = _mnist_features(n, d, seed, n_prototypes, noise)
    return x, (proto_ids % n_classes).astype(np.int32)


def make_adult_like(n: int = 32_561, d: int = 123, seed: int = 13,
                    n_groups: int = 14, flip: float = 0.08,
                    imbalance: float = 0.24) -> tuple[np.ndarray,
                                                      np.ndarray]:
    """An Adult-a9a-shaped stand-in: n x d one-hot 0/1 features in
    `n_groups` groups, +-1 labels with an `imbalance` share of +1. Each
    class draws each group's active column from its own sharp
    categorical; a `flip` share of rows draw their whole feature vector
    from the other class's distributions (label noise)."""
    rng = np.random.default_rng(seed)
    y = np.where(rng.random(n) < imbalance, 1, -1).astype(np.int32)
    cls = (y > 0).astype(int)
    noisy = rng.random(n) < flip
    cls = np.where(noisy, 1 - cls, cls)
    edges = np.linspace(0, d, n_groups + 1).astype(int)
    x = np.zeros((n, d), np.float32)
    for g in range(n_groups):
        lo, hi = edges[g], edges[g + 1]
        width = hi - lo
        logits = rng.normal(size=(2, width)) * 4.0
        probs = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
        cols = np.empty(n, np.int64)
        for c in (0, 1):
            m = cls == c
            cols[m] = rng.choice(width, size=int(m.sum()), p=probs[c])
        x[np.arange(n), lo + cols] = 1.0
    return x, y
