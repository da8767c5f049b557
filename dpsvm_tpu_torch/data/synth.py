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
