"""MNIST-even/odd-shaped rows made on the device from a seed.

A frozen copy, rewritten in torch, of the geometry of the port's
``data/synth.py make_mnist_like``: ``n_prototypes`` smooth class
prototypes (uniform pixels under a box filter of ``smooth`` taps), each
row one prototype plus Gaussian pixel noise, clipped to [0, 1]; the
label is +1 for an even prototype id and -1 for an odd one. The
prototypes come from ``prototype_seed`` (the configuration's: one data
distribution), the rows from the run's seed, so every seed draws a new
sample of the same distribution and the solver meets the same
difficulty. Frozen here so that a change to the port cannot move the
yardstick.
"""

from __future__ import annotations

import torch

from benchmark.lib.seeds import sub_seed

BLOCK = 131072


def prototypes(d: int, n_prototypes: int, smooth: int, prototype_seed: int,
               device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(prototype_seed, 0))
    raw = torch.rand((n_prototypes, 1, d), generator=g, device=device)
    box = torch.full((1, 1, smooth), 1.0 / smooth, device=device)
    return torch.nn.functional.conv1d(raw, box, padding=smooth // 2)[:, 0]


def make(n: int, params: dict, seed: int, device) -> tuple:
    """(x, y): n x d float32 rows in [0, 1] and int32 labels +-1 on
    `device`, made in blocks of BLOCK rows. `params` holds d,
    n_prototypes, noise, smooth and prototype_seed."""
    d = int(params["d"])
    protos = prototypes(d, int(params["n_prototypes"]), int(params["smooth"]),
                        int(params["prototype_seed"]), device)
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, 1))
    x = torch.empty((n, d), dtype=torch.float32, device=device)
    ids = torch.randint(0, protos.shape[0], (n,), generator=g, device=device)
    for lo in range(0, n, BLOCK):
        hi = min(n, lo + BLOCK)
        noise = torch.randn((hi - lo, d), generator=g, device=device)
        torch.addcmul(protos[ids[lo:hi]], noise, torch.tensor(
            float(params["noise"]), device=device), out=x[lo:hi])
    x.clamp_(0.0, 1.0)
    y = torch.where(ids % 2 == 0, 1, -1).to(torch.int32)
    return x, y


def make_host(n: int, params: dict, seed: int, device) -> tuple:
    """make() brought to the host once, as numpy arrays in pageable
    memory (a user's arrays)."""
    x, y = make(n, params, seed, device)
    out = x.cpu().numpy(), y.cpu().numpy()
    del x, y
    return out
