"""The data mesh (counterpart of dpsvm_tpu/parallel/mesh.py).

The JAX package is a single controller over many devices: one program,
compiled once over a ``jax.sharding.Mesh``, with the collectives
inserted by XLA. The port is a single controller too: ONE Python process
drives P shards, a row-sharded array is a list of P tensors (shard r on
``mesh.devices[r]``), and a replicated value is one tensor per distinct
device. No process group: nothing here needs one.

A device may appear more than once. ``Mesh([torch.device("cuda:0")] * 4)``
is four LOGICAL shards of one card, each with its own row slice, state
and rank id, the counterpart of the JAX package's forced host devices.
``make_data_mesh`` never repeats a device by itself; ``Mesh.describe()``
lists the devices, so a logical mesh is not mistaken for a multi-card
one.

``initialize_multihost`` is not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"


def _with_index(dev: torch.device) -> torch.device:
    """"cuda" names the current card: give it its index, so that it and
    "cuda:0" are one device of the mesh, as they are one card."""
    if dev.type == "cuda" and dev.index is None:
        index = torch.cuda.current_device() if torch.cuda.is_available() else 0
        return torch.device("cuda", index)
    return dev


class Mesh:
    """An ordered list of P devices, one per row shard (rank = position).

    ``groups`` lists each distinct device once, in order of first
    appearance, with the ranks that live on it: replicated values are
    computed and held once per group. The collectives take one tensor
    per rank and return one result per group, on the group's device."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(_with_index(torch.device(d)) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        by_dev: dict = {}
        for rank, dev in enumerate(self.devices):
            by_dev.setdefault(dev, []).append(rank)
        self.groups = tuple((dev, tuple(ranks))
                            for dev, ranks in by_dev.items())
        #: rank -> index of its group
        self.group_of = tuple(
            next(g for g, (_, ranks) in enumerate(self.groups) if r in ranks)
            for r in range(self.size))

    @property
    def size(self) -> int:
        return len(self.devices)

    def describe(self) -> list:
        """The devices by rank, as strings (SolveResult.stats
        ["mesh_devices"])."""
        return [str(d) for d in self.devices]

    def _on(self, parts, dev):
        # Shards of one device are used where they lie; a shard of another
        # card is copied over (a plain peer copy).
        return [p if p.device == dev else p.to(dev) for p in parts]

    def all_gather(self, parts) -> list:
        """Per group, the stack (P, ...) of the per-rank tensors in rank
        order: the layout of lax.all_gather's leading axis."""
        return [torch.stack(self._on(parts, dev)) for dev, _ in self.groups]

    def psum(self, parts) -> list:
        """Per group, the sum of the per-rank tensors, added in rank
        order."""
        out = []
        for dev, _ in self.groups:
            local = self._on(parts, dev)
            acc = local[0]
            for p in local[1:]:
                acc = acc + p
            out.append(acc)
        return out

    def pmax(self, parts) -> list:
        """Per group, the elementwise maximum of the per-rank tensors."""
        return [g.amax(dim=0) for g in self.all_gather(parts)]

    def synchronize(self) -> None:
        """Wait for the queued work of every CUDA device of the mesh."""
        for dev, _ in self.groups:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)


def make_data_mesh(num_devices: Optional[int] = None,
                   devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the visible CUDA cards (or over `devices`), one
    shard per card, cut to the first `num_devices`. Raises when fewer
    cards are visible than asked for; a card is repeated only when the
    caller lists it so (``Mesh([...])``)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError(
                "dpsvm_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run the plain PyTorch "
                "path on the CPU")
    devices = list(devices)
    if num_devices is not None:
        if num_devices > len(devices):
            raise ValueError(
                f"requested {num_devices} devices, only {len(devices)} "
                "visible")
        devices = devices[:num_devices]
    return Mesh(devices)


def pad_rows(n: int, num_shards: int, multiple: int = 8) -> int:
    """Padded row count: divisible by num_shards with each shard a
    multiple of `multiple` rows. Padded rows are masked out of selection."""
    per = -(-n // num_shards)
    per = -(-per // multiple) * multiple
    return per * num_shards


def shard_padded_rows(mesh: Mesh, arr, multiple: int = 8, dtype=None) -> list:
    """Pad `arr`'s leading axis with zeros to pad_rows(n, P, multiple)
    and cut it into P equal row shards, shard r on mesh.devices[r]."""
    arr = np.asarray(arr)
    n = arr.shape[0]
    n_pad = pad_rows(n, mesh.size, multiple)
    if n_pad != n:
        padded = np.zeros((n_pad,) + arr.shape[1:], arr.dtype)
        padded[:n] = arr
        arr = padded
    n_loc = n_pad // mesh.size
    out = []
    for r, dev in enumerate(mesh.devices):
        t = torch.as_tensor(arr[r * n_loc:(r + 1) * n_loc], device=dev)
        out.append(t if dtype is None else t.to(dtype))
    return out


def replicate_array(mesh: Mesh, arr) -> list:
    """`arr` on every distinct device of the mesh: one tensor per group."""
    arr = np.asarray(arr)
    return [torch.as_tensor(arr, device=dev) for dev, _ in mesh.groups]


def unshard(parts) -> np.ndarray:
    """The row-sharded list back as one host array, in rank order."""
    return np.concatenate([p.detach().cpu().numpy() for p in parts])
