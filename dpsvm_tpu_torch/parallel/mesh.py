"""The data mesh (counterpart of dpsvm_tpu/parallel/mesh.py).

The JAX package is a single controller over many devices: one program,
compiled once over a ``jax.sharding.Mesh``, with the collectives
inserted by XLA. The port is a single controller too: one Python process
drives its shards, a row-sharded array is a list of tensors (one per
rank this process owns, shard i on ``mesh.devices[i]``), and a
replicated value is one tensor per distinct device.

A device may appear more than once. ``Mesh([torch.device("cuda:0")] * 4)``
is four LOGICAL shards of one card, each with its own row slice, state
and rank id, the counterpart of the JAX package's forced host devices.
``make_data_mesh`` never repeats a device by itself; ``Mesh.describe()``
lists the devices, so a logical mesh is not mistaken for a multi-card
one.

A mesh may span several OS processes (the JAX package's multi-host job,
``initialize_multihost``; the reference's one MPI rank per GPU). Every
process runs the same program; after ``initialize_multihost`` a
``Mesh(devices, span_processes=True)`` (and ``make_data_mesh``) has
P = L x num_processes global ranks, of which process k owns the
contiguous block ``local_ranks`` = [k L, (k + 1) L) on its L local
devices. The lists hold the local ranks only, ``groups`` the local
devices only, and the collectives exchange the local parts across the
processes once per call through the torch.distributed process group, so
every process holds the same replicated values. ``psum`` adds the
gathered parts in global rank order, never through ``all_reduce`` (whose
order is the backend's), so a P-rank sum has the same bits in one
process or in many. With one process nothing is exchanged and nothing
changes.

The process group's backend follows a fixed rule (``choose_backend``):
``gloo`` where a process holds CPU shards or two processes hold shards
of one card (decided from the cards' UUIDs, exchanged through the
rendezvous store before the group is made), ``nccl`` where every process
owns distinct cards. On ``gloo`` a CUDA exchange stages through pinned
host buffers (gloo's collectives are CPU-only), as the reference's
``MPI_Allgather`` moved host buffers; on ``nccl`` the device buffers are
exchanged directly.
"""

from __future__ import annotations

import datetime
import time
from typing import Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"

#: Seconds a rendezvous or a collective waits for its peers before it
#: fails: a process that diverges or dies fails the job instead of
#: hanging it.
DEFAULT_TIMEOUT_S = 600.0


def _dist():
    import torch.distributed as dist

    return dist


def process_count() -> int:
    """Processes of the job: the process group's size, 1 without one."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    """This process's index in the job (0 without a process group)."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _device_tokens(devices) -> list:
    """What the backend rule reads of a process's devices: "cpu" for a
    CPU device, the card's UUID for a CUDA device."""
    out = []
    for dev in devices:
        dev = _with_index(torch.device(dev))
        if dev.type == "cpu":
            out.append("cpu")
        elif dev.type == "cuda":
            out.append(str(torch.cuda.get_device_properties(dev.index).uuid))
        else:
            raise ValueError(f"a mesh device is 'cpu' or 'cuda', not {dev}")
    return out


def choose_backend(tokens_by_process: Sequence[Sequence[str]]) -> str:
    """The process group's backend from every process's device tokens
    (``_device_tokens``): "gloo" when any process holds CPU shards or one
    card is held by two processes (NCCL takes one rank per card), else
    "nccl"."""
    owner: dict = {}
    for k, tokens in enumerate(tokens_by_process):
        for t in tokens:
            if t == "cpu":
                return "gloo"
            if owner.setdefault(t, k) != k:
                return "gloo"
    return "nccl"


def _coordinator_url(address: str) -> str:
    address = address[len("tcp://"):] if address.startswith("tcp://") \
        else address
    if ":" not in address:
        raise ValueError(
            f"coordinator address {address!r} is not host:port")
    return f"tcp://{address}"


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, devices=None,
                         timeout_s: float = DEFAULT_TIMEOUT_S,
                         backend: Optional[str] = None) -> str:
    """Multi-process bring-up, the ``mpirun`` equivalent (the JAX
    package's initialize_multihost): every process of the job calls this
    once with the same coordinator ``host:port`` (process 0 listens
    there) and process count, and its own ``process_id``, before it
    builds its mesh. ``devices`` are the devices this process will hold
    shards on (default: the visible CUDA cards; "cpu" for the plain
    path). The processes meet at the ``tcp://`` rendezvous, exchange
    their device tokens through its store, and make the group with the
    backend ``choose_backend`` names (``backend`` names one explicitly).
    Rendezvous and collectives fail after ``timeout_s`` seconds. Returns
    the backend."""
    dist = _dist()
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "a multi-process job needs --coordinator-address, "
            "--num-processes and --process-id in every process")
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    if not 0 <= int(process_id) < int(num_processes):
        raise ValueError(f"process id {process_id} is not in "
                         f"[0, {num_processes})")
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError(
                "no CUDA device is visible; pass devices=['cpu'] "
                "(--device cpu) to run the job on the plain path")
    devices = [_with_index(torch.device(d)) for d in devices]
    timeout = datetime.timedelta(seconds=float(timeout_s))
    rank, world = int(process_id), int(num_processes)
    url = f"{_coordinator_url(coordinator_address)}?rank={rank}" \
          f"&world_size={world}"
    store, _, _ = next(dist.rendezvous(url, timeout=timeout))
    store.set(f"dpsvm/devices/{rank}", ",".join(_device_tokens(devices)))
    tokens = [store.get(f"dpsvm/devices/{k}").decode().split(",")
              for k in range(world)]
    chosen = backend or choose_backend(tokens)
    if chosen == "nccl":
        cuda = [d for d in devices if d.type == "cuda"]
        if not cuda:
            raise ValueError("the nccl backend needs CUDA devices")
        torch.cuda.set_device(cuda[0])
    dist.init_process_group(chosen, store=store, world_size=world,
                            rank=rank, timeout=timeout)
    return chosen


def shutdown_multihost() -> None:
    """Leave the process group (every process, at the end of the job)."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _with_index(dev: torch.device) -> torch.device:
    """"cuda" names the current card: give it its index, so that it and
    "cuda:0" are one device of the mesh, as they are one card."""
    if dev.type == "cuda" and dev.index is None:
        index = torch.cuda.current_device() if torch.cuda.is_available() else 0
        return torch.device("cuda", index)
    return dev


class Mesh:
    """An ordered list of P ranks, one per row shard. In one process the
    ranks are `devices` (rank = position). With ``span_processes`` and a
    process group of W > 1 processes (``initialize_multihost``), `devices`
    are this process's L ranks, P = L W, and every process must pass the
    same count (checked here).

    ``groups`` lists each distinct LOCAL device once, in order of first
    appearance, with the local positions (indices into the per-rank
    lists) that live on it: replicated values are computed and held once
    per group. ``local_ranks`` are the global ranks of the local
    positions. The collectives take one tensor per local rank and return
    one result per group, on the group's device."""

    def __init__(self, devices: Sequence, span_processes: bool = False):
        self.devices = tuple(_with_index(torch.device(d)) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        n_loc = len(self.devices)
        self.num_processes, self.process_index = 1, 0
        self.local_ranks = tuple(range(n_loc))
        self._names = [str(d) for d in self.devices]
        self._pinned: dict = {}
        #: the process group's backend when the mesh spans processes
        self.backend = None
        #: cross-process exchanges made, and the host seconds they took
        #: from the device's queued work retired to the gathered bytes
        #: back on the device (staging copies and the collective)
        self.exchanges = 0
        self.exchange_seconds = 0.0
        if span_processes and process_count() > 1:
            self._join_processes()
        by_dev: dict = {}
        for pos, dev in enumerate(self.devices):
            by_dev.setdefault(dev, []).append(pos)
        self.groups = tuple((dev, tuple(pos))
                            for dev, pos in by_dev.items())
        #: local position -> index of its group
        self.group_of = tuple(
            next(g for g, (_, pos) in enumerate(self.groups) if i in pos)
            for i in range(n_loc))

    def _join_processes(self) -> None:
        dist = _dist()
        w, k = process_count(), process_index()
        self.backend = dist.get_backend()
        if self.backend == "nccl" and any(d.type != "cuda"
                                          for d in self.devices):
            raise ValueError("a mesh on the nccl process group holds CUDA "
                             "devices only")
        names = [None] * w
        dist.all_gather_object(names, [str(d) for d in self.devices])
        counts = [len(n) for n in names]
        if len(set(counts)) != 1:
            raise ValueError(
                "every process of a mesh owns the same number of ranks; "
                f"the processes own {counts}")
        n_loc = counts[0]
        self.num_processes, self.process_index = w, k
        self.local_ranks = tuple(range(k * n_loc, (k + 1) * n_loc))
        self._names = [f"{d} (process {p})"
                       for p, ns in enumerate(names) for d in ns]

    @property
    def size(self) -> int:
        """P, the global number of ranks."""
        return len(self.devices) * self.num_processes

    def describe(self) -> list:
        """The devices by global rank, as strings
        (SolveResult.stats["mesh_devices"]); across processes each names
        its process."""
        return list(self._names)

    def _on(self, parts, dev):
        # Shards of one device are used where they lie; a shard of another
        # card is copied over (a plain peer copy).
        return [p if p.device == dev else p.to(dev) for p in parts]

    # -- the cross-process exchange ------------------------------------

    def _host_buffer(self, key, shape) -> torch.Tensor:
        """A pinned host staging buffer, reused across exchanges (every
        copy through it is synchronous)."""
        buf = self._pinned.get(key)
        if buf is None or tuple(buf.shape) != tuple(shape):
            buf = torch.empty(shape, dtype=torch.uint8, pin_memory=True)
            self._pinned[key] = buf
        return buf

    def _exchange(self, tensors) -> list:
        """Every process's `tensors` (one device, the same shapes and
        dtypes in every process): per tensor the (W, *shape) stack of
        the processes' values in process order, on the tensors' device.
        ONE collective carries them all, as raw bytes."""
        dist = _dist()
        dev = tensors[0].device
        w = self.num_processes
        flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                          for t in tensors])
        nbytes = flat.numel()
        if dev.type == "cuda":
            # The staging copy waits for the queued work anyway; waiting
            # here first keeps that work out of the exchange's clock.
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if self.backend == "nccl":
            send = flat if dev.type == "cuda" else flat.to(self.devices[0])
            recv = torch.empty((w, nbytes), dtype=torch.uint8,
                               device=send.device)
        elif dev.type == "cuda":
            send = self._host_buffer("send", (nbytes,))
            send.copy_(flat)
            recv = self._host_buffer("recv", (w, nbytes))
        else:
            send = flat
            recv = torch.empty((w, nbytes), dtype=torch.uint8)
        dist.all_gather(list(recv.unbind(0)), send)
        if recv.device != dev:
            recv = recv.to(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.exchanges += 1
        self.exchange_seconds += time.perf_counter() - t0
        out, off = [], 0
        for t in tensors:
            nb = t.numel() * t.element_size()
            part = recv[:, off:off + nb].contiguous().view(t.dtype)
            out.append(part.reshape((w,) + tuple(t.shape)))
            off += nb
        return out

    def _gathered(self, part_lists) -> list:
        """Per list of per-local-rank parts, the (P, ...) stack in global
        rank order on the first group's device: one exchange for all."""
        stage = self.groups[0][0]
        stacks = [torch.stack(self._on(parts, stage)) for parts in part_lists]
        full = self._exchange(stacks)
        return [g.reshape((self.size,) + tuple(g.shape[2:])) for g in full]

    # -- the collectives -------------------------------------------------

    def all_gather_many(self, *part_lists) -> list:
        """all_gather of several per-rank lists with one exchange: per
        list, per group, the (P, ...) stack in global rank order."""
        if self.num_processes == 1:
            return [[torch.stack(self._on(parts, dev))
                     for dev, _ in self.groups] for parts in part_lists]
        return [[g if g.device == dev else g.to(dev)
                 for dev, _ in self.groups]
                for g in self._gathered(part_lists)]

    def all_gather(self, parts) -> list:
        """Per group, the stack (P, ...) of the per-rank tensors in rank
        order: the layout of lax.all_gather's leading axis."""
        return self.all_gather_many(parts)[0]

    def psum_many(self, *part_lists) -> list:
        """psum of several per-rank lists with one exchange: per list,
        per group, the sum added in global rank order."""
        if self.num_processes == 1:
            out = []
            for parts in part_lists:
                per = []
                for dev, _ in self.groups:
                    local = self._on(parts, dev)
                    acc = local[0]
                    for p in local[1:]:
                        acc = acc + p
                    per.append(acc)
                out.append(per)
            return out
        out = []
        for g in self._gathered(part_lists):
            per = []
            for dev, _ in self.groups:
                full = g if g.device == dev else g.to(dev)
                acc = full[0]
                for r in range(1, self.size):
                    acc = acc + full[r]
                per.append(acc)
            out.append(per)
        return out

    def psum(self, parts) -> list:
        """Per group, the sum of the per-rank tensors, added in rank
        order."""
        return self.psum_many(parts)[0]

    def pmax(self, parts) -> list:
        """Per group, the elementwise maximum of the per-rank tensors."""
        return [g.amax(dim=0) for g in self.all_gather(parts)]

    def synchronize(self) -> None:
        """Wait for the queued work of every local CUDA device."""
        for dev, _ in self.groups:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def require_one_process(self, what: str, item: str) -> None:
        """Refuse `what` on a mesh that spans processes, naming the
        ROADMAP item that carries it across."""
        if self.num_processes > 1:
            raise ValueError(
                f"{what} does not run on a mesh that spans "
                f"{self.num_processes} processes (ROADMAP {item}); run it "
                "in one process")


def make_data_mesh(num_devices: Optional[int] = None,
                   devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the visible CUDA cards (or over `devices`), one
    shard per card, cut to the first `num_devices`. Raises when fewer
    cards are visible than asked for; a card is repeated only when the
    caller lists it so (``Mesh([...])``). In a multi-process job
    (``initialize_multihost``) these are this process's ranks and the
    mesh spans the processes."""
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
    return Mesh(devices, span_processes=True)


def pad_rows(n: int, num_shards: int, multiple: int = 8) -> int:
    """Padded row count: divisible by num_shards with each shard a
    multiple of `multiple` rows. Padded rows are masked out of selection."""
    per = -(-n // num_shards)
    per = -(-per // multiple) * multiple
    return per * num_shards


def shard_padded_rows(mesh: Mesh, arr, multiple: int = 8, dtype=None) -> list:
    """Pad `arr`'s leading axis with zeros to pad_rows(n, P, multiple)
    and cut it into P equal row shards; the local ranks' shards are
    placed, shard i on mesh.devices[i] (every process holds the whole
    array on the host and uploads only its own rows)."""
    arr = np.asarray(arr)
    n = arr.shape[0]
    n_pad = pad_rows(n, mesh.size, multiple)
    if n_pad != n:
        padded = np.zeros((n_pad,) + arr.shape[1:], arr.dtype)
        padded[:n] = arr
        arr = padded
    n_loc = n_pad // mesh.size
    out = []
    for r, dev in zip(mesh.local_ranks, mesh.devices):
        t = torch.as_tensor(arr[r * n_loc:(r + 1) * n_loc], device=dev)
        out.append(t if dtype is None else t.to(dtype))
    return out


def replicate_array(mesh: Mesh, arr) -> list:
    """`arr` on every distinct local device of the mesh: one tensor per
    group."""
    arr = np.asarray(arr)
    return [torch.as_tensor(arr, device=dev) for dev, _ in mesh.groups]


def unshard(parts, mesh: Optional[Mesh] = None) -> np.ndarray:
    """The row-sharded list back as one host array, in rank order; with
    a `mesh` that spans processes, gathered from every process (a
    collective)."""
    local = np.concatenate([p.detach().cpu().numpy() for p in parts])
    if mesh is None or mesh.num_processes == 1:
        return local
    t = torch.from_numpy(np.ascontiguousarray(local))
    full = mesh._exchange([t])[0]
    return full.reshape((-1,) + tuple(t.shape[1:])).cpu().numpy()
