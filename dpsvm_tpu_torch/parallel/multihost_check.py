"""Two-process bring-up check of the process-spanning mesh (the port of
tools/multihost_check.py, the stand-in for a real multi-host launch).

The parent starts TWO OS processes on this machine, each holding
``--local`` shards of ``--device`` (logical shards of one card, or of
the CPU), wires them with ``initialize_multihost`` on a free loopback
port, and each child checks the cross-process semantics the mesh
engines rely on:

  * the process count, the backend of the fixed rule and the ranks each
    process owns;
  * a psum over the mesh (the stopping-pair reduction), added in global
    rank order;
  * an all_gather of process-local values (the candidate exchange, the
    reference's ``MPI_Allgather``), in global rank order;
  * one global block chunk (parallel/dist_block.py, kernel B1 on the
    card) over process-local shards of a small problem, bit for bit the
    same chunk on one process's logical mesh of all the ranks;
  * the mesh warm rebuild (solver/warmstart.py warm_rebuild_mesh), the
    mesh decision function (predict.py decision_function_mesh) and a
    small out-of-core mesh solve (solve_mesh with config.ooc, kernel B1
    once a round on the card), each bit for bit the same call on the
    one-process mesh.

``--nccl-same-card`` instead asks NCCL for two ranks on one card and
prints what NCCL answers (the backend rule takes gloo there).

Run: ``python -m dpsvm_tpu_torch.parallel.multihost_check [--device
cpu] [--local 2]``. Exit 0 = every check passed in both processes. Each
child has a hard timeout and every child is killed on the way out.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys

from dpsvm_tpu_torch.utils.hostenv import child_env

NPROC = 2
CHILD_TIMEOUT_S = 240.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _check_collectives(mesh, dev) -> None:
    import numpy as np
    import torch

    p = mesh.size
    ones = mesh.psum([torch.ones(1, device=d) for d in mesh.devices])
    got = [float(t.item()) for t in ones]
    assert got == [float(p)] * len(mesh.groups), got
    # Values 1/(r+1) added in global rank order: the float32 bits of the
    # one-process sum of the same terms.
    terms = [torch.tensor([1.0 / (r + 1)], dtype=torch.float32, device=d)
             for r, d in zip(mesh.local_ranks, mesh.devices)]
    want = torch.zeros(1, dtype=torch.float32)
    for r in range(p):
        want = want + torch.tensor([1.0 / (r + 1)], dtype=torch.float32)
    for t in mesh.psum(terms):
        assert torch.equal(t.cpu(), want), (t, want)
    ranks = mesh.all_gather([torch.tensor([r], device=d)
                             for r, d in zip(mesh.local_ranks, mesh.devices)])
    for g in ranks:
        assert np.array_equal(g.cpu().numpy()[:, 0], np.arange(p)), g


def _check_block_chunk(mesh, dev) -> tuple:
    """One global block chunk over the process-local shards, against the
    same chunk on a one-process mesh of P logical shards of `dev`.
    Returns (rounds, pairs)."""
    import numpy as np
    import torch

    from dpsvm_tpu_torch.config import SVMConfig
    from dpsvm_tpu_torch.data import make_blobs_binary
    from dpsvm_tpu_torch.ops.kernels import (KernelParams, kernel_diag,
                                             squared_norms)
    from dpsvm_tpu_torch.parallel.dist_block import (MeshBlockState,
                                                     make_block_chunk_runner)
    from dpsvm_tpu_torch.parallel.mesh import (Mesh, replicate_array,
                                               shard_padded_rows, unshard)

    n, d = 256, 16
    x, y = make_blobs_binary(n=n, d=d, seed=0, sep=1.5)
    cfg = SVMConfig(c=1.0, gamma=0.1)
    kp = KernelParams("rbf", 0.1)

    def run(m):
        xs = shard_padded_rows(m, np.asarray(x, np.float32))
        ys = shard_padded_rows(m, y.astype(np.float32))
        sq = [squared_norms(t) for t in xs]
        kd = [kernel_diag(s, kp) for s in sq]
        valid = shard_padded_rows(m, np.ones(n, bool))
        state = MeshBlockState(
            alpha=shard_padded_rows(m, np.zeros(n, np.float32)),
            f=shard_padded_rows(m, (-y).astype(np.float32)),
            b_hi=replicate_array(m, np.float32(-np.inf)),
            b_lo=replicate_array(m, np.float32(np.inf)),
            pairs=replicate_array(m, np.int32(0)),
            rounds=replicate_array(m, np.int32(0)))
        runner = make_block_chunk_runner(m, kp, cfg.c_bounds(), 1e-3,
                                         float(cfg.tau), q=16,
                                         inner_iters=16, rounds_per_chunk=4)
        out = runner(xs, ys, sq, kd, valid, state, 10_000)
        return (unshard(out.alpha, m), unshard(out.f, m),
                int(out.rounds[0]), int(out.pairs[0]))

    a, f, rounds, pairs = run(mesh)
    a1, f1, rounds1, pairs1 = run(Mesh([dev] * mesh.size))
    assert rounds == rounds1 == 4 and pairs == pairs1 >= 1, (
        rounds, rounds1, pairs, pairs1)
    assert np.array_equal(a.view(np.uint32), a1.view(np.uint32))
    assert np.array_equal(f.view(np.uint32), f1.view(np.uint32))
    return rounds, pairs


def _check_mesh_paths(mesh, dev) -> int:
    """The warm rebuild, the decision function and an out-of-core solve
    over the process-local shards, each against the same call on a
    one-process mesh of P logical shards of `dev`. Returns the ooc
    solve's rounds."""
    import numpy as np

    from dpsvm_tpu_torch.config import SVMConfig
    from dpsvm_tpu_torch.data import make_blobs_binary
    from dpsvm_tpu_torch.models.svm_model import SVMModel
    from dpsvm_tpu_torch.ops.kernels import KernelParams
    from dpsvm_tpu_torch.parallel.dist_smo import solve_mesh
    from dpsvm_tpu_torch.parallel.mesh import Mesh
    from dpsvm_tpu_torch.predict import decision_function_mesh
    from dpsvm_tpu_torch.solver.warmstart import warm_rebuild_mesh

    n, d = 300, 16  # 300 rows: padded tails on 4 shards and in the tiles
    x, y = make_blobs_binary(n=n, d=d, seed=1, sep=1.5)
    kp = KernelParams("rbf", 0.1)
    seed = np.where(np.arange(n) % 3 == 0, 0.5, 0.0).astype(np.float32)
    model = SVMModel.from_dense(x, y, seed, 0.25, kp)
    cfg = SVMConfig(c=1.0, gamma=0.1, epsilon=1e-3, engine="block",
                    working_set_size=16, ooc=True, ooc_tile_rows=48,
                    retry_faults=0)

    def run(m):
        res = solve_mesh(x, y, cfg, mesh=m)
        return (warm_rebuild_mesh(x, y, seed, kp, m),
                decision_function_mesh(model, x, mesh=m, block=128),
                res.alpha, res.stats["f"], res.iterations,
                res.stats["outer_rounds"])

    got = run(mesh)
    want = run(Mesh([dev] * mesh.size))
    for name, a, b in zip(("warm rebuild", "decision function", "ooc alpha",
                           "ooc f"), got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert got[4:] == want[4:], (got[4:], want[4:])
    return got[5]


def child_main(coordinator: str, process_id: int, device: str, local: int,
               threads: int, nccl_same_card: bool) -> int:
    import torch

    from dpsvm_tpu_torch.parallel.mesh import (Mesh, initialize_multihost,
                                               process_count,
                                               shutdown_multihost)

    torch.set_num_threads(threads)
    dev = torch.device(device)
    if nccl_same_card:
        try:
            initialize_multihost(coordinator, NPROC, process_id,
                                 devices=[dev], timeout_s=60.0,
                                 backend="nccl")
            mesh = Mesh([dev] * local, span_processes=True)
            mesh.all_gather([torch.ones(1, device=dev)] * local)
            torch.cuda.synchronize(dev)
            print(f"[proc {process_id}] NCCL ACCEPTED two ranks on one card",
                  flush=True)
        except Exception as e:  # the probe reports what NCCL answered
            msg = " ".join(str(e).split())[:400]
            print(f"[proc {process_id}] NCCL REFUSED: {type(e).__name__}: "
                  f"{msg}", flush=True)
        return 0
    backend = initialize_multihost(coordinator, NPROC, process_id,
                                   devices=[dev], timeout_s=120.0)
    try:
        assert process_count() == NPROC, process_count()
        mesh = Mesh([dev] * local, span_processes=True)
        assert mesh.size == NPROC * local, mesh.size
        assert mesh.local_ranks == tuple(
            range(process_id * local, (process_id + 1) * local))
        _check_collectives(mesh, dev)
        rounds, pairs = _check_block_chunk(mesh, dev)
        ooc_rounds = _check_mesh_paths(mesh, dev)
        print(f"[proc {process_id}] OK: {NPROC} processes on {backend}, "
              f"{mesh.size} ranks {mesh.describe()}, psum/all_gather in "
              f"rank order, block chunk {rounds} rounds / {pairs} pairs, "
              "warm rebuild, decision function and ooc solve "
              f"({ooc_rounds} rounds) bitwise the one-process mesh",
              flush=True)
    finally:
        shutdown_multihost()
    return 0


def _spawn(args, port: int) -> tuple:
    """Run the two children; (exit codes, outputs). Every child is
    killed on the way out."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = child_env(root, threads=args.threads)
    cmd = [sys.executable, "-m", "dpsvm_tpu_torch.parallel.multihost_check",
           "--child", f"127.0.0.1:{port}", "--device", args.device,
           "--local", str(args.local), "--threads", str(args.threads)]
    if args.nccl_same_card:
        cmd.append("--nccl-same-card")
    procs = [subprocess.Popen(cmd + ["--process-id", str(k)], env=env,
                              cwd=root, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for k in range(NPROC)]
    outs, rcs = [], []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=args.timeout)
            outs.append(out or "")
            rcs.append(p.returncode)
    except subprocess.TimeoutExpired:
        rcs = [124] * NPROC
        outs.append(f"a child ran past {args.timeout} s\n")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rcs, outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda:0",
                    help="the device each process holds its shards on")
    ap.add_argument("--local", type=int, default=2,
                    help="shards each process holds")
    ap.add_argument("--threads", type=int, default=1,
                    help="torch threads in each child")
    ap.add_argument("--timeout", type=float, default=CHILD_TIMEOUT_S,
                    help="seconds each child may run")
    ap.add_argument("--nccl-same-card", action="store_true",
                    help="ask NCCL for two ranks on one card and print "
                         "its answer")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--process-id", type=int, default=0,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        return child_main(args.child, args.process_id, args.device,
                          args.local, args.threads, args.nccl_same_card)
    # Two attempts: another process may take the probed port before
    # process 0 listens on it; a fresh port removes the collision.
    for attempt in (1, 2):
        rcs, outs = _spawn(args, _free_port())
        sys.stdout.write("".join(outs))
        if not any(rcs):
            print("MULTIHOST CHECK: PASS")
            return 0
        print(f"attempt {attempt}: child exit codes {rcs}"
              + ("; retrying with a fresh port" if attempt == 1 else ""))
    print("MULTIHOST CHECK: FAIL")
    return 1


if __name__ == "__main__":
    sys.exit(main())
