"""The process-spanning data mesh (dpsvm_tpu_torch/parallel/mesh.py
initialize_multihost, Mesh(span_processes=True)) on the CPU: two OS
processes, each holding two CPU shards, joined by gloo over loopback.

Every mesh engine the job runs is held BITWISE to the one-process mesh of
four CPU shards on the same inputs (alpha, f, b, pairs and rounds), which
tests/test_torch_mesh_solve.py holds against the JAX package's
solve_mesh; so are the out-of-core mesh stream (plain, compensated,
stopped and resumed, warm-started), the mesh warm rebuild and the mesh
decision function (the decisions), which tests/test_torch_ooc_mesh.py,
test_torch_warmstart.py and test_torch_predict_mesh.py hold against the
JAX package. One two-process in-core solve and one out-of-core solve
also meet the whole-solve contract against JAX's solve_mesh on four
forced host devices, here. Also pinned: the collectives' global rank
order, a stop and resume across processes (and the two-process
checkpoint resumed in one process), the auto backend's route of an
out-of-core job, every refusal and the one-time retry warning.

The children are this file run as a script (``--child``): they import
torch and the port only. One spawn of two children runs every case and
writes an .npz a process; module-scoped fixtures feed the parametrised
cases. Children and the one-process twin run with one torch thread (the
CPU GEMM's sums may depend on the thread count), each child has a hard
timeout and every child is killed on the way out.
"""

from __future__ import annotations

import os
import shutil
import socket
import subprocess
import sys
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPROC, LOCAL = 2, 2
CHILD_TIMEOUT_S = 300
DATA = dict(n=160, d=8, seed=3, sep=1.2)
BASE = dict(c=5.0, gamma=0.1, epsilon=1e-3, max_iter=200_000,
            engine="block", working_set_size=16)
# The per-pair engine exchanges three times a pair: its cases stop at a
# looser epsilon to stay cheap (bitwise at any epsilon).
PAIR = dict(engine="xla", epsilon=1e-2)
NU = 0.3
STOP_CHUNKS = 3
# The out-of-core cases: 24-row tiles, so each of the four shards owns
# two (48 rows, 192 padded) and the last shard's second tile is empty.
OOC = dict(ooc=True, ooc_tile_rows=24)
# name -> (how, config knobs over BASE). "solve": solve_mesh; "nusvc":
# train_nusvc on the mesh (the nu rule); "gram": the precomputed Gram;
# "stop": stopped by the callback after STOP_CHUNKS observations and
# resumed from the checkpoint; "warm": solve_mesh from a WarmStart;
# "predict": decision_function_mesh of a fixed model.
RUNS = {
    "global_mvp": ("solve", {}),
    "global_compensated": ("solve", dict(compensated=True)),
    "global_second_order": ("solve", dict(selection="second_order")),
    "global_nu": ("nusvc", {}),
    "global_precomputed": ("gram", {}),
    "global_legs": ("solve", dict(compensated=True, reconstruct_every=300)),
    "perpair_mvp": ("solve", PAIR),
    "perpair_second_order": ("solve", dict(PAIR, selection="second_order")),
    "perpair_cache": ("solve", dict(PAIR, cache_lines=16)),
    "perpair_nu": ("nusvc", PAIR),
    "pipelined": ("solve", dict(pipeline_rounds=True)),
    "fused_fold": ("solve", dict(fused_fold=True, max_iter=600)),
    "active": ("solve", dict(active_set_size=64, reconcile_rounds=4)),
    "shardlocal": ("solve", dict(local_working_sets=4, sync_rounds=2)),
    "ooc": ("solve", OOC),
    "ooc_compensated": ("solve", dict(OOC, compensated=True)),
    "ooc_stop_resume": ("stop", dict(OOC, checkpoint_every=1)),
    "warm_start": ("warm", {}),
    "ooc_warm": ("warm", OOC),
    "predict_mesh": ("predict", {}),
}
# The stop / resume pair runs observed chunks of this many pairs.
STOP_RUN = dict(chunk_iters=256, checkpoint_every=1)
REFUSALS = ("ring_exchange", "ring_runner", "unequal_ranks")


def _data():
    from dpsvm_tpu_torch.data import make_blobs_binary

    return make_blobs_binary(**DATA)


def _warm_seed(y) -> np.ndarray:
    """A warm start of a third of the rows at C / 2 (repaired on use)."""
    return np.where(np.arange(len(y)) % 3 == 0, 0.5 * BASE["c"],
                    0.0).astype(np.float32)


def _run(name, mesh, x, y, workdir, **kw):
    """RUNS[name] on `mesh` (a "stop" run keeps its checkpoint in
    `workdir`): (alpha, f, b, pairs, rounds, converged), or a "predict"
    run's decisions."""
    from dpsvm_tpu_torch import SVMConfig, solve_mesh
    from dpsvm_tpu_torch.models import train_nusvc
    from dpsvm_tpu_torch.models.svm_model import SVMModel
    from dpsvm_tpu_torch.ops.kernels import KernelParams, kernel_matrix
    from dpsvm_tpu_torch.predict import decision_function_mesh
    from dpsvm_tpu_torch.solver.warmstart import WarmStart

    how, knobs = RUNS[name]
    cfg = SVMConfig(**{**BASE, **knobs})
    if how == "predict":
        model = SVMModel.from_dense(x, y, _warm_seed(y), 0.25,
                                    KernelParams("rbf", cfg.gamma))
        return {"dec": decision_function_mesh(model, x, mesh=mesh,
                                              block=64)}
    if how == "stop":
        return _stop_resume(mesh, x, y, cfg,
                            os.path.join(workdir, f"{name}.npz"))
    if how == "warm":
        res = solve_mesh(x, y, cfg, mesh=mesh,
                         warm_start=WarmStart(_warm_seed(y)), **kw)
    elif how == "nusvc":
        _, res = train_nusvc(x, y, nu=NU, config=cfg, backend="mesh",
                             mesh=mesh, **kw)
    elif how == "gram":
        import torch

        xt = torch.as_tensor(x)
        gram = kernel_matrix(xt, xt, KernelParams("rbf", cfg.gamma)).numpy()
        res = solve_mesh(gram, y, cfg.replace(kernel="precomputed"),
                         mesh=mesh, **kw)
    else:
        res = solve_mesh(x, y, cfg, mesh=mesh, **kw)
    return _pack(res)


def _pack(res) -> dict:
    return {"alpha": np.asarray(res.alpha, np.float32),
            "f": np.asarray(res.stats["f"], np.float32),
            "b": np.float64(res.b), "pairs": np.int64(res.iterations),
            "rounds": np.int64(res.stats.get("outer_rounds", -1)),
            "converged": np.bool_(res.converged)}


def _stop_resume(mesh, x, y, cfg, ckpt: str, keep=None) -> dict:
    """A solve stopped by its callback after STOP_CHUNKS chunks (rounds
    out of core; the checkpoint then copied to `keep`), then resumed
    from the checkpoint."""
    import torch.distributed

    from dpsvm_tpu_torch import solve_mesh

    seen = []

    def stop(it, b_hi, b_lo, state):
        seen.append(it)
        return len(seen) >= STOP_CHUNKS

    first = solve_mesh(x, y, cfg, mesh=mesh, callback=stop,
                       checkpoint_path=ckpt)
    if keep is not None and mesh.process_index == 0:
        shutil.copyfile(ckpt, keep)
    if mesh.num_processes > 1:
        torch.distributed.barrier()
    res = solve_mesh(x, y, cfg, mesh=mesh, checkpoint_path=ckpt, resume=True)
    out = _pack(res)
    out["stopped_at"] = np.int64(first.iterations)
    return out


def _collectives(mesh) -> dict:
    """Rank-tagged values through every collective, in one exchange per
    call (all_gather_many, psum_many) and one each (pmax)."""
    import torch

    from dpsvm_tpu_torch.parallel.mesh import unshard

    pairs = list(zip(mesh.local_ranks, mesh.devices))
    f32 = [torch.arange(3, dtype=torch.float32, device=d) + 10.0 * r
           for r, d in pairs]
    i64 = [torch.tensor([r, -r], dtype=torch.int64, device=d)
           for r, d in pairs]
    flag = [torch.tensor(r % 2 == 0, device=d) for r, d in pairs]
    inv = [torch.tensor(1.0 / (r + 1), dtype=torch.float32, device=d)
           for r, d in pairs]
    g32, g64, gb = mesh.all_gather_many(f32, i64, flag)
    s_inv, s_i64 = mesh.psum_many(inv, i64)
    return {"gather_f32": g32[0].numpy(), "gather_i64": g64[0].numpy(),
            "gather_bool": gb[0].numpy(), "psum_inv": s_inv[0].numpy(),
            "psum_i64": s_i64[0].numpy(),
            "pmax": mesh.pmax(f32)[0].numpy(),
            "unshard": unshard(f32, mesh)}


def _refusals(mesh, x, y) -> dict:
    """The message of each refusal across processes."""
    import torch

    from dpsvm_tpu_torch import Mesh, SVMConfig, solve_mesh
    from dpsvm_tpu_torch.ops.kernels import KernelParams
    from dpsvm_tpu_torch.parallel.dist_block import make_block_chunk_runner

    cfg = SVMConfig(**BASE)
    calls = {
        "ring_exchange": lambda: solve_mesh(
            x, y, cfg.replace(ring_exchange=True), mesh=mesh),
        "ring_runner": lambda: make_block_chunk_runner(
            mesh, KernelParams("rbf", cfg.gamma), cfg.c_bounds(), 1e-3,
            1e-12, 16, 32, ring_exchange=True),
        "unequal_ranks": lambda: Mesh(
            [torch.device("cpu")] * (2 if mesh.process_index == 0 else 1),
            span_processes=True),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = ""
        except ValueError as e:
            out[name] = str(e)
    return out


def child_main(coordinator: str, process_id: int, out_dir: str) -> int:
    import torch

    from dpsvm_tpu_torch import Mesh, SVMConfig
    from dpsvm_tpu_torch.parallel.mesh import (initialize_multihost,
                                               shutdown_multihost)
    from dpsvm_tpu_torch.train import resolve_backend

    torch.set_num_threads(1)
    backend = initialize_multihost(coordinator, NPROC, process_id,
                                   devices=["cpu"], timeout_s=120.0)
    try:
        mesh = Mesh(["cpu"] * LOCAL, span_processes=True)
        x, y = _data()
        out = {"backend": np.str_(backend),
               "describe": np.array(mesh.describe()),
               "local_ranks": np.array(mesh.local_ranks)}
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for name in RUNS:
                for k, v in _run(name, mesh, x, y, out_dir).items():
                    out[f"{name}/{k}"] = v
        out["retry_warnings"] = np.int64(sum(
            "retry_faults=2 is disabled on this 2-process job" in str(w.message)
            for w in caught))
        for k, v in _stop_resume(
                mesh, x, y, SVMConfig(**{**BASE, **STOP_RUN}),
                os.path.join(out_dir, "ckpt.npz"),
                os.path.join(out_dir, "ckpt_stop.npz")).items():
            out[f"stop_resume/{k}"] = v
        out["auto_backend"] = np.str_(resolve_backend(
            "auto", SVMConfig(**{**BASE, **OOC})))
        for k, v in _collectives(mesh).items():
            out[f"coll/{k}"] = v
        for k, v in _refusals(mesh, x, y).items():
            out[f"refuse/{k}"] = np.str_(v)
        np.savez(os.path.join(out_dir, f"proc{process_id}.npz"), **out)
    finally:
        shutdown_multihost()
    return 0


if __name__ == "__main__" and sys.argv[1:2] == ["--child"]:
    sys.exit(child_main(sys.argv[2], int(sys.argv[3]), sys.argv[4]))

# ---------------------------------------------------------------------
# The tests (pytest imports this module; the children never reach here).

import pytest  # noqa: E402
import torch  # noqa: E402

from dpsvm_tpu_torch.utils.hostenv import child_env  # noqa: E402


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(argvs, cwd) -> list:
    """Start one process per argv (collect() waits for them)."""
    env = child_env(ROOT, threads=1)
    return [subprocess.Popen(a, cwd=cwd, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for a in argvs]


def collect(procs, timeout=CHILD_TIMEOUT_S) -> list:
    """Wait for every process (each within `timeout` seconds), killing
    any still running on the way out; their (exit code, output). A child
    past its time fails the test."""
    try:
        done = []
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            done.append((p.returncode, out))
        return done
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def spawn_pair(argvs, cwd, timeout=CHILD_TIMEOUT_S) -> list:
    return collect(spawn(argvs, cwd), timeout)


@pytest.fixture(scope="module")
def one_thread():
    """Pin the twin to the children's thread count; restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def job(tmp_path_factory, one_thread):
    """(both processes' .npz, the run directory, the twin): the twin is
    every run on one process's mesh of four CPU shards, computed here
    while the children run."""
    from dpsvm_tpu_torch import Mesh

    out_dir = str(tmp_path_factory.mktemp("multiproc"))
    twin_dir = str(tmp_path_factory.mktemp("multiproc_twin"))
    addr = f"127.0.0.1:{free_port()}"
    procs = spawn([[sys.executable, os.path.abspath(__file__), "--child",
                    addr, str(k), out_dir] for k in range(NPROC)],
                  cwd=out_dir)
    try:
        x, y = _data()
        mesh = Mesh(["cpu"] * (NPROC * LOCAL))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            twin = {name: _run(name, mesh, x, y, twin_dir) for name in RUNS}
    finally:
        runs = collect(procs)
    for rc, out in runs:
        assert rc == 0, out[-4000:]
    loaded = []
    for k in range(NPROC):
        with np.load(os.path.join(out_dir, f"proc{k}.npz")) as z:
            loaded.append({key: z[key] for key in z.files})
    return loaded, out_dir, twin


@pytest.fixture(scope="module")
def children(job):
    """Both processes' .npz, and the run directory."""
    return job[:2]


@pytest.fixture(scope="module")
def twin(job):
    return job[2]


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == \
        b.tobytes()


def test_child_env_puts_the_root_first_and_pins_threads():
    env = child_env("/repo", threads=3,
                    base={"PYTHONPATH": os.pathsep.join(["/x", "/repo"]),
                          "OMP_NUM_THREADS": "8", "KEEP": "1"})
    assert env["PYTHONPATH"] == os.pathsep.join(["/repo", "/x"])
    assert env["OMP_NUM_THREADS"] == "3" and env["KEEP"] == "1"
    assert "OMP_NUM_THREADS" not in child_env("/repo", threads=None,
                                              base={})
    assert child_env("/repo", base={})["PYTHONPATH"] == "/repo"
    with pytest.raises(ValueError, match="threads"):
        child_env("/repo", threads=0)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_two_processes_bitwise_one_process(children, twin, name):
    """alpha, f, b, pairs and rounds (a predict run: the decisions) of 2
    processes x 2 shards are the bits of one process driving 4 shards,
    in both processes."""
    procs, _ = children
    want = twin[name]
    for proc in procs:
        for key, val in want.items():
            assert _same(proc[f"{name}/{key}"], val), (name, key)
    if "converged" in want and name != "fused_fold":  # a capped run
        assert bool(want["converged"])
    if RUNS[name][0] == "stop":  # and resumed: the uninterrupted bits
        assert 0 < int(want["stopped_at"]) < int(want["pairs"])
        for key in ("alpha", "f", "b", "pairs", "rounds"):
            assert _same(want[key], twin["ooc"][key]), key


def test_the_job_spans_processes(children):
    procs, _ = children
    for k, proc in enumerate(procs):
        assert str(proc["backend"]) == "gloo"
        assert list(proc["local_ranks"]) == [LOCAL * k + i
                                            for i in range(LOCAL)]
        assert list(proc["describe"]) == [
            f"cpu (process {p})" for p in range(NPROC) for _ in range(LOCAL)]


def test_stop_and_resume_across_processes(children, twin):
    """Stopped by the callback at a chunk boundary and resumed from the
    process-0 checkpoint: the global runner's uninterrupted bits."""
    procs, _ = children
    want = twin["global_mvp"]
    for proc in procs:
        assert 0 < int(proc["stop_resume/stopped_at"]) < int(want["pairs"])
        for key, val in want.items():
            assert _same(proc[f"stop_resume/{key}"], val), key


def test_two_process_checkpoint_resumes_in_one_process(children, one_thread,
                                                       tmp_path):
    """The file the two-process job stopped at resumes on one process's
    four shards to the two-process resume's bits."""
    from dpsvm_tpu_torch import Mesh, SVMConfig, solve_mesh

    procs, out_dir = children
    ckpt = str(tmp_path / "ckpt.npz")
    shutil.copyfile(os.path.join(out_dir, "ckpt_stop.npz"), ckpt)
    x, y = _data()
    res = solve_mesh(x, y, SVMConfig(**{**BASE, **STOP_RUN}),
                     mesh=Mesh(["cpu"] * 4), checkpoint_path=ckpt,
                     resume=True)
    for key, val in _pack(res).items():
        assert _same(procs[0][f"stop_resume/{key}"], val), key


def test_two_processes_meet_jax_solve_mesh_contract(children):
    """The whole-solve contract of tests/test_torch_mesh_solve.py against
    the JAX package's solve_mesh on four forced host devices."""
    _assert_jax_contract(children[0], "global_mvp", {})


def test_two_process_ooc_meets_jax_solve_mesh_contract(children):
    """The same contract out of core: the two-process mesh stream against
    the JAX package's solve_mesh(ooc=True) on the same tiles."""
    _assert_jax_contract(children[0], "ooc", OOC)


def _assert_jax_contract(procs, name: str, knobs: dict) -> None:
    from dpsvm_tpu.config import SVMConfig as JaxConfig
    from dpsvm_tpu.parallel.dist_smo import solve_mesh as jax_solve_mesh
    from dpsvm_tpu_torch.ops.select import extrema_np

    x, y = _data()
    jcfg = JaxConfig(**{**BASE, **knobs})
    assert jcfg.kernel != "sigmoid"  # C.42: not held to the contract
    rj = jax_solve_mesh(x, y, jcfg, num_devices=4)
    a = procs[0][f"{name}/alpha"].astype(np.float64)
    f = procs[0][f"{name}/f"].astype(np.float64)
    aj = np.asarray(rj.alpha, np.float64)
    fj = np.asarray(rj.stats["f"], np.float64)
    obj = a.sum() - 0.5 * np.sum(a * y * (f + y))
    obj_j = aj.sum() - 0.5 * np.sum(aj * y * (fj + y))
    assert rj.converged and bool(procs[0][f"{name}/converged"])
    assert abs(obj - obj_j) <= 1e-4 * abs(obj_j), (obj, obj_j)
    n_sv, n_sv_j = int(np.count_nonzero(a)), int(rj.n_sv)
    assert abs(n_sv - n_sv_j) <= 0.02 * n_sv_j, (n_sv, n_sv_j)
    assert abs(float(procs[0][f"{name}/b"]) - rj.b) <= 5e-3
    b_hi, b_lo = extrema_np(f, a, y, (BASE["c"], BASE["c"]))
    assert b_lo <= b_hi + 2 * BASE["epsilon"] + 1e-6


def test_auto_backend_takes_the_mesh_for_an_ooc_job(children):
    """train.py resolve_backend: "auto" in a job of two processes routes
    a plain out-of-core request to the mesh stream."""
    for proc in children[0]:
        assert str(proc["auto_backend"]) == "mesh"


P = NPROC * LOCAL


@pytest.mark.parametrize("key,want", [
    ("gather_f32", np.stack([np.arange(3, dtype=np.float32) + 10.0 * r
                             for r in range(P)])),
    ("gather_i64", np.array([[r, -r] for r in range(P)], np.int64)),
    ("gather_bool", np.array([r % 2 == 0 for r in range(P)])),
    ("pmax", np.arange(3, dtype=np.float32) + 10.0 * (P - 1)),
    ("psum_i64", np.array([sum(range(P)), -sum(range(P))], np.int64)),
    ("unshard", np.concatenate([np.arange(3, dtype=np.float32) + 10.0 * r
                                for r in range(P)])),
])
def test_collectives_in_global_rank_order(children, key, want):
    for proc in children[0]:
        assert _same(proc[f"coll/{key}"], want), key


def test_psum_adds_in_global_rank_order(children):
    """A float32 sum of 1/(r+1) whose bits depend on the order: the
    one-process mesh's left-to-right sum over the ranks."""
    from dpsvm_tpu_torch import Mesh

    mesh = Mesh(["cpu"] * P)
    want = mesh.psum([torch.tensor(1.0 / (r + 1), dtype=torch.float32)
                      for r in range(P)])[0].numpy()
    for proc in children[0]:
        assert _same(proc["coll/psum_inv"], want)


@pytest.mark.parametrize("name,marks", [
    ("ring_exchange", ("item 6",)), ("ring_runner", ("item 6",)),
    ("unequal_ranks", ("[2, 1]",))])
def test_refused_across_processes(children, name, marks):
    """What does not run across processes raises a ValueError naming its
    ROADMAP item (every process refuses alike)."""
    assert set(REFUSALS) >= {name}
    for proc in children[0]:
        msg = str(proc[f"refuse/{name}"])
        assert msg, f"{name} was not refused"
        for m in marks:
            assert m in msg, msg


def test_retry_faults_dropped_with_one_warning(children):
    """retry_faults is dropped across processes with JAX's advice, warned
    once a process however many solves the job runs."""
    for proc in children[0]:
        assert int(proc["retry_warnings"]) == 1


def test_multihost_check_module(tmp_path):
    """The bring-up check (parallel/multihost_check.py) on two processes
    of two CPU shards each."""
    (rc, out), = spawn_pair([[sys.executable, "-m",
                              "dpsvm_tpu_torch.parallel.multihost_check",
                              "--device", "cpu", "--timeout", "240"]],
                            cwd=str(tmp_path), timeout=600)
    assert rc == 0, out[-4000:]
    assert "MULTIHOST CHECK: PASS" in out
    assert out.count("bitwise the one-process mesh") == NPROC


@pytest.mark.parametrize("tokens,want", [
    ([["cpu"], ["cpu"]], "gloo"),
    ([["GPU-a"], ["GPU-a"]], "gloo"),
    ([["GPU-a", "GPU-b"], ["GPU-b"]], "gloo"),
    ([["GPU-a"], ["cpu"]], "gloo"),
    ([["GPU-a"], ["GPU-b"]], "nccl"),
    ([["GPU-a", "GPU-a"], ["GPU-b", "GPU-c"]], "nccl"),
])
def test_backend_rule(tokens, want):
    """gloo where a process holds CPU shards or two processes share a
    card; nccl where every process owns distinct cards (logical shards
    of one card within a process do not share it with another)."""
    from dpsvm_tpu_torch.parallel.mesh import choose_backend

    assert choose_backend(tokens) == want


def test_one_process_mesh_is_unchanged():
    """span_processes without a process group is the one-process mesh."""
    from dpsvm_tpu_torch import Mesh
    from dpsvm_tpu_torch.parallel.mesh import (make_data_mesh, process_count,
                                               process_index)

    assert (process_count(), process_index()) == (1, 0)
    for mesh in (Mesh(["cpu"] * 3, span_processes=True),
                 make_data_mesh(devices=["cpu"] * 3)):
        assert mesh.size == 3 and mesh.num_processes == 1
        assert mesh.local_ranks == (0, 1, 2)
        assert mesh.describe() == ["cpu"] * 3


@pytest.mark.parametrize("kw", [
    dict(coordinator_address=None, num_processes=2, process_id=0),
    dict(coordinator_address="127.0.0.1:1", num_processes=None,
         process_id=0),
    dict(coordinator_address="127.0.0.1:1", num_processes=2, process_id=2),
    dict(coordinator_address="localhost", num_processes=2, process_id=0),
])
def test_initialize_multihost_refuses_bad_flags(kw):
    from dpsvm_tpu_torch.parallel.mesh import initialize_multihost

    with pytest.raises(ValueError):
        initialize_multihost(devices=["cpu"], timeout_s=1.0, **kw)
