"""``cli train`` as a two-process job on the CPU (the JAX package's
multi-host flags: every process runs the same command with its own
--process-id; parallel/mesh.py initialize_multihost under it): one model,
written once by process 0 and equal to the one-process mesh's; a run log
from process 0 whose manifest reads process_count 2; a job stopped at
--max-iter and relaunched with --resume, bit for bit the one-process
resume of the same checkpoint; the one-time retry warning; the CLI's
refusal of a one-device backend. The other paths of ``train`` run as
jobs too, each bit for bit its one-process twin (the model file and
process 0's score lines): ``-v 3``, ``-b 1``, ``--kernel precomputed``,
a three-class OvR file and ``--ooc``. Each process holds two CPU shards
(--backend mesh --num-devices 2 --device cpu); the one-process twins run
four shards in this process with the children's one torch thread.

The five path jobs share one spawn: each child (this file run as a
script, ``--child``) runs them in turn through ``cli.main``, and each
makes and leaves its own process group on a fresh port."""

from __future__ import annotations

import json
import os
import sys

LEG_MARK = "=== leg "


def child_main(process_id: int, legs: list) -> int:
    """Run each (name, argv, port) leg of the job as process
    `process_id`, its output after a marker line."""
    import torch

    from dpsvm_tpu_torch import cli

    torch.set_num_threads(1)
    for name, argv, port in legs:
        print(f"{LEG_MARK}{name}", flush=True)
        rc = cli.main([*argv, "--coordinator-address", f"127.0.0.1:{port}",
                       "--num-processes", "2", "--process-id",
                       str(process_id)])
        print(f"{LEG_MARK}{name} exit {rc}", flush=True)
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__" and sys.argv[1:2] == ["--child"]:
    sys.exit(child_main(int(sys.argv[2]), json.loads(sys.argv[3])))

# ---------------------------------------------------------------------
# The tests (pytest imports this module; the children never reach here).

import glob  # noqa: E402
import shutil  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from test_torch_multiproc import (collect, free_port, spawn,  # noqa: E402
                                  spawn_pair)

C, GAMMA, EPS, Q = "5", "0.1", "0.001", "16"
STOP_AT = "300"


def _train_argv(data, model, *extra):
    return ["train", "-f", data, "-m", model, "-c", C, "-g", GAMMA, "-e",
            EPS, "--engine", "block", "--working-set-size", Q, "--backend",
            "mesh", "--device", "cpu", "-q", *extra]


def _job(tmp, data, model, *extra) -> list:
    """Two processes of one `cli train` job: [(exit code, output)]."""
    addr = f"127.0.0.1:{free_port()}"
    argvs = [[sys.executable, "-m", "dpsvm_tpu_torch.cli",
              *_train_argv(data, model, "--num-devices", "2", *extra),
              "--coordinator-address", addr, "--num-processes", "2",
              "--process-id", str(k)] for k in range(2)]
    runs = spawn_pair(argvs, cwd=tmp)
    for rc, out in runs:
        assert rc == 0, out[-4000:]
    return runs


def _one_process(tmp, data, model, *extra) -> str:
    """The one-process twin through cli.main: its printed output."""
    import contextlib
    import io

    from dpsvm_tpu_torch import cli

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            assert cli.main(_train_argv(data, os.path.join(tmp, model),
                                        "--num-devices", "4", *extra)) == 0
    finally:
        torch.set_num_threads(before)
    return out.getvalue()


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The full job (with --obs), the job stopped at --max-iter and the
    job resumed from its checkpoint."""
    from dpsvm_tpu_torch.data import make_blobs_binary, save_csv

    tmp = str(tmp_path_factory.mktemp("multiproc_cli"))
    x, y = make_blobs_binary(n=160, d=8, seed=3, sep=1.2)
    data = os.path.join(tmp, "train.csv")
    save_csv(data, x, y)
    ckpt = os.path.join(tmp, "ckpt.npz")
    full = _job(tmp, data, "job.npz", "--obs", "--obs-dir",
                os.path.join(tmp, "obs"))
    stop = _job(tmp, data, "stop.npz", "--max-iter", STOP_AT,
                "--checkpoint", ckpt, "--checkpoint-every", "1",
                "--chunk-iters", "64")
    shutil.copyfile(ckpt, os.path.join(tmp, "ckpt_stop.npz"))
    resumed = _job(tmp, data, "resumed.npz", "--checkpoint", ckpt,
                   "--resume")
    return dict(tmp=tmp, data=data, full=full, stop=stop, resumed=resumed)


def _model(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _same_model(a, b) -> bool:
    return a.keys() == b.keys() and all(
        a[k].tobytes() == b[k].tobytes() for k in a)


def test_job_writes_one_model_equal_to_one_process(job):
    tmp = job["tmp"]
    outs = [out for _, out in job["full"]]
    assert "model written to job.npz\n" in outs[0]
    assert "model written to job.npz by process 0" in outs[1]
    for out in outs:
        assert "gloo process group" in out
        assert "cross-process exchange:" in out
    _one_process(tmp, job["data"], "single.npz")
    assert _same_model(_model(os.path.join(tmp, "job.npz")),
                       _model(os.path.join(tmp, "single.npz")))


def test_job_writes_one_run_log_from_process_0(job):
    logs = glob.glob(os.path.join(job["tmp"], "obs", "*.jsonl"))
    assert len(logs) == 1, logs
    with open(logs[0]) as fh:
        manifest = json.loads(fh.readline())
    assert manifest["kind"] == "manifest"
    assert (manifest["process_count"], manifest["process_index"]) == (2, 0)
    assert manifest["n_devices"] == 4
    assert manifest["mesh_devices"] == [
        f"cpu (process {p})" for p in (0, 0, 1, 1)]


def test_retry_faults_warned_once_a_process(job):
    for _, out in job["full"]:
        assert out.count("retry_faults=2 is disabled on this 2-process "
                         "job") == 1
        assert "--resume" in out


@pytest.mark.parametrize("k", [0, 1])
def test_stopped_job_resumes_like_one_process(job, k, tmp_path):
    """The job stopped at --max-iter left a process-0 checkpoint at that
    pair count; relaunched with --resume it converges, and its model is
    the one-process resume of the same file, bit for bit. Both processes
    report the same solve."""
    from dpsvm_tpu_torch.utils.checkpoint import load_checkpoint_state

    tmp = job["tmp"]
    stop_out = job["stop"][k][1]
    assert f"stopped at max-iter {STOP_AT} without converging" in stop_out
    st = load_checkpoint_state(os.path.join(tmp, "ckpt_stop.npz"))
    assert st.iteration == int(STOP_AT)
    out = job["resumed"][k][1]
    assert "converged at iteration" in out
    twin_ckpt = str(tmp_path / "ckpt.npz")
    shutil.copyfile(os.path.join(tmp, "ckpt_stop.npz"), twin_ckpt)
    _one_process(str(tmp_path), job["data"], "single.npz", "--checkpoint",
                 twin_ckpt, "--resume")
    assert _same_model(_model(os.path.join(tmp, "resumed.npz")),
                       _model(str(tmp_path / "single.npz")))


@pytest.mark.parametrize("extra,why", [
    (["--backend", "single"], "--backend single runs in one process"),
])
def test_cli_refuses_what_stays_in_one_process(tmp_path, capsys, extra, why):
    """Refused before any process group is made (no peer is needed)."""
    from dpsvm_tpu_torch import cli

    argv = ["train", "-f", "absent.csv", "-m", "m.npz", "--device", "cpu",
            "--coordinator-address", "127.0.0.1:1", "--num-processes", "2",
            "--process-id", "0", *extra]
    assert cli.main(argv) == 2
    assert why in capsys.readouterr().err


# ---------------------------------------------------------------------
# The other paths of `train` as jobs: name -> (data file, the flags,
# the model file, the score lines process 0 prints).
LEGS = {
    "cv": ("train.csv", ["-v", "3"], None,
           ("Cross Validation Accuracy",)),
    "probability": ("train.csv", ["-b", "1"], "prob.npz",
                    ("train accuracy", "platt calibration")),
    "precomputed": ("gram.csv", ["--kernel", "precomputed"], "pre.npz",
                    ("train accuracy",)),
    "multiclass": ("mc.csv", ["--multiclass", "ovr"], "mc.npz",
                   ("train accuracy",)),
    "ooc": ("train.csv", ["--ooc", "--ooc-tile-rows", "24"], "ooc.npz",
            ("train accuracy",)),
}


def _lines(out: str, prefixes) -> list:
    return [ln for ln in out.splitlines() if ln.startswith(tuple(prefixes))]


def _leg_outputs(out: str) -> dict:
    """A child's output cut at the leg markers: name -> its lines."""
    legs, name = {}, None
    for line in out.splitlines(keepends=True):
        if line.startswith(LEG_MARK):
            name = None if " exit " in line else line[len(LEG_MARK):].strip()
            if name is not None:
                legs[name] = ""
        elif name is not None:
            legs[name] += line
    return legs


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    """Every LEGS job run by one spawn of two children (their outputs
    per leg), and each leg's one-process twin, run here meanwhile."""
    from dpsvm_tpu_torch.data import make_blobs_binary, save_csv
    from dpsvm_tpu_torch.ops.kernels import KernelParams, kernel_matrix

    tmp = str(tmp_path_factory.mktemp("multiproc_cli_legs"))
    x, y = make_blobs_binary(n=160, d=8, seed=3, sep=1.2)
    save_csv(os.path.join(tmp, "train.csv"), x, y)
    xt = torch.as_tensor(x)
    save_csv(os.path.join(tmp, "gram.csv"),
             kernel_matrix(xt, xt, KernelParams("rbf", float(GAMMA))).numpy(),
             y)
    rng = np.random.default_rng(5)
    label = np.arange(150) % 3
    xm = (2.0 * rng.normal(size=(3, 8))[label]
          + rng.normal(size=(150, 8))).astype(np.float32)
    save_csv(os.path.join(tmp, "mc.csv"), xm, label)
    spec = [(name, _train_argv(os.path.join(tmp, data),
                               os.path.join(tmp, model or f"{name}.npz"),
                               "--num-devices", "2", *flags), free_port())
            for name, (data, flags, model, _) in LEGS.items()]
    procs = spawn([[sys.executable, os.path.abspath(__file__), "--child",
                    str(k), json.dumps(spec)] for k in range(2)], cwd=tmp)
    twin_dir = os.path.join(tmp, "twin")
    os.makedirs(twin_dir)
    try:
        twins = {name: _one_process(twin_dir, os.path.join(tmp, data),
                                    model or f"{name}.npz", *flags)
                 for name, (data, flags, model, _) in LEGS.items()}
    finally:
        runs = collect(procs)
    for rc, out in runs:
        assert rc == 0, out[-4000:]
    return tmp, [_leg_outputs(out) for _, out in runs], twins


@pytest.mark.parametrize("name", sorted(LEGS))
def test_job_path_bitwise_one_process(legs, name):
    """The job's model file (process 0's) and process 0's score lines
    are the one-process twin's, bit for bit; process 1 prints no score
    and names process 0 as the writer."""
    tmp, outs, twins = legs
    _, _, model, scores = LEGS[name]
    want = _lines(twins[name], scores)
    assert len(want) == len(scores), twins[name]
    assert _lines(outs[0][name], scores) == want, outs[0][name]
    assert _lines(outs[1][name], scores) == []
    for out in outs:
        assert "gloo process group" in out[name]
    if model is None:  # -v writes no model
        assert not os.path.exists(os.path.join(tmp, f"{name}.npz"))
        return
    assert f"model written to {os.path.join(tmp, model)}\n" in outs[0][name]
    assert "by process 0" in outs[1][name]
    assert _same_model(_model(os.path.join(tmp, model)),
                       _model(os.path.join(tmp, "twin", model)))
