"""``cli train`` as a two-process job on the CPU (the JAX package's
multi-host flags: every process runs the same command with its own
--process-id; parallel/mesh.py initialize_multihost under it): one model,
written once by process 0 and equal to the one-process mesh's; a run log
from process 0 whose manifest reads process_count 2; a job stopped at
--max-iter and relaunched with --resume, bit for bit the one-process
resume of the same checkpoint; the one-time retry warning; the CLI's
refusals. Each process holds two CPU shards (--backend mesh
--num-devices 2 --device cpu); the one-process twins run four shards in
this process with the children's one torch thread."""

from __future__ import annotations

import glob
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from test_torch_multiproc import free_port, spawn_pair

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


def _one_process(tmp, data, model, *extra) -> None:
    from dpsvm_tpu_torch import cli

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert cli.main(_train_argv(data, os.path.join(tmp, model),
                                    "--num-devices", "4", *extra)) == 0
    finally:
        torch.set_num_threads(before)


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
    (["-v", "3"], "A.13c"),
    (["-b", "1"], "A.13c"),
    (["--kernel", "precomputed"], "A.13c"),
])
def test_cli_refuses_what_stays_in_one_process(tmp_path, capsys, extra, why):
    """Refused before any process group is made (no peer is needed)."""
    from dpsvm_tpu_torch import cli

    argv = ["train", "-f", "absent.csv", "-m", "m.npz", "--device", "cpu",
            "--coordinator-address", "127.0.0.1:1", "--num-processes", "2",
            "--process-id", "0", *extra]
    assert cli.main(argv) == 2
    assert why in capsys.readouterr().err
