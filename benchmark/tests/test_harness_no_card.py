"""Without a CUDA card a run fails and prints no result: there is no CPU
fallback."""

import os
import subprocess
import sys

from conftest import ROOT


def test_run_without_a_card_fails():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "mnist8m.block",
         "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 3
    assert proc.stdout.strip() == ""
    assert "no CPU fallback" in proc.stderr
