"""Run one cell of the benchmark on the CUDA card and print its result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell, its configuration, its traffic
mix, its metrics and its limits are found by name from BENCHMARK.json
and the files under benchmark/ (lib/cells.py). Set-up makes the inputs
from the seed on the card, builds or loads the port's kernels (into
build/torch_kernels/ of the checkout; the library caches the run points
into build/bench_cache/) and warms the cell's shapes; then the window
runs for --seconds. --trace 0 prints the cell's end-to-end metrics,
--trace 1 its per-layer metrics, read from a profiled slice of the
window and from the rest of it. After the window the outputs are judged
against the plain reference (reference/); each number compared is
printed beside its limit, on standard error and as the result's last
key. The last line of standard output is the result, one JSON object.

Exits 3, printing no result, without a CUDA card (there is no CPU
fallback), and 4 when the JAX package or JAX is loaded in the process
once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.lib import cells  # noqa: E402
from benchmark.lib.trace import Slice  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "dpsvm_tpu")
HOST_THREADS = 4


def cache_env(root: str) -> None:
    """Every build and kernel cache in fixed directories of the checkout
    (only a checkout's first run builds), and the program's observation
    left at its default, off."""
    cache = os.path.join(root, "build", "bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)
    for var in ("DPSVM_OBS", "DPSVM_OBS_DIR", "DPSVM_TRACE_DIR",
                "DPSVM_AUTOTUNE_PROFILE", "DPSVM_AUTOTUNE_DIR"):
        os.environ.pop(var, None)
    os.environ.setdefault("OMP_NUM_THREADS", str(HOST_THREADS))
    os.environ["USE_FLAX"] = "0"


def banned_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (dpsvm_tpu_torch is not dpsvm_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def measure(cell, seed: int, seconds: float, trace: bool, device,
            svm_overrides=None, t_start: float = None) -> tuple:
    """Set up, run the window, read the peak, release the program and
    judge its outputs. Returns (run, checks)."""
    import torch

    drv = cell.driver
    t0 = T_START if t_start is None else t_start
    if trace:
        with Slice():  # the profiler's first start, outside the window
            pass
    state = drv.setup(cell, seed, device, svm_overrides)
    run = drv.window(state, seconds, trace)
    run["setup_s"] = run["t0"] - t0
    run["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if torch.cuda.is_available() else 0)
    drv.close(state)  # the program's live objects; its outputs stay
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    try:
        checks = drv.check(state, run)
    finally:
        state.clear()
    return run, checks


def read_metrics(cell, run: dict, trace: bool) -> dict:
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cells.reader(m["name"], cell.bench_dir)(run)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def result_line(cell, run: dict, checks: list, trace: bool, kind: str,
                power: str) -> dict:
    correct = bool(checks) and all(v <= lim for _, v, lim in checks)
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": int(run["memory_peak_bytes"])}
    line = {"correct": correct, "attempted": int(run_attempted(run)),
            "failed": int(run_failed(run)),
            "metrics": read_metrics(cell, run, trace), "device": device}
    sl = run.get("slice")
    if trace and sl is not None:
        device["busy_s"] = sl["busy_s"]
        device["window_s"] = sl["window_s"]
        line["breakdown"] = {"device_ops": sl["device_ops"],
                             "idle_gaps": sl["idle_gaps"]}
    line["card"] = power
    line["checks"] = {nm: {"value": _num(v), "limit": _num(lim)}
                      for nm, v, lim in checks}
    return line


def _num(v: float):
    """A number as JSON holds it; inf and nan as their names."""
    return v if math.isfinite(v) else repr(float(v))


def run_attempted(run: dict) -> int:
    return run["attempted"] if "attempted" in run else len(run["jobs"])


def run_failed(run: dict) -> int:
    if "failed" in run:
        return run["failed"]
    return sum(1 for j in run["jobs"] if not j["ok"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env(ROOT)
    cell = cells.find_cell(ROOT, args.workload)
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " (no CPU fallback)", file=sys.stderr)
        return 3
    torch.set_num_threads(HOST_THREADS)
    run, checks = measure(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda")
    found = banned_modules()
    if found:
        print(f"benchmark: loaded in the measuring process: {found}",
              file=sys.stderr)
        return 4
    line = result_line(cell, run, checks, bool(args.trace),
                       torch.cuda.get_device_name(0), card())
    for nm, v, lim in checks:
        print(f"check {nm} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
