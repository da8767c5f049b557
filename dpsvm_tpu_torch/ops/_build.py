"""Build the port's CUDA kernels with nvcc at first use and load them
with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its
own into ``build/torch_kernels/lib<name>-<hash>.so`` at the root of the
checkout (a directory .gitignore lists), for ``sm_90a``. The hash covers
the source, the shared headers ``csrc/*.cuh`` and the flags, so an
edited kernel is rebuilt and a finished build is reused. Nothing here
runs at import time: the CPU tests import every module, and a machine
without the CUDA toolkit has no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")

# -fmad=false: no a+b*c contraction, so each expression rounds per
# operation as torch's elementwise ops and the JAX package do. No fast
# math: IEEE division and square roots.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _flags(defines) -> list:
    return [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]


def _lib_path(name: str, defines=()) -> str:
    digest = hashlib.sha256(" ".join(_flags(defines)).encode())
    # The source and every shared header (csrc/*.cuh) it may include.
    for fname in [f"{name}.cu"] + sorted(
            f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh")):
        with open(os.path.join(CSRC_DIR, fname), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names, defines=()) -> dict:
    """Compile every named source not built yet, one nvcc process each,
    all started together, with the macros `defines` (e.g. DPSVM_STAMPS:
    csrc/fold_select.cu's timing stamps) set. Returns {name: ptxas
    report}; raises RuntimeError with the compiler's output when a build
    fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name, defines)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *_flags(defines), "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str, defines=()) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu built with the macros
    `defines`, built first if needed."""
    key = (name, tuple(defines))
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            build([name], defines)
            lib = ctypes.CDLL(_lib_path(name, defines))
            _libs[key] = lib
        return lib
