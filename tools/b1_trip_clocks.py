#!/usr/bin/env python3
"""Where a trip of kernel B1 (csrc/subproblem.cu) spends its cycles.

    python3 tools/b1_trip_clocks.py

Needs the CUDA card and nvcc. Builds a copy of csrc/subproblem.cu into
build/b1_clocks/ in which thread 0 reads clock64() at the phase
boundaries of every trip (the slots' candidates and the warps' winners,
the posts and the barrier, the reduction of the posted records, issuing
the rows and k_ij, the pair update that consumes them, the f update) and
sums the cycles a phase; one warp has no barrier and no records, so
those phases read (nearly) 0. Then solves real working sets (blobs, rbf,
select_block's W, as tests/test_torch_cuda.py does) at q = 128, 256 and
512, rules mvp and nu, with each launch variant forced: the plan's, the
same with no rows of K(W, W) on chip, and the plan's rows on chip with
each other count of slots a thread (1, 2 or 4). Prints cycles a trip by
phase beside the event-timed us a trip of one call. The stamps cost a
few cycles each, so the sum exceeds the uninstrumented trip a little;
the split is what this tool is for.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from dpsvm_tpu_torch.data.synth import make_blobs_binary  # noqa: E402
from dpsvm_tpu_torch.ops import _build  # noqa: E402
from dpsvm_tpu_torch.ops import subproblem as tsub  # noqa: E402
from dpsvm_tpu_torch.ops.kernels import (KernelParams,  # noqa: E402
                                         kernel_matrix)
from dpsvm_tpu_torch.solver.block import select_block  # noqa: E402

PHASES = ("loop", "candidates and warp winners", "posts and barrier",
          "records", "rows issued", "update (waits on rows)", "f update")
# (anchor in csrc/subproblem.cu, stamp number, inserted before the anchor
# (True) or after it (False)). An anchor may occur in each rule's branch;
# every occurrence gets the stamp.
STAMPS = (
    ("    Rec* rb = red + par * kSides * kMaxWarps;\n", 0, False),
    ("      if (nwarps > 1) {\n        post(up, rb + kUp", 1, True),
    ("        __syncthreads();\n        up = gather<true, S>(rb + kUp", 2,
     "after_sync"),
    ("    const float b_hi = up.v;\n", 3, True),
    ("    const int j = jc.i;\n    const float b_lo = jc.f;\n", 4, True),
    ("    const float di = (ai - a_i_old) * y_i;\n", 5, True),
    ("    ++t;\n\n    // ---- pair_batch", 6, "after_inc"),
)
HEADER = """
__device__ unsigned long long dpsvm_b1_clk[8];
#define B1_STAMP(n) if (threadIdx.x == 0) { \\
  const long long now_ = clock64(); clk_acc[n] += now_ - clk_last; \\
  clk_last = now_; if (n == 0) ++clk_trips; }
"""
READER = """
extern "C" int dpsvm_b1_clocks(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, dpsvm_b1_clk, sizeof(dpsvm_b1_clk));
}
"""


def instrumented_source() -> str:
    with open(os.path.join(_build.CSRC_DIR, "subproblem.cu")) as fh:
        src = fh.read()
    src = src.replace("namespace {\n", HEADER + "namespace {\n", 1)
    decl = "  int t = 0;\n  int par = 0;\n"
    assert decl in src
    src = src.replace(decl, decl + "  long long clk_acc[7] = {0}, "
                      "clk_last = clock64(), clk_trips = 0;\n", 1)
    for anchor, n, where in STAMPS:
        assert anchor in src, anchor
        stamp = f"    B1_STAMP({n});\n"
        if where is True:
            src = src.replace(anchor, stamp + anchor)
        elif where == "after_sync":
            head = "        __syncthreads();\n"
            src = src.replace(anchor, head + stamp + anchor[len(head):])
        elif where == "after_inc":
            head = "    ++t;\n"
            src = src.replace(anchor, head + stamp + anchor[len(head):])
        else:
            src = src.replace(anchor, anchor + stamp)
    tail = "  if (tid == 0) *t_out = t;\n"
    assert tail in src
    src = src.replace(tail, tail + (
        "  if (tid == 0) {\n"
        "    for (int n = 0; n < 7; ++n) dpsvm_b1_clk[n] = clk_acc[n];\n"
        "    dpsvm_b1_clk[7] = clk_trips;\n  }\n"))
    return src + READER


def build() -> ctypes.CDLL:
    out_dir = os.path.join(os.path.dirname(_build.BUILD_DIR), "b1_clocks")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, "subproblem_clocks.cu")
    with open(cu, "w") as fh:
        fh.write(instrumented_source())
    so = os.path.join(out_dir, "libsubproblem_clocks.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    _build.CSRC_DIR, "-o", so, cu], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(so)
    lib.dpsvm_subproblem.restype = ctypes.c_int
    lib.dpsvm_subproblem.argtypes = ([ctypes.c_void_p] * 9
                                     + [ctypes.c_int] * 7
                                     + [ctypes.c_float] * 8
                                     + [ctypes.c_void_p])
    lib.dpsvm_b1_clocks.argtypes = [ctypes.c_void_p]
    return lib


def working_set(dev, q: int, rule: str):
    x, y = make_blobs_binary(n=4000, d=10, seed=3, sep=1.2)
    rng = np.random.default_rng(0)
    alpha = np.clip(rng.normal(0.5, 0.5, len(y)), 0, 1.0).astype(np.float32)
    xt = torch.as_tensor(x, device=dev)
    K = kernel_matrix(xt, xt, KernelParams("rbf", 0.2))
    yt = torch.as_tensor(y.astype(np.float32), device=dev)
    at = torch.as_tensor(alpha, device=dev)
    f = (at * yt) @ K - yt
    w, ok, _, _ = select_block(f, at, yt, 1.0, q,
                               rule="nu" if rule == "nu" else "mvp")
    return (K[w][:, w].contiguous(), at[w].contiguous(),
            yt[w].contiguous(), f[w].contiguous(),
            torch.diagonal(K)[w].contiguous(), ok.float())


def variants(q: int):
    """The plan, the plan with no rows on chip, and the plan's rows on chip
    with each other count of slots a thread (1, 2 or 4)."""
    plan = tsub.subproblem_plan(q)
    out = [plan, plan._replace(nchip=0, smem=tsub._HEAD_BYTES + 8 * q)]
    for slots in (1, 2, 4):
        threads = -(-q // (32 * slots)) * 32
        if slots != plan.slots and threads <= 1024:
            out.append(plan._replace(threads=threads, slots=slots))
    return out


def run(lib, dev, q: int, rule: str, plan, limit: int = 512):
    kb, a0, yw, f0, kd, ok = working_set(dev, q, rule)
    consts = [float(v) for v in (*tsub._box_consts(1.0),
                                 np.float32(2.0 * 1e-3), np.float32(1e-12))]
    lim = torch.tensor(limit, dtype=torch.int32, device=dev)
    a_out = torch.empty_like(a0)
    t_out = torch.empty((), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call():
        err = lib.dpsvm_subproblem(
            kb.data_ptr(), a0.data_ptr(), yw.data_ptr(), f0.data_ptr(),
            kd.data_ptr(), ok.data_ptr(), lim.data_ptr(), a_out.data_ptr(),
            t_out.data_ptr(), q, tsub._RULES[rule], 1, plan.threads,
            plan.slots, plan.nchip, plan.smem, *consts, stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    call()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    call()
    e1.record()
    torch.cuda.synchronize()
    clk = (ctypes.c_ulonglong * 8)()
    assert lib.dpsvm_b1_clocks(ctypes.byref(clk)) == 0
    trips = max(int(clk[7]), 1)
    ms = e0.elapsed_time(e1)
    per = [clk[n] / trips for n in range(7)]
    print(f"[b1 clocks] q={q} {rule} {plan.threads} threads x "
          f"{plan.slots} slots, rows on chip {plan.nchip}: "
          f"pairs={int(t_out)} trips={trips} ms={ms:.4f} "
          f"us_per_trip={1e3 * ms / trips:.3f} cycles_per_trip="
          f"{sum(per):.0f} (" + ", ".join(
              f"{name} {v:.0f}" for name, v in zip(PHASES, per)) + ")",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("b1_trip_clocks: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[b1 clocks] {smi}", flush=True)
    lib = build()
    for q in (128, 256, 512):
        for rule in ("mvp", "nu"):
            for plan in variants(q):
                run(lib, dev, q, rule, plan)
    return 0


if __name__ == "__main__":
    sys.exit(main())
