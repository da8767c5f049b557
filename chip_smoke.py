#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (dpsvm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --turns [--package DIR] [--reps N]
    python3 chip_smoke.py --serve-profile

With no arguments it runs the phases below. --turns runs none of them: it
times kernels B5 and B6 at the headline shapes and B2 and B3 at the
headline's and covtype scale's rows on fixed seeded inputs, splits B2
and B3's time by the stamps of a timing build of csrc/fold_select.cu,
trains the headline with the fused fold and the pipelined engine, and
prints one JSON line (see turns()); --package DIR times the
dpsvm_tpu_torch found in DIR instead of this checkout's, so an earlier
commit unpacked there (git archive) and this one can be timed in turns on
one card. --serve-profile runs none of the phases either: it prints where
a serving dispatch spends its time (serve_profile).

Phases, each printed on its own lines; any failure exits non-zero and no
result line is printed:

  1. device  -- the card's name and power limit (nvidia-smi); no CUDA
                device is a failure;
  2. build   -- every kernel built from csrc/ with nvcc (subproblem.cu,
                fold_select.cu, gather_gram.cu, fused_update.cu, ring.cu;
                one nvcc each, in parallel), with each kernel's registers
                and static shared memory from ptxas; the SASS of B4 and of
                B8's fold (cuobjdump) must hold bf16 HMMAs for bfloat16 X
                and 3 x 2 times as many tf32 HMMAs for float32 X (3xTF32);
  3. headline -- the block-engine headline configuration (c=10,
                gamma=0.125, eps=0.01, q=256, bfloat16 X) on the 60000 x
                784 MNIST-shaped data, trained through dpsvm_tpu_torch.train
                with every launch count set to 0 just before: it must
                converge, and the subproblem kernel (B1) must have run once
                per outer round and no other kernel at all;
  4. kernels -- each kernel held against its plain PyTorch version on the
                card. B1 on working sets that select_block picks from the
                same data at the start point and at the headline's end
                state (q = 128 and 256, both selection rules, and mvp with
                pair_batch 2 and 4, which must be bitwise): same pair
                count, alpha within rtol 1e-6 / atol 1e-7; each line
                names the launch plan (threads, slots a thread, rows of
                K(W, W) on chip), whether alpha is bitwise, and us a pair
                and a trip. B2-B5 on a real
                round's inputs at the headline shapes (n_pad 60416, q 256)
                at the same two states, for float32 and bfloat16 X and
                compensation off/on: B2 (fold_select) and B3 (select_rows)
                bitwise, and again on seeded views at covtype scale (R
                3912) for both forms of c; B5 (fold_rows_select) f'
                within rtol 1e-6 plus 2e-6 of the contraction's
                absolute sum, candidates bitwise
                those the plain emission gives from the kernel's own f';
                B4 (gather_gram) max |dK| within the dots' worst-case
                rounding bound (ops/round.py gram_tolerance) and, for
                float32 X, its error against the float64 Gram within 4x
                the plain version's own plus the 3xTF32 product error
                (ops/round.py tf32x3_check: one-pass TF32 fails it). Times of
                kernel, plain version and, for B4, the library product,
                with L2 flushed before every launch (every timed call is
                queued behind a device-side spin, so the host's enqueue
                time is not counted), B4's TFLOP/s and the
                earlier CUDA-core design's time beside them; beside B2, B3
                and B5 the same timer's reading of an empty launch
                (launch_floor_ms), and beside B5 its launch plan, its
                earlier design's time and cuBLAS's torch.mv over the same
                kernel rows (contraction_ms: the contraction alone, not
                B5's function, so B5's library_ms stays none);
                then the headline solved once more with the round loop's
                four stage functions timed by CUDA events;
  5. engines -- the headline trained with fused_fold=True,
                fused_round=True and pipeline_rounds=True, each with every
                count set to 0 just before: converged, and launches exactly
                B1 = B2 = rounds (fused fold), B1 = B4 = B5 = rounds (fused
                round), B1 = rounds and B3 = rounds + 1 (pipelined: one
                prefetch per round plus the seed); then each of the three
                engines once more with its stage functions timed;
  6. perpair -- the per-pair engines on the headline data and
                hyper-parameters, after warm-ups on 16384 rows, each with
                every count set to 0 just before: engine="xla" (on the
                resident Gram, which auto turns on at this size), "xla"
                with the row cache (gram_resident=False, cache_lines=512),
                "xla" with pair_batch=8, "xla" with second_order, and
                "pallas": converged; no kernel launched but B6 on
                "pallas", once per pair update. Then the xla and pallas
                runs once more with the host time of their stages;
  7. b6      -- kernel B6 against its plain version at the padded shape
                (n_pad 65536) on the dot rows of a real pair at the start
                point and at the per-pair headline's end state, rbf and
                linear: f' within 2 ulps of the update's scale, extrema
                and ids exactly those the plain reduction gives from the
                kernel's own f'; kernel and plain times with L2 flushed,
                beside the timer's launch floor, the launch plan and the
                earlier design's time;
  8. ring    -- kernels B7 and B8 on logical shards of the card. B7
                (ring_gather) at P = 2, 4, 8 on seeded (256, 792) blocks:
                every rank's output bitwise torch.stack(blocks), twice in a
                row (one ordinary launch, no flags). B8 (ring_fold_window)
                at P = 2, 4 and R = 1, 2 with q = 256, d = 784, n_loc =
                60000 / P, X in bfloat16 and float32, rbf and linear,
                plain and compensated, on the windows real local rounds produce from
                a mid-solve state: the gathered windows bitwise the stack,
                f' (less err') held against the fold carried in float64:
                off it by no more than rtol 1e-6 plus 2e-6 of the
                contraction's absolute sum plus 4 times the largest error
                of the float32 plain version against the same yardstick; a
                window of zero coefs leaves f bitwise. Both timed with L2
                flushed, beside the plain version and the library calls
                (B8 with its TFLOP/s and the earlier design's time);
  9. mesh    -- the headline on Mesh([cuda:0] * 4), four logical shards of
                the card, each run with every count set to 0 just before:
                (a) the global runner with ring_exchange=False, (b) with
                ring_exchange=True (B1 and B7 once a round),
                (c) local_working_sets=4, sync_rounds=2, ring_exchange=True
                (B1 per shard per local round, B8 once a sync, then the
                demotion to the global runner). Each converges; (a) and
                (b) take the same pairs and rounds and give bitwise the
                same alpha; the launch counts are those the loops derive;
 10. mesh oracle -- run (b) at the oracle configuration: the oracle
                contract of phase 11;
 11. oracle  -- float32 at eps=5e-4 against the committed LibSVM oracle
                (artifacts/oracle60k.{json,npz}), with the plain engine,
                fused_round=True, engine="xla" and engine="pallas":
                converged, SV count within 3% of the oracle's,
                decision-sign agreement >= 99.8%; the plain model saved as
                .txt and .npz and reloaded decides the same;
 12. nu      -- nu-SVC (train_nusvc, nu = 0.1) on the same data at full
                size. (a) The headline (bf16 X, eps 0.01, q 256) with
                fused_round=True asked: the fallback warning, converged,
                B1 once a round and no other kernel. Then kernel B1's nu
                rule (per-class extrema, the class by the float32
                violation test) on working sets select_block(rule="nu")
                picks from (a)'s warm start and end state, q = 128 and
                256: the same pairs and bitwise its plain version's
                alpha, timed beside it. (b) The oracle configuration
                (float32, eps 5e-4) on the block engine and
                engine="xla" against artifacts/oracle_nu60k (LibSVM
                NuSVC at tol 1e-3): converged, SV count within 3%, signs
                >= 99.8%; the block model's .npz reload decides the same;
 13. oneclass -- train_oneclass (nu 0.1, float32, eps 0.01) at full size
                on the plain block engine and with fused_round=True (B1 =
                B4 = B5 = rounds, from a warm start padded to 60416):
                converged, sum(alpha) = nu n within 1e-4, inlier fraction
                >= 1 - nu - 0.01, SV fraction >= nu - 0.01, and the
                engines' signs agreeing on >= 99.8% of the rows whose
                |g| > eps in both (the free SVs sit on the boundary);
 14. svr     -- train_svr (tube 0.1) and train_nusvr (nu 0.4) on the first
                10000 rows (a depth cut: 20000 duals) against a seeded
                smooth target (svr_target), each on the block engine (B1
                once a round) and engine="xla" (no kernel): converged,
                sum(a) - sum(a*) = 0 within 1e-4 C n, and the engines'
                predictions within 0.1 of each other.
 15. cli     -- the headline through dpsvm_tpu_torch.cli.main: written as
                a CSV file and as a LIBSVM file of the same 60000 rows
                (write times and sizes printed), each trained with
                --format auto (the CLI's parse time printed; the native
                CSV parser must load): the same pairs and rounds as the
                API headline, B1 once a round and nothing else, the model
                file bitwise the API model; each model tested with -o at
                --precision float32 and float64 on the first 10000 rows:
                the labels are the API model's decision signs;
 16. state   -- the plain headline observed in >= 8 chunks (bitwise the
                unobserved run; both train_seconds printed), stopped by a
                callback after chunk 3 with a checkpoint every chunk (two
                generations) and resumed from the file: bitwise the
                uninterrupted observed run; fused_fold (B1 = B2 =
                rounds), pipeline_rounds (B1 = rounds, B3 = rounds +
                chunks), fused_round (B1 = B4 = B5 = rounds) and pallas
                (B6 a pair) at the oracle configuration, chunked, stopped
                and resumed: the oracle contract; mesh (b) (B1 = B7 = rounds) resumed from the
                one-device checkpoint: n_sv and signs within the oracle
                tolerances of the one-device headline;
 17. reconstruct -- the covtype stress configuration (c = 2048, gamma =
                0.03125, Kahan carry) on make_covtype_like's first 2000
                rows in float64 reconstruction legs on the block engine
                (B1) and engine="xla": certified true gap <= 2 eps,
                matched by an independent float64 gradient of the
                returned alpha;
 18. bf16_gram -- the headline in float32 with bf16_gram=True: the gate's
                decision printed; accepted, the solve is bitwise the
                bfloat16 headline (B1 once a round) and within the
                whole-solve contract of the float32 solve.
 19. multiclass -- make_mnist_multiclass (the headline's features, 10
                classes), rows 0-49999 trained, 50000-59999 held out:
                the fleet's CUDA graph bitwise its eager trips; OvR on
                the plain block engine (q 256, bf16 X; B1 once a round),
                OvR on the fused round (B1 = B4 = B5 = rounds), OvO (45
                submodels) on the plain block engine, and OvR and OvO
                through the fleet (engine xla, fleet_size 16; no kernel;
                trips and host reads printed): every submodel converged,
                n_sv, train_seconds, predict seconds, held-out accuracy,
                the .npz bundle reloaded predicting the same labels; each
                fleet's held-out labels >= 99.8% its block run's; each
                fleet submodel within the whole-solve contract (dual
                rel 1e-4, n_sv 2%, |db| 5e-3) of its sequential twin;
 20. multiclass oracle -- OvO on the first 10000 rows (float32, eps
                0.005) against artifacts/oracle_multiclass10k.json: the
                SV union within 3% of its n_sv, train accuracy >= its
                acc less 0.002;
 21. precomputed -- the RBF Gram of the headline's first 30000 rows,
                built on the card and handed over from the host, trained
                with kernel="precomputed" on the block engine (B1) and
                xla, each against the RBF solve of the same rows on its
                engine (n_sv 3%, signs 99.8%; the .npz reload decides
                bit for bit); then gram_resident=True on the block
                engine on the full headline against the plain headline;
 22. platt   -- the headline trained with -b 1 through cli.main (prob_a
                > 0 and finite), tested with -b 1 (probabilities in [0,
                1], monotone in the decision); an OvR
                SVC(probability=True) on 10000 multiclass rows
                (predict_proba rows sum to 1 within 1e-6);
 23. estimators -- SVC, NuSVC, SVR, NuSVR, OneClassSVM on the first
                10000 rows: each model its trainer's bit for bit (SVR and
                NuSVR: the [svr] phase's models); svc_c_sweep over four
                Cs as one fleet;
 24. cli multiclass -- the first 20000 multiclass rows as CSV: `train
                --multiclass ovo` and `test` (labels = the API's); `train
                -v 5`; `train --kernel precomputed` / `test` on a
                2000-row Gram CSV (labels = the API's).
 25. serve   -- the OvR and OvO models of [multiclass] and the headline
                model served on the card (phase_serve): PredictServer on
                the OvO model with f32, bf16, int8 and auto unions
                against decision_matrix on the 10000 held-out rows (f32
                within rtol / atol 1e-5, labels equal but on rows with a
                |dec| <= 1e-4, counted; bf16 and int8 labels >= 99.8% the
                f32 ones), the guard's storage and risks, dispatch ms at
                buckets 256 and 4096 beside the bound; the headline's f32
                server against decision_function; offered_load_sweep
                (request rows 1-1024, groups of 8, 2000 requests) per
                storage; ServingEngine with both bundles hot-swapped from
                an admin thread under load (nothing lost, versions 1 and
                2 served) and the dispatch watchdog through the
                serve_stall seam; ServeServer over a ReplicaFleet of 2 on
                127.0.0.1 answering 500 ServeClient requests (all served,
                labels and decisions the in-process engine's); union
                bytes per storage. No kernel of B1-B8 runs in it.
 26. ooc     -- X on the host (solver/ooc.py), OOC_TILE-row tiles: (a) the
                headline with ooc=True against the in-core headline (SV
                count 3%, signs 99.8% on all rows; B1 once a round; alpha
                bitwise or not, reported); (b) the oracle configuration
                against artifacts/oracle60k; (c) ooc_shrink=True and
                ooc_cache_lines=512 meet the stopping rule (tiles
                skipped, reconstructions, all-hit rounds); (d) a memmap X
                stopped after 3 rounds and resumed, bitwise (a); (e) one
                warm_f_rebuild pass over a 500000 x 784 float32 memmap
                (rtol 1e-5 of blocked_kernel_matvec; GB/s against a
                pinned 256 MiB copy_, the fold's share of the pass).
 27. warm    -- rows 0-49999, then concat(sv_x, rows 50000-59999) warm
                (seed_from_model) and cold under gate (a); cascade_solve
                of it (16384-row blocks); svc_c_sweep(warm=True) on the
                block engine against [estimators]' fleet sweep; run_learn
                on synthetic_stream(d=784, rows=20000, generations=3),
                hot-swapped into a ServingEngine, every probe served;
                `cli learn --smoke`; `cli train --ooc` on [cli]'s CSV
                under gate (a).

 28. mesh (d)-(g) -- beside [mesh] (a)-(c), each after a warm-up on
                16384 rows and with every count set to 0 just before:
                (d) pipeline_rounds=True, ring_exchange=True (B1 once a
                round, B7 once a prefetch: rounds + chunks), (e)
                fused_fold=True on two logical shards (q = 256 needs
                n_loc >= 16384; B1 once a round, B2 once a shard and
                round), (f) active_set_size=2048 (B1 once an inner
                round), (g) engine="xla" (no kernel): converged, gate (a)
                of [ooc] against the plain headline (SV count 3%, signs
                99.8% on all rows; for (f) the SV count is reported and
                gated at the oracle's eps in [mesh oracle]; (g) is gated
                against phase 6's one-device per-pair run, its twin, and
                reported against the block headline); then fused_round=True with the fused
                fold: its warning, and (e)'s launches;
 29. active  -- the one-device headline with active_set_size=2048: its
                warning, B1 once an inner round, signs at 99.8% of the
                plain headline's (the SV count reported: at eps 0.01 the
                active cycles keep more small-alpha SVs, as (f) does);
                the oracle configuration with the same m against
                artifacts/oracle60k;
 30. mesh oracle -- (f) at the oracle configuration against
                artifacts/oracle60k (the oracle contract);
 31. mesh nu -- train_nusvc (nu 0.1) at NU_ORACLE on the mesh (B1, its
                nu rule, once a round) against artifacts/oracle_nu60k;
 32. mesh warm -- [warm]'s increment at the oracle's eps, warm on the
                mesh (the mesh rebuild) under gate (a) against the
                one-device warm solve;
 33. mesh state -- (c) observed, stopped after its second chunk with a
                file every chunk and resumed in a fresh call (launches
                derived from the resumed call's rounds and syncs), gate
                (a); [reconstruct]'s covtype stress in block legs on the
                mesh: certified, gate (a) against the one-device legs;
 34. mesh predict -- decision_function_mesh of the headline model on
                rows 50000-59999 within rtol / atol 1e-5 of
                decision_function; ms per 8192-row block;
 35. cli smoke -- `cli smoke --num-devices 4` exits 0.

The second-to-last lines are the per-kernel JSON record (with each
kernel's launches on phases 15-35 under "path_launches") and the card's
name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM dense bf16 on the tensor cores
TF32_FLOPS = 495e12  # H100 SXM dense TF32 (3xTF32 does three products a term)
# The ms of the earlier designs of the redesigned kernels (PERF.md section
# 6, "earlier"; B5 and B6 from run G, B2 and B3 from run I), printed beside
# the new kernels' times.
EARLIER_MS = {("gather_gram", "bfloat16"): 1.3175,
              ("gather_gram", "float32"): 1.3688,
              ("ring_fold_window", "bfloat16"): 4.3508,
              ("ring_fold_window", "float32"): 4.6576,
              ("ring_gather", 2): 0.0270,
              ("ring_gather", 4): 0.0683,
              ("ring_gather", 8): 0.1334,
              ("fold_rows_select", 256): 0.0639,  # q 256, n_pad 60416
              ("fold_select", 472): 0.0074,  # run I, n_pad 60416
              ("select_rows", 472): 0.0071,
              ("fused_update_select", 65536): 0.0112}  # n_pad 65536
# B1's us a pair at q=256, limit 512, from the start state, before the
# redesign that keeps the Gram block on chip (PERF.md section 6).
EARLIER_US_PER_PAIR = {"mvp": 1.010, "nu": 1.434}
# Kernels whose products must run on the tensor cores: (source, kernel
# name in the SASS).
MMA_KERNELS = (("gather_gram", "gather_gram_kernel"),
               ("ring", "ring_fold_kernel"))
SOURCES = ("subproblem", "fold_select", "gather_gram", "fused_update",
           "ring")

HEADLINE = dict(c=10.0, gamma=0.125, epsilon=0.01, max_iter=150_000,
                engine="block", working_set_size=256, dtype="bfloat16")
ORACLE_RUN = dict(c=10.0, gamma=0.125, epsilon=5e-4, max_iter=2_000_000,
                  engine="block", working_set_size=256)
# Oracle runs, the plain engine last (its model is saved and reloaded).
ORACLE_ENGINES = (("fused_round", dict(fused_round=True)),
                  ("xla", dict(engine="xla")),
                  ("pallas", dict(engine="pallas")),
                  ("plain", {}))
SV_TOL = 0.03
SIGN_TOL = 0.998
RTOL, ATOL = 1e-6, 1e-7


# Cycles of a device-side spin queued ahead of the start event: long
# enough (~1 ms at the card's clock) that the host has enqueued the timed
# calls before the clock starts, so a slow host's enqueue time (a kernel
# wrapper's Python, tens of us) is not counted as the kernel's.
SPIN_CYCLES = 2_000_000


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over `reps` calls after one warm-up,
    between CUDA events, queued behind a device-side spin."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES * max(1, reps // 10))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def time_cold_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() between CUDA events, with a 256 MB
    write before every call so its inputs start out of the 50 MB L2, as
    they do inside a round that has just streamed X or the kernel rows;
    each call queued behind a device-side spin."""
    import torch

    flush = torch.empty(2 ** 26, dtype=torch.float32, device="cuda")
    fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        total += e0.elapsed_time(e1)
    return total / reps


def launch_floor_ms(reps: int) -> float:
    """time_cold_ms of an empty launch (torch.cuda._sleep(0)): what the
    timer reads for a kernel that does nothing behind the same flush."""
    import torch

    return time_cold_ms(lambda: torch.cuda._sleep(0), reps)


def bound(nbytes: float, flops: float, peak: float) -> tuple:
    """(least ms for the work, what bounds it): the bytes moved over the
    device memory rate against the operations over their peak rate."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / peak * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations")


def counters() -> dict:
    """Every kernel wrapper of the port by kernel name (B1-B8)."""
    from dpsvm_tpu_torch.ops import fold_select as fs
    from dpsvm_tpu_torch.ops import ring
    from dpsvm_tpu_torch.ops import round as rnd
    from dpsvm_tpu_torch.ops.fused_update import fused_update_select
    from dpsvm_tpu_torch.ops.subproblem import solve_subproblem

    return {"solve_subproblem": solve_subproblem,
            "fold_select": fs.fold_select, "select_rows": fs.select_rows,
            "gather_gram": rnd.gather_gram,
            "fold_rows_select": rnd.fold_rows_select,
            "fused_update_select": fused_update_select,
            "ring_gather": ring.ring_gather,
            "ring_fold_window": ring.ring_fold_window}


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def subproblem_inputs(x_dev, y_dev, x_sq, k_diag, alpha, f, c, q, kp,
                      rule: str = "mvp"):
    """A real working set of the data: select_block's W at (alpha, f)
    (per-class quarters for the nu rule), with its gathered Gram block
    and per-slot state."""
    from dpsvm_tpu_torch.solver.block import gather_block, select_block

    w, ok, _, _ = select_block(f, alpha, y_dev, c, q,
                               rule="nu" if rule == "nu" else "mvp")
    _, _, kb, kd, a0, yw, f0 = gather_block(x_dev, y_dev, x_sq, k_diag, f,
                                            alpha, w, kp)
    return kb, a0, yw, f0, kd, ok.float()


# Kernel B1's (rule, pair_batch) cases on C-SVC states, and on nu-SVC
# states (the nu rule's class choice needs both classes' duals).
B1_RULES = (("mvp", 1), ("second_order", 1), ("mvp", 2), ("mvp", 4))
B1_NU_RULES = (("nu", 1),)


def phase_kernels(dev, x_dev, y_dev, x_sq, k_diag, states, kp, c, tau,
                  reps: int, rules=B1_RULES, timed_rule: str = "mvp") -> dict:
    """Kernel B1 against its plain version on real working sets: the same
    pair count, alpha within rtol 1e-6 / atol 1e-7, and bitwise for the
    pair batches and the nu rule. Returns the JSON record's measured
    fields (timed at the start state, q=256, limit=512, `timed_rule`)."""
    import torch

    from dpsvm_tpu_torch.ops.subproblem import (_solve_subproblem,
                                                solve_subproblem,
                                                subproblem_plan)

    worst = 0.0
    rec = {}
    for sname, (alpha, f, eps) in states.items():
        for q, limit in ((128, 256), (128, 512), (256, 512)):
            for rule, pb in rules:
                kb, a0, yw, f0, kd, ok = subproblem_inputs(
                    x_dev, y_dev, x_sq, k_diag, alpha, f, c, q, kp, rule)
                lim = torch.tensor(limit, dtype=torch.int32, device=dev)
                a_k, t_k = solve_subproblem(kb, a0, yw, f0, kd, ok, lim, c,
                                            eps, tau, rule=rule,
                                            pair_batch=pb)
                rows = set()
                a_p, _, t_p = _solve_subproblem(kb, kd, ok > 0, a0, yw, f0,
                                                c, eps, tau, limit, rule, pb,
                                                rows_read=rows)
                t_k, t_p = int(t_k), int(t_p)
                err = float((a_k - a_p).abs().max())
                worst = max(worst, err)
                if t_k != t_p:
                    raise AssertionError(
                        f"{sname} q={q} {rule} pair_batch={pb}: kernel ran "
                        f"{t_k} pairs, plain {t_p}")
                np.testing.assert_allclose(a_k.cpu().numpy(),
                                           a_p.cpu().numpy(),
                                           rtol=RTOL, atol=ATOL)
                bitwise = same_bits(a_k, a_p)
                if (pb > 1 or rule == "nu") and not bitwise:
                    raise AssertionError(
                        f"{sname} q={q} {rule} pair_batch={pb}: the "
                        "kernel's alpha is not bitwise its plain version's")
                ms = time_ms(functools.partial(
                    solve_subproblem, kb, a0, yw, f0, kd, ok, lim, c, eps,
                    tau, rule=rule, pair_batch=pb), reps)
                plain_ms = time_ms(functools.partial(
                    _solve_subproblem, kb, kd, ok > 0, a0, yw, f0, c, eps,
                    tau, limit, rule, pb), 1)
                # Least time for the same work: each distinct Gram row the
                # solve reads (once; the kernel re-reads them from L2),
                # five vectors in and alpha out, over the device memory
                # rate; against ~12 q float32 flops per trip over the
                # float32 rate. The kernel itself is held back by neither:
                # its trips form a serial chain of dependent reductions.
                nbytes = 4 * (len(rows) * q + 6 * q)
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                ops_ms = 12 * q * t_k / F32_FLOPS * 1e3
                bound_ms = max(bytes_ms, ops_ms)
                bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
                # The chain sets the time: a trip is one reduction of the
                # pair (i, j) and its update, pair_batch pairs a trip.
                trips = max(-(-t_k // pb), 1)
                plan = subproblem_plan(q)
                variant = (f"{plan.threads} threads x {plan.slots} slot, "
                           f"{plan.nchip} of {q} rows on chip")
                earlier = EARLIER_US_PER_PAIR.get(rule)
                print(f"[kernels] subproblem {sname} q={q} limit={limit} "
                      f"{rule} pair_batch={pb} ({variant}): pairs={t_k} "
                      f"rows_read={len(rows)} bitwise={bitwise} "
                      f"max_abs_err={err:.3g} ms={ms:.4f} "
                      f"plain_ms={plain_ms:.3f} bound_ms={bound_ms:.6f} "
                      f"({bound_by}) us_per_pair="
                      f"{1e3 * ms / max(t_k, 1):.3f} us_per_trip="
                      f"{1e3 * ms / trips:.3f}"
                      + (f" (earlier design {earlier:.3f} us a pair)"
                         if earlier and (sname, q, limit, pb) == (
                             "start", 256, 512, 1) else ""), flush=True)
                if (sname, q, limit, rule, pb) == ("start", 256, 512,
                                                   timed_rule, 1):
                    rec = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by, serial_trips=t_k)
    rec["max_abs_err"] = worst
    return rec


PLAIN_STAGES = (("solver.block", "select_block"),
                ("solver.block", "gather_block"),
                ("solver.block", "dispatch_subproblem"),
                ("solver.block", "fold_block"))
# The stage functions ops/round.py fused_round calls (dispatch_subproblem
# it imports from solver/block.py at call time).
FUSED_ROUND_STAGES = (("ops.round", "gather_gram"),
                      ("solver.block", "dispatch_subproblem"),
                      ("ops.round", "fold_rows_select"),
                      ("ops.round", "assemble_working_set"))
# The stage functions of the fused-fold round (B2) and of the pipelined
# round (B3); a third field counts the calls beyond one a round (the
# pipelined engine's seed prefetch).
FUSED_FOLD_STAGES = (("solver.block", "gather_block"),
                     ("solver.block", "dispatch_subproblem"),
                     ("solver.block", "kernel_rows"),
                     ("solver.block", "scatter_alpha"),
                     ("solver.block", "fold_select"),
                     ("solver.block", "assemble_working_set"))
PIPELINE_STAGES = (("solver.block", "dispatch_subproblem"),
                   ("solver.block", "select_rows", 1),
                   ("solver.block", "assemble_working_set", 1),
                   ("solver.block", "kernel_rows"),
                   ("solver.block", "maybe_kahan"),
                   ("solver.block", "scatter_alpha"))


def phase_stages(x, y, cfg, stages, label: str) -> dict:
    """Solve once more through dpsvm_tpu_torch.train with the stage
    functions the round loop calls wrapped in CUDA events. Prints each
    stage's device time per round and the stages' share of
    train_seconds; the rest is the round's own small ops, host work and
    the once-per-round gap read. Returns {stage: ms per round}."""
    import importlib

    import torch

    from dpsvm_tpu_torch import train

    mods = {m: importlib.import_module(f"dpsvm_tpu_torch.{m}")
            for m, *_ in stages}
    events = {st[1]: [] for st in stages}
    extra = {st[1]: st[2] if len(st) > 2 else 0 for st in stages}
    originals = {(m, name): getattr(mods[m], name) for m, name, *_ in stages}

    def timed(name, fn):
        # functools.wraps also copies a kernel wrapper's launch count, so
        # the wrapped call's own count update lands on this stand-in.
        @functools.wraps(fn)
        def run(*args, **kwargs):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args, **kwargs)
            e1.record()
            events[name].append((e0, e1))
            return out
        return run

    for (m, name), fn in originals.items():
        setattr(mods[m], name, timed(name, fn))
    try:
        _, res = train(x, y, cfg)
    finally:
        for (m, name), fn in originals.items():
            setattr(mods[m], name, fn)
    torch.cuda.synchronize()
    rounds = res.stats["outer_rounds"]
    if not res.converged or any(len(e) != rounds + extra[k]
                                for k, e in events.items()):
        raise AssertionError(f"stage-timed {label} solve did not run every "
                             "stage once per round to convergence")
    ms = {name: sum(e0.elapsed_time(e1) for e0, e1 in evs)
          for name, evs in events.items()}
    total = sum(ms.values())
    print(f"[stages] {label}: rounds={rounds} pairs={res.iterations} "
          f"train_seconds={res.train_seconds:.4f} "
          f"stage_share_of_train={100 * total / (1e3 * res.train_seconds):.1f}%"
          " | " + " ".join(
              f"{k}={v / rounds:.4f}ms({100 * v / total:.1f}%)"
              for k, v in ms.items()), flush=True)
    return {k: v / rounds for k, v in ms.items()}


def pad_rows(a, n_pad: int, fill: float):
    """a (n, ...) on the card, padded to n_pad rows with `fill`."""
    import torch

    out = torch.full((n_pad, *a.shape[1:]), fill, dtype=a.dtype,
                     device=a.device)
    out[:a.shape[0]] = a
    return out


def round_inputs(x, y, x_sq, k_diag, valid, alpha, f, c, q, kp, tau):
    """A real round's inputs at (alpha, f): select_block's working set
    (padded rows masked), its subproblem solved by kernel B1, the fold
    coefficients, the working set's kernel rows (plain, cuBLAS) and alpha
    after the scatter. Returns (w int32, qsq, coef, k_rows, alpha_new)."""
    import torch

    from dpsvm_tpu_torch.solver.block import (dispatch_subproblem,
                                              gather_block, scatter_alpha,
                                              select_block)
    from dpsvm_tpu_torch.ops.kernels import kernel_rows

    w, ok, _, _ = select_block(f, alpha, y, c, q, valid=valid)
    qx, qsq, kb, kd, a0, yw, f0 = gather_block(x, y, x_sq, k_diag, f, alpha,
                                               w, kp)
    limit = torch.tensor(2 * q, dtype=torch.int32, device=x.device)
    a_w, coef, _ = dispatch_subproblem(kb, kd, ok, a0, yw, f0, c, 1e-3, tau,
                                       limit, "mvp")
    k_rows = kernel_rows(x, x_sq, qx, qsq, kp)
    return (w.to(torch.int32), qsq, coef, k_rows,
            scatter_alpha(alpha, w, ok, a_w))


def same_bits(a, b) -> bool:
    import torch

    if a is None or b is None:
        return a is None and b is None
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def phase_fused_kernels(xs: dict, y, valid, states: dict, kp, c, tau,
                        q: int, reps: int) -> dict:
    """Kernels B2-B5 against their plain versions on a real round's
    inputs at the headline shapes, for every (state, X dtype, Kahan)
    case; timed at the headline's own case (start point, bfloat16 X, no
    compensation). Returns {kernel: JSON fields measured here}."""
    import torch

    from dpsvm_tpu_torch.ops import fold_select as fs
    from dpsvm_tpu_torch.ops import round as rnd
    from dpsvm_tpu_torch.ops.kernels import kernel_diag, squared_norms
    from dpsvm_tpu_torch.ops.kernels import mm_f32
    from dpsvm_tpu_torch.ops.select import split_c
    from dpsvm_tpu_torch.solver.smo import kahan_add

    n_pad, d = xs["bfloat16"].shape
    rows = n_pad // 128
    shp = (rows, 128)
    y2d = y.view(shp)
    valid2d = valid.float().view(shp)
    worst = {k: 0.0 for k in ("fold_select", "select_rows", "gather_gram",
                              "fold_rows_select")}
    rec = {}
    for sname, (alpha, f) in states.items():
        for dname, x in xs.items():
            x_sq = squared_norms(x)
            k_diag = kernel_diag(x_sq, kp)
            w, qsq, coef, k_rows, alpha_n = round_inputs(
                x, y, x_sq, k_diag, valid, alpha, f, c, q, kp, tau)
            a2d, f2d = alpha_n.view(shp), f.view(shp)
            # B4: the kernel rows and Gram block of the same working set.
            kr_k, kb_k = rnd.gather_gram(x, w, x_sq, qsq, kp)
            kr_p, kb_p = rnd._gather_gram(x, w, x_sq, qsq, kp)
            dk = max(float((kr_k - kr_p).abs().max()),
                     float((kb_k - kb_p).abs().max()))
            # |dots| differ by at most 2 d 2^-24 max|x|^2 between two float32
            # sums of the same products; rbf's slope in the dot is 2 gamma
            # (K <= 1), and exp adds a few ulps.
            dk_bound = rnd.gram_tolerance(x_sq, d, kp, 1.0)
            worst["gather_gram"] = max(worst["gather_gram"], dk)
            print(f"[kernels] gather_gram {sname} {dname}: max|dK|={dk:.3g} "
                  f"(bound {dk_bound:.3g})", flush=True)
            if not dk <= dk_bound:
                raise AssertionError(f"gather_gram {sname} {dname}: max|dK| "
                                     f"{dk} over {dk_bound}")
            if dname == "float32":  # 3xTF32, not a cheaper product
                ref = rnd.gram_f64(x, w, x_sq, qsq, kp)
                err, err_p, limit = rnd.tf32x3_check(
                    (kr_k, kb_k), (kr_p, kb_p), ref, x_sq, kp)
                del ref
                print(f"[kernels] gather_gram {sname} float32 against the "
                      f"float64 Gram: max|dK|={err:.3g}, plain {err_p:.3g} "
                      f"(limit {limit:.3g})", flush=True)
                if not err <= limit:
                    raise AssertionError(f"gather_gram {sname} float32: "
                                         f"{err} off the float64 Gram, over "
                                         f"{limit}")
            # B3: candidates from f as it stands.
            got = fs.select_rows(f2d, a2d, y2d, valid2d, c)
            want = fs._select_rows(f2d, a2d, y2d, valid2d, c)
            if not all(same_bits(g, h) for g, h in zip(got, want)):
                raise AssertionError(f"select_rows {sname} {dname} differs "
                                     "from its plain version")
            delta = coef @ k_rows
            for comp in (False, True):
                err2d = (kahan_add(f, torch.zeros_like(f), delta)[1].view(shp)
                         if comp else None)
                # B2: the delta read from memory.
                got = fs.fold_select(f2d, err2d, a2d, y2d, valid2d,
                                     delta.view(shp), c, compensated=comp)
                want = fs._fold_select(f2d, err2d, a2d, y2d, valid2d,
                                       delta.view(shp), c, comp)
                if not all(same_bits(g, h) for g, h in zip(got, want)):
                    raise AssertionError(f"fold_select {sname} {dname} "
                                         f"comp={comp} differs from plain")
                # B5: the delta contracted from the kernel rows.
                got = rnd.fold_rows_select(k_rows, coef, f2d, err2d, a2d,
                                           y2d, valid2d, c, compensated=comp)
                want = rnd._fold_rows_select(k_rows, coef, f2d, err2d, a2d,
                                             y2d, valid2d, c, comp)
                scale = (coef.abs() @ k_rows).view(shp)
                df = (got[0] - want[0]).abs()
                ok = bool((df <= 1e-6 * want[0].abs() + 2e-6 * scale).all())
                f_sel = got[0] if not comp else got[0] - got[1]
                emitted = fs.emit_row_candidates(f_sel, a2d, y2d, valid2d, c)
                same = all(same_bits(g, h) for g, h in zip(got[2:], emitted))
                agree = float((got[3] == want[3]).float().mean())
                worst["fold_rows_select"] = max(worst["fold_rows_select"],
                                                float(df.max()))
                print(f"[kernels] fold_rows_select {sname} {dname} "
                      f"comp={comp}: max|df|={float(df.max()):.3g} "
                      f"up ids as plain {100 * agree:.2f}%", flush=True)
                if not (ok and same):
                    raise AssertionError(f"fold_rows_select {sname} {dname} "
                                         f"comp={comp}: f' ok={ok}, "
                                         f"candidates as emitted={same}")
            if sname != "start":
                continue
            # ---- times at the headline's case.
            esz = x.element_size()
            vec = 4 * n_pad
            cand = 4 * 4 * rows
            args3 = (f2d, a2d, y2d, valid2d, c)
            args2 = (f2d, None, a2d, y2d, valid2d, delta.view(shp), c)
            args5 = (k_rows, coef, f2d, None, a2d, y2d, valid2d, c)
            cases = {
                "fold_select": (functools.partial(fs.fold_select, *args2),
                                functools.partial(fs._fold_select, *args2),
                                None, bound(6 * vec + cand, n_pad,
                                            F32_FLOPS)),
                "select_rows": (functools.partial(fs.select_rows, *args3),
                                functools.partial(fs._select_rows, *args3),
                                None, bound(4 * vec + cand, 0, F32_FLOPS)),
                "fold_rows_select": (
                    functools.partial(rnd.fold_rows_select, *args5),
                    functools.partial(rnd._fold_rows_select, *args5),
                    None, bound(4 * q * n_pad + 4 * q + 5 * vec + cand,
                                2 * q * n_pad + n_pad, F32_FLOPS)),
                "gather_gram": (
                    functools.partial(rnd.gather_gram, x, w, x_sq, qsq, kp),
                    functools.partial(rnd._gather_gram, x, w, x_sq, qsq, kp),
                    functools.partial(lambda x, w: mm_f32(x[w], x.t()), x, w),
                    bound(n_pad * d * esz + 4 * (n_pad + 2 * q)
                          + 4 * q * (n_pad + q),
                          2 * q * d * (n_pad + q),
                          BF16_FLOPS if esz == 2 else F32_FLOPS)),
            }
            if dname == "float32":  # B4 also timed with float32 X
                cases = {"gather_gram/float32": cases["gather_gram"]}
            else:
                floor_ms = launch_floor_ms(reps)
            for name, (kern, plain, libf, (b_ms, b_by)) in cases.items():
                ms = time_cold_ms(kern, reps)
                plain_ms = time_cold_ms(plain, max(1, reps // 4))
                lib_ms = time_cold_ms(libf, reps) if libf else None
                rec[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by, library_ms=lib_ms)
                extra = ""
                if name in ("fold_select", "select_rows", "fold_rows_select"):
                    rec[name]["launch_floor_ms"] = floor_ms
                    extra = f" launch_floor_ms={floor_ms:.4f}"
                if name in ("fold_select", "select_rows"):
                    extra += (f"; plan {tuple(fs.fold_select_plan(rows))}; "
                              f"earlier design {EARLIER_MS[name, rows]} ms")
                if name == "fold_rows_select":
                    # cuBLAS on the same flushed kernel rows: the
                    # contraction alone, not B5's function.
                    con_ms = time_cold_ms(functools.partial(
                        lambda k, c_: torch.mv(k.t(), c_), k_rows, coef),
                        reps)
                    rec[name]["contraction_ms"] = con_ms
                    extra += (f" contraction_ms={con_ms:.4f} (torch.mv, the "
                              f"contraction alone); plan "
                              f"{tuple(rnd.fold_rows_plan(q, rows))}; earlier "
                              f"design "
                              f"{EARLIER_MS['fold_rows_select', q]} ms")
                if name.startswith("gather_gram"):
                    flops = 2 * q * d * (n_pad + q)
                    extra = (f" {flops / ms / 1e9:.1f} TFLOP/s; earlier "
                             f"design {EARLIER_MS['gather_gram', dname]} ms")
                    if esz == 4:
                        extra += (f"; 3xTF32 bound "
                                  f"{3 * flops / TF32_FLOPS * 1e3:.5f} ms")
                print(f"[kernels] {name} {sname} {dname} timed: ms={ms:.4f} "
                      f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} "
                      f"({b_by}) library_ms="
                      f"{'none' if lib_ms is None else f'{lib_ms:.4f}'}"
                      + extra, flush=True)
    # B2 and B3 at covtype scale (R 3912) on seeded views, both c forms.
    f2d, e2d, a2d, y2d, v2d, d2d = b23_turns_inputs(3912, y.device)
    c_pos, c_neg = split_c(c)
    for cc in (c_pos, (c_pos, 0.5 * c_neg)):
        got = fs.select_rows(f2d, a2d, y2d, v2d, cc)
        same = all(same_bits(g, h) for g, h in zip(
            got, fs._select_rows(f2d, a2d, y2d, v2d, cc)))
        for comp in (False, True):
            err2d = e2d if comp else None
            got = fs.fold_select(f2d, err2d, a2d, y2d, v2d, d2d, cc,
                                 compensated=comp)
            same = same and all(same_bits(g, h) for g, h in zip(
                got, fs._fold_select(f2d, err2d, a2d, y2d, v2d, d2d, cc,
                                     comp)))
        print(f"[kernels] select_rows and fold_select (plain and "
              f"compensated) at R 3912, c={cc}: bitwise={same}", flush=True)
        if not same:
            raise AssertionError(f"B2 / B3 at R 3912, c={cc}, differ from "
                                 "their plain versions")
    for name, v in worst.items():
        rec[name]["max_abs_err"] = v
    return rec


# Launches each engine's round must make, from its loop: (kernel, count
# as a function of the outer rounds).
ENGINES = {
    "fused_fold": {"solve_subproblem": lambda r: r,
                   "fold_select": lambda r: r},
    "fused_round": {"solve_subproblem": lambda r: r,
                    "gather_gram": lambda r: r,
                    "fold_rows_select": lambda r: r},
    "pipeline_rounds": {"solve_subproblem": lambda r: r,
                        "select_rows": lambda r: r + 1},
}


def counted(label: str, fit, want: dict) -> tuple:
    """Run `fit()` -> (model, result) with every launch count set to 0
    just before and read just after, its warnings caught and printed. The
    run must converge and launch exactly `want` (kernel -> count from the
    outer rounds), every other kernel not at all; a block engine (`want`
    not empty) must have run rounds. Returns (model, result, counts,
    warning texts)."""
    import warnings

    reset_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        model, res = fit()
    counts = read_counts()
    texts = [str(w.message) for w in caught]
    for t in texts:
        print(f"[{label}] warning: {t}", flush=True)
    rounds = res.stats.get("outer_rounds", 0)
    expect = {k: want.get(k, lambda r: 0)(rounds) for k in counts}
    engine = ([k for k in ("fused_fold", "fused_round", "pipelined")
               if res.stats.get(k)] or ["plain"]
              if "outer_rounds" in res.stats else ["per-pair"])
    print(f"[{label}] engine={engine} converged={res.converged} "
          f"pairs={res.iterations} outer_rounds={rounds or 'none'} "
          f"train_seconds={res.train_seconds:.4f} n_sv={res.n_sv} "
          f"b={res.b:.6f} launches={counts}", flush=True)
    if not res.converged:
        raise AssertionError(f"{label} solve did not converge")
    if counts != expect or (want and rounds == 0):
        raise AssertionError(f"{label}: launches {counts}, expected "
                             f"{expect}: the path did not run through its "
                             "kernels as derived")
    return model, res, counts, texts


def check_oracle(model, res, x, oracle, sk_dec, label: str,
                 tag: str = "oracle"):
    """The LibSVM oracle contract; returns the decision values."""
    from dpsvm_tpu_torch import decision_function

    dec = decision_function(model, x)
    sv_dev = abs(res.n_sv - oracle["n_sv"]) / oracle["n_sv"]
    agree = float(np.mean(np.sign(dec) == np.sign(sk_dec)))
    print(f"[{tag}] {label}: converged={res.converged} "
          f"pairs={res.iterations} "
          f"outer_rounds={res.stats.get('outer_rounds', 'none')} "
          f"train_seconds={res.train_seconds:.4f} n_sv={res.n_sv} "
          f"(oracle {oracle['n_sv']}, dev {100 * sv_dev:.2f}%) "
          f"sign_agree={100 * agree:.3f}%", flush=True)
    if not res.converged:
        raise AssertionError(f"oracle-contract {label} solve did not "
                             "converge")
    if sv_dev > SV_TOL:
        raise AssertionError(f"{label}: n_sv {res.n_sv} is "
                             f"{100 * sv_dev:.2f}% off the oracle's "
                             f"{oracle['n_sv']}")
    if agree < SIGN_TOL:
        raise AssertionError(f"{label}: decision sign agreement "
                             f"{agree:.4f} < {SIGN_TOL}")
    return dec


# The per-pair runs of phase 6: (label, knobs on top of the headline's).
PER_PAIR = (("xla", dict(engine="xla")),
            ("xla cache512", dict(engine="xla", gram_resident=False,
                                  cache_lines=512)),
            ("xla pair_batch8", dict(engine="xla", pair_batch=8)),
            ("xla second_order", dict(engine="xla",
                                      selection="second_order")),
            ("pallas", dict(engine="pallas")))
# Their host-timed stages (module under dpsvm_tpu_torch, function).
PAIR_STAGES = {
    "xla": (("solver.smo", "select_working_set"),
            ("solver.smo", "apply_pair_update"),
            ("solver.smo", "read_obs")),
    "pallas": (("solver.smo", "pallas_pair_update"),
               ("solver.smo", "pair_dots"),  # runs inside the stage above
               ("ops.fused_update", "fused_update_select"),
               ("solver.smo", "read_obs")),
}


def train_pair_counted(x, y, cfg, label: str) -> tuple:
    """Train a per-pair engine with every launch count set to 0 just
    before and read just after: it must converge, and launch B6 once per
    pair update on engine="pallas" and no kernel at all otherwise.
    Returns (model, result, counts)."""
    from dpsvm_tpu_torch import train

    reset_counts()
    model, res = train(x, y, cfg)
    counts = read_counts()
    expect = {k: 0 for k in counts}
    if cfg.engine == "pallas":
        expect["fused_update_select"] = res.iterations
    st = res.stats
    print(f"[perpair] {label}: converged={res.converged} "
          f"pairs={res.iterations} train_seconds={res.train_seconds:.4f} "
          f"us_per_pair={1e6 * res.train_seconds / max(res.iterations, 1):.2f}"
          f" gram_resident={st['gram_resident']} cache_lookups="
          f"{st['cache_lookups']} cache_hit_rate={st['cache_hit_rate']:.4f} "
          f"n_sv={res.n_sv} b={res.b:.6f} launches={counts}", flush=True)
    if not res.converged:
        raise AssertionError(f"per-pair {label} solve did not converge")
    if counts != expect:
        raise AssertionError(f"per-pair {label}: launches {counts}, "
                             f"expected {expect}")
    return model, res, counts


def phase_pair_stages(x, y, cfg, stages, label: str) -> dict:
    """Solve once more with the per-pair loop's stage functions timed on
    the host clock (the loop reads its observations once a trip, so
    read_obs holds the wait for the device). Prints each stage's host
    ms per pair update and share of train_seconds (a stage called from
    inside another is part of that one's time too); the rest is the
    loop's own Python and small ops. Returns {stage: ms per pair}."""
    import importlib

    from dpsvm_tpu_torch import train

    mods = {m: importlib.import_module(f"dpsvm_tpu_torch.{m}")
            for m, _ in stages}
    spent = {name: 0.0 for _, name in stages}
    originals = {(m, name): getattr(mods[m], name) for m, name in stages}

    def timed(name, fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            spent[name] += time.perf_counter() - t
            return out
        return run

    for (m, name), fn in originals.items():
        setattr(mods[m], name, timed(name, fn))
    try:
        _, res = train(x, y, cfg)
    finally:
        for (m, name), fn in originals.items():
            setattr(mods[m], name, fn)
    if not res.converged:
        raise AssertionError(f"stage-timed {label} solve did not converge")
    pairs = res.iterations
    print(f"[pair stages] {label}: pairs={pairs} "
          f"train_seconds={res.train_seconds:.4f} | " + " ".join(
              f"{k}={1e3 * v / pairs:.4f}ms"
              f"({100 * v / res.train_seconds:.1f}%)"
              for k, v in spent.items()), flush=True)
    return {k: 1e3 * v / pairs for k, v in spent.items()}


def phase_b6(x, y, valid, states: dict, c, tau, reps: int) -> dict:
    """Kernel B6 against its plain version on a real trip's inputs at the
    padded per-pair shape: the pair the state selects, its dot rows, and
    its coefficients from the pallas engine's own pre-B6 step. Timed at
    the start point with rbf. Returns the JSON record's measured fields."""
    import torch

    from dpsvm_tpu_torch.ops import fold_select as fs
    from dpsvm_tpu_torch.ops import fused_update as fu
    from dpsvm_tpu_torch.ops.kernels import (KernelParams, kernel_from_dots,
                                             squared_norms)
    from dpsvm_tpu_torch.ops.select import select_working_set
    from dpsvm_tpu_torch.solver.smo import pallas_pair_update, read_obs

    n_pad = y.shape[0]
    shp = (n_pad // 128, 128)
    x_sq = squared_norms(x)
    y2d, valid2d, x_sq2d = y.view(shp), valid.float().view(shp), x_sq.view(shp)
    worst = 0.0
    rec = {}
    for sname, (alpha, f) in states.items():
        for kind in ("rbf", "linear"):
            kp = KernelParams(kind, 0.125)
            i_hi, b_hi, i_lo, b_lo = select_working_set(f, alpha, y, c, valid)
            (ih, il), _ = read_obs((i_hi, i_lo))
            a = alpha.clone()
            d_hi, d_lo, sc, _ = pallas_pair_update(
                x, y, x_sq, kp, c, tau, None, a, ih, il, b_hi, b_lo, 0)
            args = (f.view(shp), a.view(shp), y2d, valid2d, d_hi.view(shp),
                    d_lo.view(shp), x_sq2d, sc, kp, c)
            got = fu.fused_update_select(*args)
            want = fu._fused_update_select(*args)
            k_hi = kernel_from_dots(d_hi.view(shp), x_sq2d, sc[2], kp)
            k_lo = kernel_from_dots(d_lo.view(shp), x_sq2d, sc[3], kp)
            scale = f.view(shp).abs() + (sc[0] * k_hi).abs() + \
                (sc[1] * k_lo).abs()
            df = (got[0] - want[0]).abs()
            within = bool((df <= 2.0 ** -22 * scale).all())
            own = fu.reduce_candidates(*fs.emit_row_candidates(
                got[0], a.view(shp), y2d, valid2d, c))
            exact = all(same_bits(g, h) for g, h in zip(got[1:], own))
            as_plain = (int(got[2]), int(got[4])) == (int(want[2]),
                                                      int(want[4]))
            worst = max(worst, float(df.max()))
            print(f"[b6] {sname} {kind}: pair=({ih}, {il}) "
                  f"max|df'|={float(df.max()):.3g} "
                  f"bitwise={same_bits(got[0], want[0])} "
                  f"selection exact on own f'={exact} ids as plain="
                  f"{as_plain} next=({int(got[2])}, {int(got[4])})",
                  flush=True)
            if not (within and exact):
                raise AssertionError(f"B6 {sname} {kind}: f' within 2 ulps="
                                     f"{within}, selection exact={exact}")
            if (sname, kind) != ("start", "rbf"):
                continue
            # 7 vectors in, f' out, 4 scalars each way; per element two
            # kernel evaluations (5 flops and an exp each) and two FMAs.
            b_ms, b_by = bound(8 * 4 * n_pad + 32, 14 * n_pad, F32_FLOPS)
            floor_ms = launch_floor_ms(reps)
            ms = time_cold_ms(functools.partial(fu.fused_update_select,
                                                *args), reps)
            plain_ms = time_cold_ms(functools.partial(
                fu._fused_update_select, *args), reps)
            rec = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=None, launch_floor_ms=floor_ms)
            print(f"[b6] timed ({sname}, n_pad {n_pad}): ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.6f} ({b_by}) "
                  f"library_ms=none launch_floor_ms={floor_ms:.4f}; plan "
                  f"{tuple(fu.fused_update_plan(n_pad))}; earlier design "
                  f"{EARLIER_MS.get(('fused_update_select', n_pad))} ms",
                  flush=True)
    rec["max_abs_err"] = worst
    return rec


def phase_ring_gather(dev, reps: int) -> dict:
    """Kernel B7 on P logical shards of the card at the headline block
    shape (2h = 256 rows of d + 5 + 3 = 792 lanes): every rank's output
    bitwise torch.stack(blocks), twice in a row. Timed at P = 2, 4 and 8
    against the plain version and the library's stack plus one copy per
    further rank, beside the earlier ring design's time. Returns the JSON
    record's measured fields (P = 4)."""
    import torch

    from dpsvm_tpu_torch.ops import ring

    shape = (256, 792)
    rec = {}
    for p_dev in (2, 4, 8):
        g = torch.Generator(device="cpu").manual_seed(100 + p_dev)
        blocks = [torch.randn(shape, generator=g).to(dev)
                  for _ in range(p_dev)]
        err = 0.0
        for call in (1, 2):
            got = ring.ring_gather(blocks)
            torch.cuda.synchronize()
            want = torch.stack(blocks)
            err = max(err, *(float((r - want).abs().max()) for r in got))
            if not all(same_bits(r, want) for r in got):
                raise AssertionError(f"ring_gather P={p_dev} call {call}: a "
                                     "rank's output is not the stack")
            blocks = [b * 2.0 + 1.0 for b in blocks]

        def library():
            first = torch.stack(blocks)
            return [first] + [first.clone() for _ in range(p_dev - 1)]

        ms = time_cold_ms(functools.partial(ring.ring_gather, blocks), reps)
        plain_ms = time_cold_ms(functools.partial(ring.ring_gather_plain,
                                                  blocks), reps)
        lib_ms = time_cold_ms(library, reps)
        # P blocks read once, P ranks' (P, L, lanes) outputs written once.
        nbytes = 4 * shape[0] * shape[1] * (p_dev + p_dev * p_dev)
        b_ms, b_by = bound(nbytes, 0, F32_FLOPS)
        print(f"[kernels] ring_gather P={p_dev} blocks {shape}: bitwise the "
              f"stack on both calls (max abs err {err:g}); ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} bound_ms={b_ms:.5f} ({b_by}, "
              f"{nbytes / 1e6:.1f} MB) one launch of "
              f"{ring.gather_plan(shape[0] * shape[1], True).chunks * p_dev}"
              f" blocks; earlier ring design "
              f"{EARLIER_MS['ring_gather', p_dev]:.4f}", flush=True)
        if p_dev == 4:
            rec = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
    return rec


def shard_rows(a, p_dev: int) -> list:
    """a (n, ...) on the card cut into P equal row shards (views)."""
    n_loc = a.shape[0] // p_dev
    return [a[r * n_loc:(r + 1) * n_loc].contiguous() for r in range(p_dev)]


def phase_ring_fold(x_f32, x_bf16, y_dev, c, tau, q: int, reps: int) -> dict:
    """Kernel B8 on P logical shards against its plain version, on the
    windows that R real local rounds per shard produce from a mid-solve
    state (20 global mesh rounds from the start point). Returns the JSON
    record's measured fields, timed at P = 4, R = 1, bfloat16 X, rbf."""
    import torch

    from dpsvm_tpu_torch.ops import ring
    from dpsvm_tpu_torch.ops.kernels import (KernelParams, kernel_diag,
                                             kernel_rows, mm_f32,
                                             squared_norms)
    from dpsvm_tpu_torch.parallel.dist_block import (MeshBlockState,
                                                     make_block_chunk_runner)
    from dpsvm_tpu_torch.parallel.mesh import Mesh
    from dpsvm_tpu_torch.solver.block import run_local_round

    dev = y_dev.device
    d = x_f32.shape[1]
    eps, inner = 0.01, 2 * q
    rec, worst = {}, 0.0
    for p_dev in (2, 4):
        mesh = Mesh([dev] * p_dev)
        y_s = shard_rows(y_dev, p_dev)
        valid = [torch.ones_like(t, dtype=torch.bool) for t in y_s]
        for dname, x_all in (("bfloat16", x_bf16), ("float32", x_f32)):
            x_s = shard_rows(x_all, p_dev)
            x_sq = [squared_norms(t) for t in x_s]
            for kind in ("rbf", "linear"):
                kp = KernelParams(kind, 0.125)
                cc = c
                k_diag = [kernel_diag(s, kp) for s in x_sq]
                zero = [torch.zeros((), dtype=torch.int32, device=dev)]
                st = MeshBlockState(
                    [torch.zeros_like(t) for t in y_s], [-t for t in y_s],
                    [torch.tensor(-float("inf"), device=dev)],
                    [torch.tensor(float("inf"), device=dev)], zero, zero)
                st = make_block_chunk_runner(
                    mesh, kp, cc, eps, tau, q, inner, 20)(
                        x_s, y_s, x_sq, k_diag, valid, st, 10 ** 6)
                for r_sync in (1, 2):
                    for comp in (False, True):
                        pends, fs, errs = [], [], ([] if comp else None)
                        budget = torch.tensor(10 ** 6, dtype=torch.int32,
                                              device=dev)
                        for r in range(p_dev):
                            a_r, f_r = st.alpha[r], st.f[r]
                            e_r = torch.zeros_like(f_r) if comp else None
                            blks = []
                            for _ in range(r_sync):
                                (a_r, f_r, e_r, _, _, t, coef, qx,
                                 qsq) = run_local_round(
                                    x_s[r], y_s[r], x_sq[r], k_diag[r],
                                    valid[r], a_r, f_r, e_r, budget, kp, cc,
                                    eps, tau, q, inner, "mvp")
                                tcol = torch.zeros(q, device=dev)
                                tcol[0] = t.float()
                                blks.append(torch.cat(
                                    [qx.float(), qsq[:, None], coef[:, None],
                                     tcol[:, None]], dim=1))
                            pends.append(torch.cat(blks))
                            fs.append(f_r)
                            if comp:
                                errs.append(e_r)
                        args = (pends, x_s, x_sq, fs, errs, kp)
                        gath, f_k, e_k = ring.ring_fold_window(*args)
                        torch.cuda.synchronize()
                        _, f_p, e_p = ring.ring_fold_window_plain(*args)
                        want_g = torch.stack(pends)
                        # The kernel and the library sum each dot and the
                        # contraction in their own orders, so both are held
                        # against the fold carried in float64: the kernel
                        # may be off it by rtol 1e-6, 2e-6 of the
                        # contraction's absolute sum, and 4 times the
                        # largest error the plain version itself makes.
                        df_max, dp_max, tol_max = 0.0, 0.0, 0.0
                        bitwise, live = True, 0
                        for r in range(p_dev):
                            if not same_bits(gath[r], want_g):
                                raise AssertionError(
                                    f"ring_fold_window P={p_dev}: rank {r}'s "
                                    "gathered windows are not the stack")
                            scale = torch.zeros_like(fs[r])
                            for i in range(p_dev - 1):
                                blk = want_g[(r + 1 + i) % p_dev]
                                live += int((blk[:, d + 1] != 0).sum())
                                scale += blk[:, d + 1].abs() @ kernel_rows(
                                    x_s[r], x_sq[r],
                                    blk[:, :d].to(x_s[r].dtype), blk[:, d],
                                    kp).abs()
                            ref = ring.fold_window_peers_f64(
                                want_g, r, x_s[r], x_sq[r], fs[r],
                                errs[r] if comp else None, kp)
                            got, plain = f_k[r].double(), f_p[r].double()
                            if comp:
                                got = got - e_k[r].double()
                                plain = plain - e_p[r].double()
                            dp = float((plain - ref).abs().max())
                            tol = 1e-6 * ref.abs() + 2e-6 * scale + 4 * dp
                            df = (got - ref).abs()
                            df_max = max(df_max, float(df.max()))
                            dp_max = max(dp_max, dp)
                            worst = max(worst,
                                        float((got - plain).abs().max()))
                            tol_max = max(tol_max, float(tol.max()))
                            if not bool((df <= tol).all()):
                                raise AssertionError(
                                    f"ring_fold_window P={p_dev} R={r_sync} "
                                    f"{dname} {kind} comp={comp}: f' off the "
                                    f"float64 fold by {float(df.max()):.3g}, "
                                    f"the plain version by {dp:.3g}")
                            bitwise &= same_bits(f_k[r], f_p[r])
                        print(f"[kernels] ring_fold_window P={p_dev} "
                              f"R={r_sync} {dname} {kind} comp={comp}: "
                              f"gathered bitwise; live coefs {live}; against "
                              f"the float64 fold max|df'|={df_max:.3g} "
                              f"(plain version {dp_max:.3g}; largest "
                              f"tolerance {tol_max:.3g} = rtol 1e-6 + 2e-6 "
                              f"|coef| @ |K| + 4 x the plain version's); f' "
                              f"bitwise the plain version={bitwise}",
                              flush=True)
                        if live == 0:
                            raise AssertionError("the windows carry no "
                                                 "update: not a mid-solve "
                                                 "state")
                        if comp:
                            continue
                        # A window of zero coefs folds nothing.
                        dead = [p.clone() for p in pends]
                        for p in dead:
                            p[:, d + 1] = 0.0
                        _, f_z, _ = ring.ring_fold_window(dead, x_s, x_sq,
                                                          fs, None, kp)
                        if not all(same_bits(a, b) for a, b in zip(f_z, fs)):
                            raise AssertionError(
                                "ring_fold_window: a zero-coef window "
                                "changed f")
                        if (r_sync, kind) != (1, "rbf") or p_dev != 4:
                            continue
                        rq, n_loc = q * r_sync, x_s[0].shape[0]
                        esz = x_s[0].element_size()
                        win = 4 * rq * (d + 3)
                        nbytes = (p_dev * win + p_dev * p_dev * win
                                  + p_dev * n_loc * (d * esz + 4 * 3))
                        flops = p_dev * (p_dev - 1) * 2 * rq * d * n_loc
                        b_ms, b_by = bound(
                            nbytes, flops,
                            BF16_FLOPS if esz == 2 else F32_FLOPS)

                        def library():
                            # The products of the plain fold: per rank and
                            # peer, rows @ x_loc^T and coef @ K.
                            for r in range(p_dev):
                                for i in range(p_dev - 1):
                                    blk = want_g[(r + 1 + i) % p_dev]
                                    k = mm_f32(blk[:, :d].to(x_s[r].dtype),
                                               x_s[r].t())
                                    blk[:, d + 1] @ k

                        ms = time_cold_ms(functools.partial(
                            ring.ring_fold_window, *args), reps)
                        plain_ms = time_cold_ms(functools.partial(
                            ring.ring_fold_window_plain, *args), reps)
                        lib_ms = time_cold_ms(library, reps)
                        tf32 = ("" if esz == 2 else
                                f"; 3xTF32 bound "
                                f"{3 * flops / TF32_FLOPS * 1e3:.5f} ms")
                        print(f"[kernels] ring_fold_window timed (P=4, R=1, "
                              f"n_loc {n_loc}, {dname}): ms={ms:.4f} "
                              f"plain_ms={plain_ms:.4f} library_ms="
                              f"{lib_ms:.4f} bound_ms={b_ms:.5f} ({b_by}; "
                              f"{flops / 1e9:.1f} GFLOP, "
                              f"{nbytes / 1e6:.1f} MB{tf32}) "
                              f"{flops / ms / 1e9:.1f} TFLOP/s; earlier "
                              f"design "
                              f"{EARLIER_MS['ring_fold_window', dname]} ms",
                              flush=True)
                        if dname == "bfloat16":
                            rec = dict(ms=ms, plain_ms=plain_ms,
                                       library_ms=lib_ms, bound_ms=b_ms,
                                       bound_by=b_by)
    rec["max_abs_err"] = worst  # kernel against the float32 plain version
    return rec


MESH_RUNS = (
    ("a global", dict(ring_exchange=False)),
    ("b global ring", dict(ring_exchange=True)),
    ("c shardlocal ring", dict(local_working_sets=4, sync_rounds=2,
                               ring_exchange=True)),
)


def mesh_expect(st: dict, cfg, p_dev: int, kernels, start_rounds: int = 0
                ) -> dict:
    """The launches a mesh run's loop derives from its stats (rounds of
    this call: outer_rounds less `start_rounds`, a resumed file's).
    Global, pipelined, fused and active rounds: B1 once a round or
    inner round (replicated work is computed once a device).
    Shard-local rounds: B1 once a shard and local round, B8 once a sync.
    Ring: B7 once a global round, or once a prefetch under the pipelined
    runner (a round's, plus each chunk's seed). Fused fold: B2 once a
    shard and round. The per-pair engine: none."""
    expect = {k: 0 for k in kernels}
    rounds = st.get("outer_rounds", 0) - start_rounds
    syncs = st.get("shardlocal_syncs", 0)
    local = syncs * cfg.sync_rounds
    if cfg.engine == "block":
        expect["solve_subproblem"] = p_dev * local + (rounds - local)
    if st.get("ring_exchange"):
        expect["ring_gather"] = (rounds + st["chunks"] if st.get("pipelined")
                                 else rounds - local)
        expect["ring_fold_window"] = syncs
    if st.get("fused_fold"):
        expect["fold_select"] = p_dev * rounds
    return expect


def train_mesh_counted(x, y, cfg, mesh, label: str, tag: str = "mesh",
                       start_rounds: int = 0, **kw) -> tuple:
    """Train on the mesh with every launch count set to 0 just before and
    read just after: it must converge and launch what its loops derive
    (mesh_expect). Returns (model, result, counts, warning texts)."""
    import warnings

    from dpsvm_tpu_torch import train

    reset_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        model, res = train(x, y, cfg, backend="mesh", mesh=mesh, **kw)
    counts = read_counts()
    texts = [str(w.message) for w in caught]
    st = res.stats
    expect = mesh_expect(st, cfg, mesh.size, counts, start_rounds)
    engine = ("per-pair" if cfg.engine == "xla" else
              [k for k in ("pipelined", "fused_fold", "active_set_size",
                           "shardlocal_syncs", "ring_exchange")
               if st.get(k)] or ["global"])
    print(f"[{tag}] {label}: devices={st['mesh_devices']} engine={engine} "
          f"converged={res.converged} pairs={res.iterations} "
          f"outer_rounds={st.get('outer_rounds', 'none')} "
          f"chunks={st['chunks']} syncs={st.get('shardlocal_syncs', 0)} "
          f"demoted={st.get('shardlocal_demotion', 'none')} "
          f"train_seconds={res.train_seconds:.4f} n_sv={res.n_sv} "
          f"b={res.b:.6f} launches={counts}", flush=True)
    for t in texts:
        print(f"[{tag}] {label}: warning: {t}", flush=True)
    if not res.converged:
        raise AssertionError(f"mesh run {label} did not converge")
    if counts != expect or (cfg.engine == "block"
                            and st["outer_rounds"] == start_rounds):
        raise AssertionError(f"mesh run {label}: launches {counts}, "
                             f"expected {expect}")
    return model, res, counts, texts


def phase_mesh(x, y, cfg, dev) -> tuple:
    """The headline on four logical shards of the card. Returns
    ({kernel: launches}, the mesh)."""
    from dpsvm_tpu_torch import train
    from dpsvm_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh([dev] * 4)
    if mesh.describe() != ["cuda:0"] * 4:
        raise AssertionError(f"the mesh is {mesh.describe()}, not four "
                             "logical shards of cuda:0")
    t0 = time.perf_counter()
    for _, kw in MESH_RUNS:
        train(x[:16384], y[:16384], cfg.replace(max_iter=2048, **kw),
              backend="mesh", mesh=mesh)
    print(f"[mesh] warm-up solves on 16384 rows in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    results = {}
    launches = {}
    for label, kw in MESH_RUNS:
        _, res, counts, _ = train_mesh_counted(x, y, cfg.replace(**kw),
                                               mesh, label)
        results[label[0]] = res
        for name in ("ring_gather", "ring_fold_window"):
            if counts[name]:
                launches.setdefault(name, counts[name])
    a, b, c_run = results["a"], results["b"], results["c"]
    same = (a.iterations == b.iterations
            and a.stats["outer_rounds"] == b.stats["outer_rounds"]
            and np.array_equal(a.alpha.view(np.uint32),
                               b.alpha.view(np.uint32)))
    print(f"[mesh] ring on == ring off: pairs, rounds and alpha bitwise="
          f"{same}", flush=True)
    if not same:
        raise AssertionError("the ring exchange changed the global runner's "
                             "trajectory")
    if not c_run.stats["shardlocal_syncs"] > 0:
        raise AssertionError("the shard-local run made no sync")
    if set(launches) != {"ring_gather", "ring_fold_window"}:
        raise AssertionError(f"the mesh runs launched {launches}")
    return launches, mesh


# ---- the model families (phases 12-14)

NU = 0.1
# nu-SVC headline: the C-SVC headline's data and block shape, bf16 X,
# with fused_round requested (the nu rule must fall back to the plain
# round and say so).
NU_HEADLINE = dict(gamma=0.125, epsilon=0.01, max_iter=2_000_000,
                   engine="block", working_set_size=256, dtype="bfloat16",
                   fused_round=True)
# nu-SVC against artifacts/oracle_nu60k (LibSVM at tol 1e-3; the port
# at eps = tol / 2, as tools/parity60k.py runs C-SVC).
NU_ORACLE = dict(gamma=0.125, epsilon=5e-4, max_iter=4_000_000,
                 engine="block", working_set_size=256)
ONECLASS = dict(gamma=0.125, epsilon=0.01, max_iter=2_000_000,
                engine="block", working_set_size=256)
# Largest |g_plain - g_fused| on any row, in units of eps: each engine
# stops with its maximal violating pair within eps, so each boundary
# (rho) is fixed to within eps and the two to within 2 eps; one eps more
# for the rows' own residuals.
ONECLASS_DG_EPS = 3.0
# The SVRs at a depth cut: the first SVR_ROWS rows (2 x SVR_ROWS duals).
SVR_ROWS = 10_000
SVR_RUN = dict(c=1.0, gamma=0.125, epsilon=0.01, max_iter=4_000_000,
               engine="block", working_set_size=256)
SVR_EPSILON = 0.1
NU_SVR = 0.4
SVR_PRED_TOL = 0.1
SUM_RTOL = 1e-4


def svr_target(x) -> np.ndarray:
    """The seeded smooth regression target of the SVR phase:
    z = 0.5 sin(3 s / std(s)) with s = (x - mean(x)) @ w, w a seed-11
    normal direction scaled by 1/sqrt(d)."""
    w = (np.random.default_rng(11).normal(size=x.shape[1])
         / np.sqrt(x.shape[1])).astype(np.float32)
    s = (x - x.mean(axis=0)) @ w
    return (0.5 * np.sin(3.0 * s / s.std())).astype(np.float32)


def phase_nu(x, y, dev, x_dev, y_dev, x_sq, k_diag, kp, tau) -> tuple:
    """nu-SVC at full size: (a) the headline with fused_round=True asked
    for (the fallback warning, B1 = rounds, no B4 / B5); kernel B1's nu
    rule on working sets of (a)'s start and end states; (b) the oracle
    configuration on the block engine and engine="xla" against
    artifacts/oracle_nu60k, and the block model's .npz reload. Returns
    (B1 nu record, launches of (a))."""
    import torch

    from dpsvm_tpu_torch import SVMConfig, SVMModel, decision_function
    from dpsvm_tpu_torch import train_nusvc
    from dpsvm_tpu_torch.models.nusvm import _capped_fill
    from dpsvm_tpu_torch.ops.kernels import blocked_kernel_matvec

    t0 = time.perf_counter()
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        train_nusvc(x[:16384], y[:16384], NU,
                    SVMConfig(**{**NU_HEADLINE, "max_iter": 2048}))
    print(f"[nu] warm-up solve on 16384 rows in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    _, res_a, counts_a, texts = counted(
        "nu headline", lambda: train_nusvc(x, y, NU,
                                           SVMConfig(**NU_HEADLINE)),
        {"solve_subproblem": lambda r: r})
    if not any("fused_round (plain round body)" in t for t in texts):
        raise AssertionError("train_nusvc did not name the fused_round "
                             "fallback")
    if res_a.stats["fused_round"] or res_a.stats["fused_fold"]:
        raise AssertionError("the nu headline ran a fused engine")

    # B1's nu rule on the duals' own states: the trainer's warm start,
    # and (a)'s end state with the 1/r rescale undone.
    n = len(y)
    alpha0 = np.zeros(n, np.float32)
    for idx in (np.nonzero(y > 0)[0], np.nonzero(y < 0)[0]):
        alpha0[idx] = _capped_fill(len(idx), NU * n / 2.0, 1.0)
    f0 = blocked_kernel_matvec(x, alpha0 * y, kp, "bfloat16", device=dev)
    r = res_a.stats["nu_r"]
    a_end = np.clip(res_a.alpha * r, 0.0, 1.0).astype(np.float32)
    f_end = (res_a.stats["f"] * r).astype(np.float32)
    states = {"nu_start": (torch.as_tensor(alpha0, device=dev),
                           torch.as_tensor(f0, device=dev), 0.01),
              "nu_end": (torch.as_tensor(a_end, device=dev),
                         torch.as_tensor(f_end, device=dev), 1e-3)}
    rec = phase_kernels(dev, x_dev, y_dev, x_sq, k_diag,
                        {"start" if k == "nu_start" else k: v
                         for k, v in states.items()},
                        kp, 1.0, tau, reps=20, rules=B1_NU_RULES,
                        timed_rule="nu")

    with open(os.path.join(ROOT, "artifacts", "oracle_nu60k.json")) as fh:
        oracle = json.load(fh)
    with np.load(os.path.join(ROOT, "artifacts", "oracle_nu60k.npz")) as z:
        sk_dec = np.asarray(z["dec"])
    for eng in ("xla", "block"):  # the block model is saved below
        model, res, _, _ = counted(
            f"nu oracle {eng}",
            lambda: train_nusvc(x, y, NU, SVMConfig(**{**NU_ORACLE,
                                                       "engine": eng})),
            {"solve_subproblem": lambda r: r} if eng == "block" else {})
        dec = check_oracle(model, res, x, oracle, sk_dec, eng, tag="nu")
    out_dir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "nusvc60k.npz")
    model.save(path)
    diff = float(np.max(np.abs(
        decision_function(SVMModel.load(path), x) - dec)))
    print(f"[nu] reloaded .npz: max |dec diff| = {diff:.3g}", flush=True)
    if diff > 1e-6:
        raise AssertionError("nu-SVC .npz round trip changed decisions")
    return rec, counts_a


def phase_oneclass(x) -> dict:
    """One-class SVM at full size on the plain block engine and with
    fused_round=True (B1 = B4 = B5 = rounds, n padded to 60416 from a
    warm start): converged, sum(alpha) = nu n, inlier and SV fractions
    bounded by nu, the two engines' signs agreeing. Returns the launches
    of the fused run."""
    from dpsvm_tpu_torch import SVMConfig, train_oneclass

    n = x.shape[0]
    t0 = time.perf_counter()
    for kw in ({}, {"fused_round": True}):
        train_oneclass(x[:16384], NU, SVMConfig(**{**ONECLASS, **kw,
                                                   "max_iter": 2048}))
    print(f"[oneclass] warm-up solves on 16384 rows in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    runs = (("plain", {}, {"solve_subproblem": lambda r: r}),
            ("fused_round", {"fused_round": True},
             {"solve_subproblem": lambda r: r, "gather_gram": lambda r: r,
              "fold_rows_select": lambda r: r}))
    decs = {}
    for label, kw, want in runs:
        model, res, counts, _ = counted(
            f"oneclass {label}",
            lambda: train_oneclass(x, NU, SVMConfig(**ONECLASS, **kw)),
            want)
        total = float(res.alpha.astype(np.float64).sum())
        dec = model.decision_function(x)
        inlier = float(np.mean(dec >= 0))
        sv_frac = res.n_sv / n
        print(f"[oneclass] {label}: sum(alpha)={total:.6f} (nu n "
              f"{NU * n:.1f}) inlier={inlier:.4f} sv_fraction={sv_frac:.4f}"
              f" rho={model.rho:.6f} n_pad={res.stats['n_pad']}", flush=True)
        if abs(total - NU * n) > SUM_RTOL * NU * n:
            raise AssertionError(f"oneclass {label}: sum(alpha) {total} is "
                                 f"not nu n = {NU * n}")
        if inlier < 1 - NU - 0.01 or sv_frac < NU - 0.01:
            raise AssertionError(f"oneclass {label}: inlier {inlier}, SV "
                                 f"fraction {sv_frac} break the nu bounds")
        decs[label] = dec
    # A one-class model's free SVs lie ON its decision boundary: the
    # stopping rule puts their g within [-eps, eps], where its sign is
    # not determined. The signs are held where both engines' g are
    # outside that band; all rows' agreement is printed beside it. Every
    # row's g is held to ONECLASS_DG_EPS * eps between the engines.
    eps = ONECLASS["epsilon"]
    a, b = decs["plain"], decs["fused_round"]
    sure = (np.abs(a) > eps) & (np.abs(b) > eps)
    agree = float(np.mean(np.sign(a[sure]) == np.sign(b[sure])))
    agree_all = float(np.mean(np.sign(a) == np.sign(b)))
    dg = float(np.max(np.abs(a - b)))
    print(f"[oneclass] plain vs fused_round: sign_agree={100 * agree:.3f}% "
          f"of the {int(sure.sum())} rows with |g| > eps in both "
          f"(all rows {100 * agree_all:.3f}%; |g| <= eps: "
          f"{int((~sure).sum())} rows) max |dg|={dg:.4g} (bound "
          f"{ONECLASS_DG_EPS * eps:.4g})", flush=True)
    if agree < SIGN_TOL:
        raise AssertionError(f"oneclass: engines agree on {agree:.4f} of "
                             "the signs the stopping rule determines")
    if dg > ONECLASS_DG_EPS * eps:
        raise AssertionError(f"oneclass: the engines' decision values "
                             f"differ by {dg} > {ONECLASS_DG_EPS} eps")
    return counts


def phase_svr(x) -> dict:
    """epsilon-SVR and nu-SVR on the first SVR_ROWS rows (a depth cut)
    against svr_target, each on the block engine and engine="xla":
    converged, sum(a) - sum(a*) = 0 within 1e-4 C n, and the two
    engines' predictions within SVR_PRED_TOL. Returns the models by
    (trainer, engine)."""
    from dpsvm_tpu_torch import SVMConfig, train_nusvr, train_svr

    xs = np.ascontiguousarray(x[:SVR_ROWS])
    z = svr_target(xs)
    print(f"[svr] {SVR_ROWS} rows, target z in [{z.min():.4f}, "
          f"{z.max():.4f}] std {z.std():.4f}", flush=True)
    trainers = (
        ("eps-svr", lambda cfg: train_svr(xs, z, cfg,
                                          svr_epsilon=SVR_EPSILON)),
        ("nu-svr", lambda cfg: train_nusvr(xs, z, nu=NU_SVR, config=cfg)))
    models = {}
    for name, fit in trainers:
        preds = {}
        for eng in ("block", "xla"):
            cfg = SVMConfig(**{**SVR_RUN, "engine": eng})
            model, res, _, _ = counted(
                f"svr {name} {eng}", lambda: fit(cfg),
                {"solve_subproblem": lambda r: r} if eng == "block" else {})
            models[name, eng] = model
            a = res.alpha.astype(np.float64)
            drift = abs(a[:SVR_ROWS].sum() - a[SVR_ROWS:].sum())
            preds[eng] = model.predict(xs)
            rmse = float(np.sqrt(np.mean((preds[eng] - z) ** 2)))
            extra = (f" tube={res.stats['nu_tube_eps']:.6f}"
                     if "nu_tube_eps" in res.stats else "")
            print(f"[svr] {name} {eng}: |sum(a) - sum(a*)|={drift:.3g} "
                  f"rmse={rmse:.6f} model_sv={model.n_sv}{extra}",
                  flush=True)
            if drift > SUM_RTOL * SVR_RUN["c"] * SVR_ROWS:
                raise AssertionError(f"{name} {eng}: sum(a) - sum(a*) = "
                                     f"{drift}")
        gap = float(np.max(np.abs(preds["block"] - preds["xla"])))
        print(f"[svr] {name}: block vs xla max |dz| = {gap:.4g}", flush=True)
        if gap >= SVR_PRED_TOL:
            raise AssertionError(f"{name}: block and xla predictions differ "
                                 f"by {gap}")
    return models


# ---- this slice's phases (15-18): the CLI and data surface, solver
# state, reconstruction legs and the bf16 Gram gate

# [cli]: the CLI's test files hold the first CLI_TEST_ROWS rows.
CLI_TEST_ROWS = 10_000
# [state]: 4 rounds a chunk at inner 512 (the headline's 77 rounds: 20
# chunks); a checkpoint at every chunk, two generations kept; the abort
# after chunk STATE_ABORT_CHUNK.
STATE_RUN = dict(chunk_iters=2048, checkpoint_every=1, checkpoint_keep=2)
STATE_ABORT_CHUNK = 3
STATE_MIN_CHUNKS = 8
# The oracle-configuration runs of [state], chunked, stopped after chunk
# 3 and resumed: (label, knobs, kernel -> launches over both calls from
# (n, chunks)); n is the outer rounds on the block engines (16 a chunk),
# the pairs on pallas (1024 a chunk). The fused fold seeds each chunk
# with a plain selection; the pipelined engine with one B3 prefetch.
STATE_ORACLE = (
    ("fused_fold", dict(fused_fold=True, chunk_iters=8192),
     {"solve_subproblem": lambda n, k: n, "fold_select": lambda n, k: n}),
    ("pipeline_rounds", dict(pipeline_rounds=True, chunk_iters=8192),
     {"solve_subproblem": lambda n, k: n,
      "select_rows": lambda n, k: n + k}),
    ("fused_round", dict(fused_round=True, chunk_iters=8192),
     {"solve_subproblem": lambda n, k: n, "gather_gram": lambda n, k: n,
      "fold_rows_select": lambda n, k: n}),
    ("pallas", dict(engine="pallas", chunk_iters=1024),
     {"fused_update_select": lambda n, k: n}))
# [reconstruct]: the JAX package's covtype stress configuration
# (dpsvm_tpu/solver/reconstruct.py: c = 2048, gamma = 0.03125) with the
# Kahan carry, on a row cut of make_covtype_like.
RECON_ROWS = 2000
RECON_RUN = dict(c=2048.0, gamma=0.03125, epsilon=1e-3, max_iter=2_000_000,
                 working_set_size=256, compensated=True)
RECON_LEGS = (("block", dict(engine="block", reconstruct_every=200_000)),
              ("xla", dict(engine="xla", reconstruct_every=50_000)))
# [bf16_gram]: the whole-solve contract against the float32 solve.
DUAL_RTOL = 0.005
SV_RTOL = 0.10


def smoke_dir() -> str:
    out = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(out, exist_ok=True)
    return out


def write_csv(path: str, x, y) -> None:
    """label,f1,...,fd at %.9g (round-trips float32), one format a row."""
    fmt = "%d," + ",".join(["%.9g"] * x.shape[1]) + "\n"
    with open(path, "w") as fh:
        for xi, yi in zip(x.tolist(), y.tolist()):
            fh.write(fmt % (yi, *xi))


def write_libsvm(path: str, x, y) -> None:
    """label idx:val ... with every feature written (zeros too)."""
    fmt = "%d " + " ".join(f"{j + 1}:%.9g" for j in range(x.shape[1])) + "\n"
    with open(path, "w") as fh:
        for xi, yi in zip(x.tolist(), y.tolist()):
            fh.write(fmt % (yi, *xi))


def run_cli(argv: list, label: str) -> str:
    """dpsvm_tpu_torch.cli.main(argv) with its standard output captured
    and echoed under [label]; a non-zero exit, or the NumPy CSV parser's
    fallback warning, is a failure. Returns the output."""
    import contextlib
    import io
    import warnings

    from dpsvm_tpu_torch import cli as port_cli

    buf = io.StringIO()
    with warnings.catch_warnings(record=True) as caught, \
            contextlib.redirect_stdout(buf):
        warnings.simplefilter("always")
        rc = port_cli.main(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        if "iter=" not in line:
            print(f"[{label}] {line}", flush=True)
    for w in caught:
        print(f"[{label}] warning: {w.message}", flush=True)
        if "native CSV parser" in str(w.message):
            raise AssertionError(f"{label}: the native CSV parser did not "
                                 "load")
    if rc != 0:
        raise AssertionError(f"{label}: cli exited {rc}")
    return out


def _grab(pattern: str, text: str, label: str) -> str:
    import re

    m = re.search(pattern, text)
    if m is None:
        raise AssertionError(f"{label}: no {pattern!r} in the CLI output")
    return m.group(1)


def phase_cli(x, y, head_model, head_res) -> dict:
    """The headline through dpsvm_tpu_torch.cli.main, from a CSV file and
    from a LIBSVM file of the same rows (--format auto). Each CLI model
    must be the API headline's: the same pairs and rounds, B1 once a
    round and no other kernel, SV rows, coefficients and b bit for bit.
    Each is tested (-o) at --precision float32 and float64 on the first
    CLI_TEST_ROWS rows: the labels must be the signs of the API model's
    decisions at the same precision. Returns the launch counts a run."""
    from dpsvm_tpu_torch import SVMModel, decision_function
    from dpsvm_tpu_torch.utils import native

    out = smoke_dir()
    files = {}
    for fmt, writer in (("csv", write_csv), ("libsvm", write_libsvm)):
        train_p = os.path.join(out, f"train.{fmt}")
        test_p = os.path.join(out, f"test.{fmt}")
        t0 = time.perf_counter()
        writer(train_p, x, y)
        dt = time.perf_counter() - t0
        writer(test_p, x[:CLI_TEST_ROWS], y[:CLI_TEST_ROWS])
        files[fmt] = (train_p, test_p)
        print(f"[cli] wrote {fmt} {len(y)} x {x.shape[1]}: "
              f"{os.path.getsize(train_p) / 2 ** 20:.1f} MiB in {dt:.2f}s",
              flush=True)
    # The .npz holds b in float32: the API model with b rounded so.
    head_model = SVMModel(head_model.sv_x, head_model.sv_alpha,
                          head_model.sv_y, float(np.float32(head_model.b)),
                          head_model.kernel)
    want = {prec: np.where(decision_function(
        head_model, x[:CLI_TEST_ROWS], precision=prec) >= 0, 1, -1)
        for prec in ("float32", "float64")}
    launches = {}
    for fmt, (train_p, test_p) in files.items():
        label = f"cli {fmt}"
        model_p = os.path.join(out, f"cli_{fmt}.npz")
        reset_counts()
        text = run_cli(["train", "-f", train_p, "-m", model_p, "-c", "10",
                        "-g", "0.125", "-e", "0.01", "--engine", "block",
                        "--working-set-size", "256", "--inner-iters", "512",
                        "--dtype", "bfloat16", "--format", "auto"], label)
        counts = read_counts()
        launches[fmt] = counts
        pairs = int(_grab(r"converged at iteration (\d+)", text, label))
        rounds = int(_grab(r"\((\d+) rounds\)", text, label))
        parse_s = float(_grab(r"features in ([0-9.]+)s", text, label))
        want_rounds = head_res.stats["outer_rounds"]
        print(f"[cli] {fmt}: parse {parse_s:.2f}s pairs={pairs} "
              f"rounds={rounds} (API {head_res.iterations} / {want_rounds}) "
              f"launches={counts}", flush=True)
        if (pairs, rounds) != (head_res.iterations, want_rounds):
            raise AssertionError(f"{label}: {pairs} pairs / {rounds} rounds, "
                                 "not the API headline's")
        expect = {k: rounds if k == "solve_subproblem" else 0
                  for k in counts}
        if counts != expect:
            raise AssertionError(f"{label}: launches {counts}, expected "
                                 f"{expect}")
        m = SVMModel.load(model_p)
        if not (np.array_equal(m.sv_x, head_model.sv_x)
                and np.array_equal(m.dual_coef, head_model.dual_coef)
                and m.b == head_model.b):
            raise AssertionError(f"{label}: the model is not the API "
                                 "headline's bit for bit")
        for prec in ("float32", "float64"):
            out_p = os.path.join(out, f"cli_{fmt}_{prec}.out")
            run_cli(["test", "-f", test_p, "-m", model_p, "-o", out_p,
                     "--precision", prec], f"{label} test {prec}")
            got = np.loadtxt(out_p, dtype=np.int64)
            if not np.array_equal(got, want[prec]):
                raise AssertionError(
                    f"{label} test {prec}: {int(np.sum(got != want[prec]))} "
                    "labels differ from the API model's decisions")
        print(f"[cli] {fmt}: model bitwise the API headline's; test labels "
              "= the API decisions' signs at float32 and float64",
              flush=True)
    if native.get_fastcsv() is None:
        raise AssertionError(f"the native CSV parser did not build: "
                             f"{native.build_errors}")
    agree = float(np.mean(want["float32"] == want["float64"]))
    print(f"[cli] float32 vs float64 labels agree on {100 * agree:.3f}% of "
          f"{CLI_TEST_ROWS} rows", flush=True)
    return launches


def _abort_after(chunks: int):
    """A callback that stops the solve at the end of chunk `chunks`."""
    calls = [0]

    def cb(it, b_hi, b_lo, state):
        calls[0] += 1
        return calls[0] >= chunks
    return cb


def _fresh(path: str) -> str:
    from dpsvm_tpu_torch.utils.checkpoint import checkpoint_generations

    for g in checkpoint_generations(path):
        os.unlink(g)
    return path


def _same_solve(a, b) -> bool:
    return (np.array_equal(a.alpha, b.alpha)
            and np.array_equal(a.stats["f"], b.stats["f"])
            and a.iterations == b.iterations
            and a.stats.get("outer_rounds") == b.stats.get("outer_rounds"))


def phase_state(x, y, cfg, head_res, mesh, oracle, sk_dec) -> dict:
    """Observation, checkpoints and resume on the card.

    (a) The plain headline observed (STATE_RUN: >= STATE_MIN_CHUNKS
    chunks) must be bitwise the unobserved headline; its train_seconds
    are printed beside the unobserved run's. Then it is stopped by a
    callback after chunk STATE_ABORT_CHUNK with a checkpoint at every
    chunk (two generations kept) and resumed from the file: bitwise the
    uninterrupted observed run, B1 once a round over both calls.
    (b) fused_fold (B1 = B2 = rounds), pipeline_rounds (B1 = rounds, B3
    = rounds + chunks), fused_round (B1 = B4 = B5 = rounds) and pallas
    (B6 once a pair) at the oracle configuration, chunked, stopped after
    chunk 3 and resumed: the oracle contract.
    (c) Mesh (b) (ring exchange, B1 = B7 = its rounds) resumed from (a)'s
    one-device checkpoint: converged, n_sv within SV_TOL and signs within
    SIGN_TOL of the one-device headline."""
    import shutil

    from dpsvm_tpu_torch import SVMConfig, decision_function, solve_mesh
    from dpsvm_tpu_torch.models.svm_model import SVMModel
    from dpsvm_tpu_torch.ops.kernels import KernelParams
    from dpsvm_tpu_torch.solver.solve import solve
    from dpsvm_tpu_torch.utils.checkpoint import (checkpoint_generations,
                                                  load_checkpoint_state)

    launches = {}
    scfg = cfg.replace(**STATE_RUN)
    # Unobserved and observed train_seconds in turns, here, so both see
    # the same state of the card and the host.
    turns = {"unobserved": [], "observed": []}
    for kind in ("unobserved", "observed", "observed", "unobserved"):
        cb = (lambda *_: None) if kind == "observed" else None
        turns[kind].append(solve(x, y, scfg, callback=cb).train_seconds)
    print("[state] train_seconds in turns (U, O, O, U): unobserved "
          + ", ".join(f"{t:.4f}" for t in turns["unobserved"])
          + "; observed "
          + ", ".join(f"{t:.4f}" for t in turns["observed"]), flush=True)
    seen = []
    reset_counts()
    obs = solve(x, y, scfg, callback=lambda it, *_: seen.append(it))
    counts = read_counts()
    rounds = obs.stats["outer_rounds"]
    ph = obs.stats["phase_seconds"]
    print(f"[state] observed headline: chunks={obs.stats['chunks']} "
          f"pairs={obs.iterations} rounds={rounds} train_seconds="
          f"{obs.train_seconds:.4f} (unobserved {head_res.train_seconds:.4f}, "
          f"chunks {head_res.stats['chunks']}) phase_seconds "
          + " ".join(f"{k}={v:.4f}" for k, v in ph.items())
          + f" launches={counts}", flush=True)
    if obs.stats["chunks"] < STATE_MIN_CHUNKS or head_res.stats["chunks"] != 1:
        raise AssertionError("[state] chunking: observed "
                             f"{obs.stats['chunks']}, unobserved "
                             f"{head_res.stats['chunks']}")
    if not _same_solve(obs, head_res):
        raise AssertionError("[state] the observed headline is not bitwise "
                             "the unobserved one")
    if counts["solve_subproblem"] != rounds or sum(counts.values()) != rounds:
        raise AssertionError(f"[state] observed: launches {counts}")
    ck = _fresh(os.path.join(smoke_dir(), "state.npz"))
    reset_counts()
    part = solve(x, y, scfg, callback=_abort_after(STATE_ABORT_CHUNK),
                 checkpoint_path=ck)
    gens = checkpoint_generations(ck)
    st = load_checkpoint_state(ck)
    mesh_ck = os.path.join(smoke_dir(), "state_mesh.npz")
    shutil.copyfile(ck, mesh_ck)
    res = solve(x, y, scfg, checkpoint_path=ck, resume=True)
    counts = read_counts()
    launches["state plain"] = counts
    print(f"[state] stopped after chunk {STATE_ABORT_CHUNK}: pairs="
          f"{part.iterations} rounds={part.stats['outer_rounds']} "
          f"train_seconds={part.train_seconds:.4f}; generations "
          f"{[os.path.basename(g) for g in gens]} (newest at pair "
          f"{st.iteration}, round {st.rounds}); resumed: pairs="
          f"{res.iterations} rounds={res.stats['outer_rounds']} "
          f"train_seconds={res.train_seconds:.4f} converged={res.converged} "
          f"launches={counts}", flush=True)
    if part.converged or len(gens) != 2 or st.iteration != part.iterations:
        raise AssertionError("[state] the stopped run did not leave its "
                             "state in two generations")
    if not _same_solve(res, obs):
        raise AssertionError("[state] the resumed headline is not bitwise "
                             "the uninterrupted observed run")
    if counts["solve_subproblem"] != res.stats["outer_rounds"] \
            or sum(counts.values()) != counts["solve_subproblem"]:
        raise AssertionError(f"[state] resumed: launches {counts}")
    print("[state] resumed == uninterrupted, bitwise (alpha, f, pairs, "
          "rounds)", flush=True)

    for label, kw, want in STATE_ORACLE:
        ocfg = SVMConfig(**ORACLE_RUN).replace(checkpoint_every=1, **kw)
        ock = _fresh(os.path.join(smoke_dir(), f"state_{label}.npz"))
        reset_counts()
        part = solve(x, y, ocfg, callback=_abort_after(3),
                     checkpoint_path=ock)
        ores = solve(x, y, ocfg, checkpoint_path=ock, resume=True)
        counts = read_counts()
        launches[f"state {label}"] = counts
        n_run = (ores.stats["outer_rounds"] if "outer_rounds" in ores.stats
                 else ores.iterations)
        n_chunks = part.stats["chunks"] + ores.stats["chunks"]
        expect = {k: want.get(k, lambda n, c: 0)(n_run, n_chunks)
                  for k in counts}
        print(f"[state] {label} oracle config: stopped at pair "
              f"{part.iterations} ({part.stats['chunks']} chunks, "
              f"{part.train_seconds:.4f}s), resumed to {ores.iterations} "
              f"({ores.stats['chunks']} chunks, {ores.train_seconds:.4f}s) "
              f"launches={counts}", flush=True)
        if part.converged:
            raise AssertionError(f"[state] {label}: converged before the "
                                 "stop; nothing was resumed")
        if counts != expect:
            raise AssertionError(f"[state] {label}: launches {counts}, "
                                 f"expected {expect}")
        kp = KernelParams("rbf", ocfg.gamma)
        omodel = SVMModel.from_dense(x, y, ores.alpha, ores.b, kp)
        check_oracle(omodel, ores, x, oracle, sk_dec,
                     f"{label} chunked + resumed", tag="state")

    mcfg = cfg.replace(ring_exchange=True)
    reset_counts()
    mres = solve_mesh(x, y, mcfg, mesh=mesh, checkpoint_path=mesh_ck,
                      resume=True)
    counts = read_counts()
    launches["state mesh"] = counts
    run_rounds = mres.stats["outer_rounds"] - st.rounds
    print(f"[state] mesh (b) {mres.stats['mesh_devices']} resumed from the "
          f"one-device checkpoint at pair {st.iteration}: pairs="
          f"{mres.iterations} rounds={mres.stats['outer_rounds']} "
          f"train_seconds={mres.train_seconds:.4f} launches={counts}",
          flush=True)
    if not mres.converged or run_rounds <= 0 or any(
            counts[k] != (run_rounds if k in ("solve_subproblem",
                                              "ring_gather") else 0)
            for k in counts):
        raise AssertionError(f"[state] mesh resume: converged "
                             f"{mres.converged}, launches {counts} over "
                             f"{run_rounds} rounds")
    kp = KernelParams("rbf", cfg.gamma)
    head_dec = decision_function(
        SVMModel.from_dense(x, y, head_res.alpha, head_res.b, kp), x)
    mdec = decision_function(SVMModel.from_dense(x, y, mres.alpha, mres.b,
                                                 kp), x)
    agree = float(np.mean(np.sign(mdec) == np.sign(head_dec)))
    sv_dev = abs(mres.n_sv - head_res.n_sv) / head_res.n_sv
    print(f"[state] mesh resumed vs one device: n_sv {mres.n_sv} vs "
          f"{head_res.n_sv} ({100 * sv_dev:.2f}%), signs {100 * agree:.3f}%",
          flush=True)
    if sv_dev > SV_TOL or agree < SIGN_TOL:
        raise AssertionError("[state] the mesh resume misses the contract")
    return launches


def f64_gradient(x, y, alpha, gamma: float) -> np.ndarray:
    """f = K (alpha y) - y in float64 from the features, RBF, written out
    here (not the port's gram_matvec_f64) as the independent check."""
    x64 = x.astype(np.float64)
    sq = np.einsum("nd,nd->n", x64, x64)
    coef = alpha.astype(np.float64) * y
    out = np.empty(len(y))
    for s in range(0, len(y), 1024):
        d2 = np.maximum(sq[s:s + 1024, None] + sq[None, :]
                        - 2.0 * x64[s:s + 1024] @ x64.T, 0.0)
        out[s:s + 1024] = np.exp(-gamma * d2) @ coef
    return out - y


def phase_reconstruct() -> dict:
    """The covtype stress configuration (RECON_RUN, make_covtype_like on
    RECON_ROWS rows) in float64 reconstruction legs on the block engine
    (B1 in its block legs) and engine="xla": converged, the reported true
    gap <= 2 eps, and an independent float64 gradient of the returned
    alpha (f64_gradient) certifying the same gap and b."""
    from dpsvm_tpu_torch import SVMConfig, solve
    from dpsvm_tpu_torch.data.synth import make_covtype_like

    x, y = make_covtype_like(RECON_ROWS, seed=0)
    yf = y.astype(np.float64)
    launches = {}
    for label, kw in RECON_LEGS:
        cfg = SVMConfig(**RECON_RUN, **kw)
        reset_counts()
        t0 = time.perf_counter()
        res = solve(x, y, cfg)
        wall = time.perf_counter() - t0
        counts = read_counts()
        launches[f"reconstruct {label}"] = counts
        st = res.stats
        f64 = f64_gradient(x, yf, res.alpha, cfg.gamma)
        a = res.alpha
        up = np.where(y > 0, a < cfg.c, a > 0)
        low = np.where(y > 0, a > 0, a < cfg.c)
        b_hi, b_lo = float(f64[up].min()), float(f64[low].max())
        print(f"[reconstruct] {label} {RECON_ROWS} x 54: converged="
              f"{res.converged} pairs={res.iterations} legs={st['legs']} "
              f"reconstructions={st['reconstructions']} true_gap="
              f"{st['true_gap']:.6g} (independent {b_lo - b_hi:.6g}) "
              f"switch={st['hybrid_switch_pairs']} n_sv={res.n_sv} "
              f"train_seconds={res.train_seconds:.4f} reconstruct_seconds="
              f"{st['reconstruct_seconds']:.4f} wall={wall:.2f}s "
              f"launches={counts}", flush=True)
        if not res.converged or st["true_gap"] > 2 * cfg.epsilon:
            raise AssertionError(f"[reconstruct] {label}: not certified")
        if b_lo - b_hi > 2 * cfg.epsilon + 1e-6 \
                or abs(res.b - (b_hi + b_lo) / 2.0) > 1e-4:
            raise AssertionError(f"[reconstruct] {label}: the independent "
                                 "float64 gradient disagrees")
        kernels = {k for k, v in counts.items() if v}
        if kernels != ({"solve_subproblem"} if label == "block" else set()):
            raise AssertionError(f"[reconstruct] {label}: launches {counts}")
    return launches


def phase_bf16_gram(x, y, cfg, head_res) -> dict:
    """The headline in float32 with bf16_gram=True: the gate's decision
    printed; where it accepts, X is stored in bfloat16, so the solve is
    bitwise the bfloat16 headline, and it meets the whole-solve contract
    (dual within DUAL_RTOL, n_sv within SV_RTOL) against the float32
    solve. B1 once a round."""
    import warnings

    from dpsvm_tpu_torch.solver.solve import solve

    def dual(res):
        a = res.alpha.astype(np.float64)
        yf = y.astype(np.float64)
        return float(a.sum() - 0.5 * np.sum(a * yf * (res.stats["f"] + yf)))

    f32 = cfg.replace(dtype="float32")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        reset_counts()
        res = solve(x, y, f32.replace(bf16_gram=True))
        counts = read_counts()
    gate = res.stats["bf16_gram"]
    ref = solve(x, y, f32)
    d, d_ref = dual(res), dual(ref)
    print(f"[bf16_gram] gate: {gate}; pairs={res.iterations} rounds="
          f"{res.stats['outer_rounds']} train_seconds={res.train_seconds:.4f}"
          f" (float32 {ref.train_seconds:.4f}, {ref.iterations} pairs) "
          f"dual={d:.6f} (float32 {d_ref:.6f}) n_sv={res.n_sv} (float32 "
          f"{ref.n_sv}) launches={counts}", flush=True)
    for w in caught:
        print(f"[bf16_gram] warning: {w.message}", flush=True)
    if counts["solve_subproblem"] != res.stats["outer_rounds"] \
            or sum(counts.values()) != counts["solve_subproblem"]:
        raise AssertionError(f"[bf16_gram] launches {counts}")
    if gate["active"]:
        if not _same_solve(res, head_res):
            raise AssertionError("[bf16_gram] accepted, but the solve is not "
                                 "the bfloat16 headline's")
        if abs(d - d_ref) > DUAL_RTOL * abs(d_ref) \
                or abs(res.n_sv - ref.n_sv) > SV_RTOL * ref.n_sv:
            raise AssertionError("[bf16_gram] misses the whole-solve "
                                 "contract against float32")
    elif not any("REFUSED" in str(w.message) for w in caught):
        raise AssertionError("[bf16_gram] refused without the warning")
    return {"bf16_gram": counts}


# ---- this slice's phases (19-24): multiclass and the fleet, the
# multiclass oracle, precomputed kernels, Platt, the estimators, the
# multiclass and precomputed CLI

# [multiclass]: make_mnist_multiclass (the headline's features, labelled
# by prototype id mod 10), BENCH_MULTICLASS.md's configuration; rows
# 0-49999 train, 50000-59999 are held out.
MC_TRAIN = 50_000
MC_RUN = dict(c=10.0, gamma=0.125, epsilon=0.01, max_iter=2_000_000)
MC_BLOCK = dict(engine="block", working_set_size=256, dtype="bfloat16")
# The block and fleet runs of [multiclass]: (label, strategy, knobs,
# kernel -> launches from the summed outer rounds).
MC_RUNS = (
    ("ovr plain", "ovr", dict(MC_BLOCK), {"solve_subproblem": lambda r: r}),
    ("ovr fused_round", "ovr", dict(MC_BLOCK, fused_round=True),
     {"solve_subproblem": lambda r: r, "gather_gram": lambda r: r,
      "fold_rows_select": lambda r: r}),
    ("ovo plain", "ovo", dict(MC_BLOCK), {"solve_subproblem": lambda r: r}),
    ("ovr fleet", "ovr", dict(fleet_size=16), {}),
    ("ovo fleet", "ovo", dict(fleet_size=16), {}),
)
# Held-out label agreement of a fleet with the block run of its strategy.
MC_AGREE = 0.998
# The whole-solve contract of a fleet submodel against its sequential
# twin (the same config, use_fleet=False): dual, n_sv, b.
TWIN_DUAL_RTOL, TWIN_SV_RTOL, TWIN_DB = 1e-4, 0.02, 5e-3
# [multiclass oracle]: the first 10000 rows (tools/bench_multiclass.py's
# anchor), OvO, float32, at eps = tol / 2 of the oracle's LibSVM tol 0.01.
MC_ORACLE_ROWS = 10_000
MC_ORACLE_RUN = dict(c=10.0, gamma=0.125, epsilon=0.005,
                     max_iter=2_000_000, engine="block",
                     working_set_size=256)
MC_ACC_TOL = 0.002
# [precomputed]: the RBF Gram of the headline data's first PRE_ROWS rows
# (a depth cut: 3.6 GB float32, handed to the API from the host).
PRE_ROWS = 30_000
PRE_RUN = dict(c=10.0, gamma=0.125, epsilon=0.01, max_iter=2_000_000,
               working_set_size=256)
# [estimators] and [cli multiclass] depth cuts.
EST_ROWS = SVR_ROWS
SWEEP_CS = (1.0, 3.0, 10.0, 30.0)
CLI_MC_ROWS = 20_000
CLI_MC_TEST = 2_000
CLI_PRE_ROWS = 2_000


def dual_objective(alpha, f, y) -> float:
    """sum(a) - 1/2 a^T Q a from (alpha, f = K (a y) - y), float64."""
    a = np.asarray(alpha, np.float64)
    yf = np.asarray(y, np.float64)
    return float(a.sum() - 0.5 * np.sum(a * yf * (
        np.asarray(f, np.float64) + yf)))


def twin_contract(label: str, res, twin, y) -> tuple:
    """A fleet result against its sequential twin: both converged, dual
    within TWIN_DUAL_RTOL, n_sv within TWIN_SV_RTOL, |db| <= TWIN_DB.
    Returns (relative dual gap, n_sv gap, |db|)."""
    d, d_t = (dual_objective(r.alpha, r.stats["f"], y) for r in (res, twin))
    rel = abs(d - d_t) / abs(d_t)
    dsv = abs(res.n_sv - twin.n_sv)
    db = abs(res.b - twin.b)
    if not (res.converged and twin.converged and rel <= TWIN_DUAL_RTOL
            and dsv <= max(1, TWIN_SV_RTOL * twin.n_sv) and db <= TWIN_DB):
        raise AssertionError(
            f"{label}: fleet vs sequential twin: converged "
            f"{res.converged}/{twin.converged}, dual rel {rel:.3g}, n_sv "
            f"{res.n_sv}/{twin.n_sv}, |db| {db:.3g}")
    return rel, dsv, db


def fleet_totals(results) -> dict:
    """Trips, host reads and seconds of the fleets behind `results`
    (each fleet counted once, by its first member)."""
    fl = [r.stats["fleet"] for r in results
          if r.stats["fleet"]["index"] == 0]
    return {"fleets": len(fl), "trips": sum(f["trips"] for f in fl),
            "host_reads": sum(f["host_reads"] for f in fl),
            "seconds": sum(f["device_seconds"] for f in fl)}


def mc_counted(label: str, fit, want: dict) -> tuple:
    """fit() -> (MulticlassSVM, results) with every launch count set to 0
    just before and read just after: every submodel converged, and the
    launches exactly `want` from the summed outer rounds (no kernel on
    the fleet). Returns (model, results, counts, wall seconds)."""
    reset_counts()
    t0 = time.perf_counter()
    model, results = fit()
    wall = time.perf_counter() - t0
    counts = read_counts()
    rounds = sum(r.stats.get("outer_rounds", 0) for r in results)
    expect = {k: want.get(k, lambda r: 0)(rounds) for k in counts}
    secs = [r.train_seconds for r in results]
    print(f"[multiclass] {label}: {len(results)} submodels, converged "
          f"{[int(r.converged) for r in results]}, n_sv "
          f"{[r.n_sv for r in results]}, pairs {sum(r.iterations for r in results)}, "
          f"rounds {rounds}, train_seconds sum {sum(secs):.4f} wall "
          f"{wall:.2f}s, launches={counts}", flush=True)
    if not all(r.converged for r in results):
        raise AssertionError(f"{label}: a submodel did not converge")
    if counts != expect or (want and rounds == 0):
        raise AssertionError(f"{label}: launches {counts}, expected {expect}")
    return model, results, counts, wall


def fleet_graph_check(x, y, cfg) -> None:
    """The OvR fleet's first FLEET_TRIPS trips from its start carry, run
    eagerly (one host dispatch a kernel) and as the captured CUDA graph
    (solver/fleet.py FleetGraph): the carries must agree bit for bit;
    both are timed per trip, with a synchronisation on each side."""
    import torch

    from dpsvm_tpu_torch.device import precision_ctx, resolve_device
    from dpsvm_tpu_torch.solver import fleet as tfleet

    dev = resolve_device(None)
    problems = [tfleet.FleetProblem(y=np.where(y == c, 1, -1))
                for c in np.unique(y)]
    trips = tfleet.FLEET_TRIPS
    with precision_ctx(cfg):
        run = tfleet.stage_fleet(x, problems, cfg, dev)
        tfleet.run_fleet_chunk(*run.args, run.state, *run.rest, 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager = tfleet.run_fleet_chunk(*run.args, run.state, *run.rest,
                                       trips)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        graph = tfleet.FleetGraph(*run.args, run.state, *run.rest, trips)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        got = graph.run()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    same = all(torch.equal(a, b) for a, b in zip(eager, got))
    print(f"[multiclass] fleet trips, {len(problems)} OvR problems on "
          f"{len(y)} rows (resident Gram {run.use_gram}): eager "
          f"{1e6 * (t1 - t0) / trips:.1f} us a trip, CUDA graph "
          f"{1e6 * (t3 - t2) / trips:.1f} us a trip (capture "
          f"{t2 - t1:.3f}s) over {trips} trips; carries bitwise {same}",
          flush=True)
    if not same:
        raise AssertionError("the fleet's CUDA graph parts from its eager "
                             "trips")


def phase_multiclass(x_all, y_all) -> dict:
    """[multiclass]: 10-class OvR and OvO on MC_TRAIN rows of the 60000 x
    784 multiclass data, on the plain block engine (B1), OvR on the fused
    round (B1 = B4 = B5) and both through the fleet (no kernel; trips and
    host reads printed). Each run: every submodel converged, n_sv,
    train_seconds, predict seconds and held-out accuracy; its .npz bundle
    reloads and predicts the same labels bit for bit. Each fleet agrees
    with its strategy's block run on >= MC_AGREE of the held-out labels,
    and each fleet submodel meets the whole-solve contract of its
    sequential twin. The fleet's CUDA graph is first held bitwise against
    its eager trips (fleet_graph_check). Returns the launches of each
    run and {"ovr" | "ovo": (model, .npz path)} of the plain block runs,
    which [serve] serves."""
    from dpsvm_tpu_torch import SVMConfig
    from dpsvm_tpu_torch.models.multiclass import (MulticlassSVM,
                                                   predict_multiclass,
                                                   train_multiclass)

    x, y = x_all[:MC_TRAIN], y_all[:MC_TRAIN]
    xh, yh = x_all[MC_TRAIN:], y_all[MC_TRAIN:]
    fleet_graph_check(x, y, SVMConfig(**MC_RUN))
    launches, preds, fleets, served = {}, {}, {}, {}
    for label, strategy, kw, want in MC_RUNS:
        cfg = SVMConfig(**MC_RUN, **kw)
        model, results, counts, wall = mc_counted(
            label, lambda: train_multiclass(x, y, cfg, strategy=strategy,
                                            use_fleet="fleet" in label),
            want)
        launches[f"multiclass {label}"] = counts
        t0 = time.perf_counter()
        pred = predict_multiclass(model, xh)
        pred_s = time.perf_counter() - t0
        path = os.path.join(smoke_dir(), f"mc_{label.replace(' ', '_')}.npz")
        model.save(path)
        same = np.array_equal(predict_multiclass(MulticlassSVM.load(path),
                                                 xh), pred)
        extra = ""
        if "fleet" in label:
            fleets[strategy] = (cfg, results)
            extra = " " + json.dumps(fleet_totals(results))
        print(f"[multiclass] {label}: predict {len(yh)} rows in "
              f"{pred_s:.3f}s, held-out accuracy "
              f"{float(np.mean(pred == yh)):.4f}, union SVs "
              f"{model.compacted.n_union}, .npz reload same labels "
              f"{same}{extra}", flush=True)
        if not same:
            raise AssertionError(f"{label}: the reloaded bundle predicts "
                                 "other labels")
        preds[label] = pred
        if label.endswith("plain"):
            served[strategy] = (model, path)
    for strategy in ("ovr", "ovo"):
        agree = float(np.mean(preds[f"{strategy} fleet"]
                              == preds[f"{strategy} plain"]))
        print(f"[multiclass] {strategy}: fleet vs plain block held-out "
              f"labels agree on {100 * agree:.3f}%", flush=True)
        if agree < MC_AGREE:
            raise AssertionError(f"{strategy}: fleet and block agree on "
                                 f"{agree:.4f} < {MC_AGREE}")
    for strategy, (cfg, results) in fleets.items():
        t0 = time.perf_counter()
        _, twins = train_multiclass(x, y, cfg, strategy=strategy,
                                    use_fleet=False)
        wall = time.perf_counter() - t0
        classes = np.unique(y)
        worst = [0.0, 0, 0.0]
        for res, twin in zip(results, twins):
            tag = res.stats["tag"]
            if tag[0] == "ovr":
                yk = np.where(y == tag[1], 1, -1)
            else:
                sub = y[(y == tag[1]) | (y == tag[2])]
                yk = np.where(sub == tag[1], 1, -1)
            got = twin_contract(f"{strategy} {tag}", res, twin, yk)
            worst = [max(a, b) for a, b in zip(worst, got)]
        print(f"[multiclass] {strategy} fleet vs {len(twins)} sequential "
              f"twins (engine xla, {wall:.2f}s, train_seconds sum "
              f"{sum(t.train_seconds for t in twins):.4f}): worst dual rel "
              f"{worst[0]:.3g}, n_sv gap {worst[1]}, |db| {worst[2]:.3g} "
              f"over {len(classes)} classes", flush=True)
    return launches, served


def phase_multiclass_oracle(x_mc, y_mc) -> dict:
    """[multiclass oracle]: OvO on the first MC_ORACLE_ROWS rows against
    artifacts/oracle_multiclass10k.json (sklearn's LibSVM OvO): the union
    of SVs within SV_TOL of its n_sv and train accuracy >= its acc less
    MC_ACC_TOL. B1 once a round."""
    from dpsvm_tpu_torch import SVMConfig
    from dpsvm_tpu_torch.models.multiclass import (accuracy_multiclass,
                                                   train_multiclass)

    with open(os.path.join(ROOT, "artifacts",
                           "oracle_multiclass10k.json")) as fh:
        oracle = json.load(fh)
    x, y = x_mc[:MC_ORACLE_ROWS], y_mc[:MC_ORACLE_ROWS]
    model, _, counts, _ = mc_counted(
        "oracle ovo", lambda: train_multiclass(
            x, y, SVMConfig(**MC_ORACLE_RUN), strategy="ovo"),
        {"solve_subproblem": lambda r: r})
    n_union = model.compacted.n_union
    acc = accuracy_multiclass(model, x, y)
    dev = abs(n_union - oracle["n_sv"]) / oracle["n_sv"]
    print(f"[multiclass oracle] {MC_ORACLE_ROWS} rows: union SVs {n_union} "
          f"(oracle {oracle['n_sv']}, dev {100 * dev:.2f}%), train accuracy "
          f"{acc:.4f} (oracle {oracle['acc']})", flush=True)
    if dev > SV_TOL or acc < oracle["acc"] - MC_ACC_TOL:
        raise AssertionError("[multiclass oracle] misses the oracle")
    return {"multiclass oracle": counts}


def phase_precomputed(x, y, head_res) -> dict:
    """[precomputed]: the RBF Gram of the first PRE_ROWS rows, built on
    the card and handed to the API from the host, trained with
    kernel="precomputed" on the block engine (B1) and engine="xla" (no
    kernel), each against the RBF solve of the same rows on the same
    engine: converged, n_sv within SV_TOL, training-row signs >=
    SIGN_TOL; the block model's
    .npz reload decides bit for bit. Then gram_resident=True on the
    block engine on the full headline against the plain headline (n_sv,
    signs; whether pairs and rounds are equal). Returns the launches."""
    import torch

    from dpsvm_tpu_torch import SVMConfig, decision_function, train
    from dpsvm_tpu_torch.device import resolve_device, synchronize
    from dpsvm_tpu_torch.models.precomputed import PrecomputedSVCModel
    from dpsvm_tpu_torch.ops.kernels import (KernelParams, resident_gram,
                                             squared_norms)
    from dpsvm_tpu_torch.solver.solve import solve

    launches = {}
    xs = np.ascontiguousarray(x[:PRE_ROWS])
    ys = y[:PRE_ROWS]
    kp = KernelParams("rbf", PRE_RUN["gamma"])
    dev = resolve_device(None)
    t0 = time.perf_counter()
    xd = torch.as_tensor(xs, device=dev)
    g_dev = resident_gram(xd, squared_norms(xd), kp)
    synchronize(dev)
    t1 = time.perf_counter()
    g = g_dev.cpu().numpy()
    t2 = time.perf_counter()
    del g_dev, xd
    print(f"[precomputed] Gram {PRE_ROWS} x {PRE_ROWS} float32 "
          f"({g.nbytes / 1e9:.2f} GB): built on the card in {t1 - t0:.3f}s, "
          f"copied to the host in {t2 - t1:.3f}s", flush=True)
    runs = (("block", {"solve_subproblem": lambda r: r}), ("xla", {}))
    for eng, want in runs:
        # The RBF solve of the same rows on the same engine.
        ref_model, ref, _, _ = counted(
            f"precomputed rbf reference {eng}",
            lambda: train(xs, ys, SVMConfig(**PRE_RUN, engine=eng)), want)
        ref_dec = decision_function(ref_model, xs)
        cfg = SVMConfig(**PRE_RUN, engine=eng, kernel="precomputed")
        t0 = time.perf_counter()
        _, res, counts, _ = counted(
            f"precomputed {eng}", lambda: (None, solve(g, ys, cfg)), want)
        wall = time.perf_counter() - t0
        launches[f"precomputed {eng}"] = counts
        model = PrecomputedSVCModel.from_solution(ys, res.alpha, res.b)
        dec = model.decision_function(g)
        agree = float(np.mean(np.sign(dec) == np.sign(ref_dec)))
        sv_dev = abs(res.n_sv - ref.n_sv) / ref.n_sv
        print(f"[precomputed] {eng}: setup (Gram upload, diagonal) "
              f"{res.stats['phase_seconds']['setup']:.3f}s outside "
              f"train_seconds {res.train_seconds:.4f} (wall {wall:.2f}s); "
              f"n_sv {res.n_sv} vs rbf {ref.n_sv} ({100 * sv_dev:.2f}%), "
              f"signs {100 * agree:.3f}%", flush=True)
        if sv_dev > SV_TOL or agree < SIGN_TOL:
            raise AssertionError(f"[precomputed] {eng} misses the RBF "
                                 "solve's contract")
        if eng == "block":
            path = os.path.join(smoke_dir(), "precomputed30k.npz")
            model.save(path)
            # The file holds b in float32: the model with b rounded so.
            model.b = float(np.float32(model.b))
            same = np.array_equal(
                PrecomputedSVCModel.load(path).decision_function(g),
                model.decision_function(g))
            print(f"[precomputed] .npz reload: decisions bitwise {same}",
                  flush=True)
            if not same:
                raise AssertionError("[precomputed] the .npz reload decides "
                                     "differently")
    del g
    cfg = SVMConfig(**HEADLINE)
    model, res, counts, _ = counted(
        "gram_resident block headline",
        lambda: train(x, y, cfg.replace(gram_resident=True)),
        {"solve_subproblem": lambda r: r})
    launches["gram_resident block"] = counts
    kph = KernelParams("rbf", cfg.gamma)
    from dpsvm_tpu_torch.models.svm_model import SVMModel

    head_dec = decision_function(
        SVMModel.from_dense(x, y, head_res.alpha, head_res.b, kph), x)
    agree = float(np.mean(np.sign(decision_function(model, x))
                          == np.sign(head_dec)))
    sv_dev = abs(res.n_sv - head_res.n_sv) / head_res.n_sv
    print(f"[precomputed] gram_resident=True block on {len(y)} rows "
          f"({4 * len(y) ** 2 / 1e9:.1f} GB Gram): pairs {res.iterations} "
          f"rounds {res.stats['outer_rounds']} (plain {head_res.iterations} / "
          f"{head_res.stats['outer_rounds']}: equal "
          f"{(res.iterations, res.stats['outer_rounds']) == (head_res.iterations, head_res.stats['outer_rounds'])}), "
          f"train_seconds {res.train_seconds:.4f} (plain "
          f"{head_res.train_seconds:.4f}), setup "
          f"{res.stats['phase_seconds']['setup']:.3f}s, n_sv {res.n_sv} vs "
          f"{head_res.n_sv} ({100 * sv_dev:.2f}%), signs {100 * agree:.3f}%",
          flush=True)
    if sv_dev > SV_TOL or agree < SIGN_TOL:
        raise AssertionError("[precomputed] gram_resident misses the plain "
                             "headline's contract")
    from dpsvm_tpu_torch.solver import solve as solve_mod

    solve_mod._GRAM_MEMO.clear()
    return launches


def phase_platt(x, x_mc, y_mc) -> dict:
    """[platt]: the binary headline trained with -b 1 through cli.main
    from [cli]'s CSV file: the file's prob_a / prob_b finite, prob_a > 0
    (P(+1 | f) = 1 / (1 + exp(-(prob_a f + prob_b))) rises with f; LibSVM
    writes A = -prob_a). Tested with -b 1 on [cli]'s test file: every
    probability in [0, 1] and monotone in the model's decision. Then an
    OvR SVC(probability=True) on the first 10000 multiclass rows:
    predict_proba rows sum to 1 within 1e-6. Returns the launches."""
    from dpsvm_tpu_torch import SVMModel, decision_function
    from dpsvm_tpu_torch.estimators import SVC

    out = smoke_dir()
    train_p = os.path.join(out, "train.csv")
    test_p = os.path.join(out, "test.csv")
    model_p = os.path.join(out, "platt.npz")
    reset_counts()
    run_cli(["train", "-f", train_p, "-m", model_p, "-c", "10", "-g",
             "0.125", "-e", "0.01", "--engine", "block",
             "--working-set-size", "256", "--dtype", "bfloat16", "-b", "1",
             "-q"], "platt train")
    counts = read_counts()
    m = SVMModel.load(model_p)
    print(f"[platt] prob_a={m.prob_a!r} prob_b={m.prob_b!r} launches="
          f"{counts} (the model and 5 fold refits)", flush=True)
    if not (np.isfinite(m.prob_a) and np.isfinite(m.prob_b)
            and m.prob_a > 0):
        raise AssertionError("[platt] the calibration is not finite and "
                             "rising")
    if counts["solve_subproblem"] == 0 \
            or sum(counts.values()) != counts["solve_subproblem"]:
        raise AssertionError(f"[platt] launches {counts}")
    out_p = os.path.join(out, "platt_test.out")
    run_cli(["test", "-f", test_p, "-m", model_p, "-b", "1", "-o", out_p],
            "platt test")
    rows = np.loadtxt(out_p, skiprows=1)
    prob = rows[:, 1]
    dec = decision_function(m, x[:CLI_TEST_ROWS])
    order = np.argsort(dec, kind="stable")
    mono = bool(np.all(np.diff(prob[order]) >= 0))
    print(f"[platt] test -b 1: p in [{prob.min():.6f}, {prob.max():.6f}], "
          f"monotone in the decision {mono}", flush=True)
    if prob.min() < 0 or prob.max() > 1 or not mono:
        raise AssertionError("[platt] probabilities outside [0, 1] or not "
                             "monotone in the decision")
    xs, ys = x_mc[:CLI_TEST_ROWS], y_mc[:CLI_TEST_ROWS]
    reset_counts()
    t0 = time.perf_counter()
    est = SVC(C=10.0, gamma=0.125, tol=0.01, engine="block",
              working_set_size=256, probability=True).fit(xs, ys)
    fit_s = time.perf_counter() - t0
    est_counts = read_counts()
    proba = est.predict_proba(xs)
    dev = float(np.max(np.abs(proba.sum(axis=1) - 1.0)))
    acc = float(np.mean(est.classes_[np.argmax(proba, axis=1)] == ys))
    print(f"[platt] OvR SVC(probability=True) on {len(ys)} rows: fit "
          f"{fit_s:.2f}s (10 submodels + 30 fold refits) launches="
          f"{est_counts}; max |row sum - 1| {dev:.3g}; argmax-probability "
          f"accuracy {acc:.4f}", flush=True)
    if dev > 1e-6:
        raise AssertionError("[platt] predict_proba rows do not sum to 1")
    return {"platt cli": counts, "platt SVC ovr": est_counts}


def _same_model(a, b) -> bool:
    """Two models' arrays and offset bit for bit (SVMModel, SVRModel,
    OneClassModel)."""
    coef = "dual_coef" if hasattr(a, "dual_coef") else "coef"
    off = "rho" if hasattr(a, "rho") else "b"
    return (np.array_equal(a.sv_x, b.sv_x)
            and np.array_equal(getattr(a, coef), getattr(b, coef))
            and getattr(a, off) == getattr(b, off))


def phase_estimators(x, y, svr_models) -> dict:
    """[estimators]: SVC, NuSVC, SVR, NuSVR and OneClassSVM fit, predict
    and score on the first EST_ROWS rows (the [svr] phase's cut); each
    estimator's model is its trainer's bit for bit (SVR and NuSVR against
    the [svr] phase's block and xla models of the same configuration).
    svc_c_sweep over SWEEP_CS runs as one fleet. Returns the launches
    and the sweep's fitted estimators (phase 27 holds its warm walk to
    them)."""
    from dpsvm_tpu_torch import (SVMConfig, train, train_nusvc,
                                 train_oneclass)
    from dpsvm_tpu_torch import estimators as est_mod

    xs = np.ascontiguousarray(x[:EST_ROWS])
    ys = y[:EST_ROWS]
    z = svr_target(xs)
    block = dict(engine="block", working_set_size=256)
    common = dict(gamma=0.125, tol=0.01)
    cases = (
        ("SVC", est_mod.SVC(C=10.0, **common, **block), ys,
         lambda cfg: train(xs, ys, cfg)[0], "_binary_model"),
        ("NuSVC", est_mod.NuSVC(nu=NU, **common, max_iter=2_000_000), ys,
         lambda cfg: train_nusvc(xs, ys, NU, cfg)[0], "_model"),
        ("SVR", est_mod.SVR(C=1.0, epsilon=SVR_EPSILON, **common,
                            max_iter=4_000_000, **block), z,
         lambda cfg: svr_models["eps-svr", "block"], "_model"),
        ("NuSVR", est_mod.NuSVR(nu=NU_SVR, C=1.0, **common,
                                max_iter=4_000_000), z,
         lambda cfg: svr_models["nu-svr", "xla"], "_model"),
        ("OneClassSVM", est_mod.OneClassSVM(nu=NU, **common,
                                            max_iter=2_000_000, **block),
         None, lambda cfg: train_oneclass(xs, NU, cfg)[0], "_model"),
    )
    launches = {}
    for name, est, target, twin, attr in cases:
        reset_counts()
        t0 = time.perf_counter()
        est.fit(xs, target)
        fit_s = time.perf_counter() - t0
        counts = read_counts()
        launches[f"estimators {name}"] = counts
        pred = est.predict(xs)
        score = est.score(xs, target) if target is not None else float(
            np.mean(pred > 0))
        cfg = est_mod._base_config(est, 0.125)
        same = _same_model(getattr(est, attr), twin(cfg))
        print(f"[estimators] {name}: fit {fit_s:.2f}s launches={counts} "
              f"score {score:.4f} ({'inlier fraction' if target is None else 'score'}); "
              f"the trainer's model bit for bit: {same}", flush=True)
        if not same:
            raise AssertionError(f"[estimators] {name} is not its "
                                 "trainer's model")
    reset_counts()
    t0 = time.perf_counter()
    fitted = est_mod.svc_c_sweep(xs, ys, SWEEP_CS, **common)
    wall = time.perf_counter() - t0
    counts = read_counts()
    launches["estimators svc_c_sweep"] = counts
    results = [f.fit_result_ for f in fitted]
    print(f"[estimators] svc_c_sweep C={list(SWEEP_CS)}: {wall:.2f}s "
          f"{json.dumps(fleet_totals(results))} converged "
          f"{[r.converged for r in results]} n_sv {[r.n_sv for r in results]}"
          f" scores {[round(f.score(xs, ys), 4) for f in fitted]} "
          f"launches={counts}", flush=True)
    if not all(r.converged for r in results) or sum(counts.values()) \
            or fleet_totals(results)["fleets"] != 1:
        raise AssertionError("[estimators] svc_c_sweep did not run as one "
                             "converged fleet")
    return launches, fitted


def phase_cli_multiclass(x_mc, y_mc, x, y) -> dict:
    """[cli multiclass]: the first CLI_MC_ROWS multiclass rows written as
    CSV, `train --multiclass ovo` (the default engine, through the fleet)
    and `test` on CLI_MC_TEST held-out rows: the -o labels are the API's
    (train_multiclass with the same config); `train -v 5`; and `train
    --kernel precomputed` / `test` on the CLI_PRE_ROWS-row RBF Gram of
    the headline data written as CSV: the labels are the API's. Returns
    the launches."""
    from dpsvm_tpu_torch import SVMConfig
    from dpsvm_tpu_torch.models.multiclass import (predict_multiclass,
                                                   train_multiclass)
    from dpsvm_tpu_torch.models.precomputed import PrecomputedSVCModel
    from dpsvm_tpu_torch.solver.solve import solve

    out = smoke_dir()
    train_p = os.path.join(out, "mc_train.csv")
    test_p = os.path.join(out, "mc_test.csv")
    xt, yt = x_mc[:CLI_MC_ROWS], y_mc[:CLI_MC_ROWS]
    xh = x_mc[MC_TRAIN:MC_TRAIN + CLI_MC_TEST]
    yh = y_mc[MC_TRAIN:MC_TRAIN + CLI_MC_TEST]
    t0 = time.perf_counter()
    write_csv(train_p, xt, yt)
    write_csv(test_p, xh, yh)
    print(f"[cli multiclass] wrote {CLI_MC_ROWS} + {CLI_MC_TEST} rows in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    launches = {}
    model_p = os.path.join(out, "cli_ovo.npz")
    out_p = os.path.join(out, "cli_ovo.out")
    flags = ["-c", "10", "-g", "0.125", "-e", "0.01"]
    reset_counts()
    t0 = time.perf_counter()
    run_cli(["train", "-f", train_p, "-m", model_p, "--multiclass", "ovo",
             "-q", *flags], "cli ovo train")
    run_cli(["test", "-f", test_p, "-m", model_p, "-o", out_p],
            "cli ovo test")
    cli_s = time.perf_counter() - t0
    launches["cli multiclass ovo"] = read_counts()
    got = np.loadtxt(out_p, dtype=np.int64)
    api, _ = train_multiclass(xt, yt, SVMConfig(c=10.0, gamma=0.125,
                                                epsilon=0.01),
                              strategy="ovo")
    want = predict_multiclass(api, xh)
    print(f"[cli multiclass] ovo train + test {cli_s:.2f}s; labels equal "
          f"the API's: {np.array_equal(got, want)}", flush=True)
    if not np.array_equal(got, want):
        raise AssertionError("[cli multiclass] the CLI's labels are not the "
                             "API's")
    reset_counts()
    t0 = time.perf_counter()
    text = run_cli(["train", "-f", train_p, "-m", model_p, "-v", "5", "-q",
                    *flags], "cli -v 5")
    launches["cli multiclass -v 5"] = read_counts()
    print(f"[cli multiclass] -v 5: {time.perf_counter() - t0:.2f}s, "
          f"{_grab(r'(Cross Validation Accuracy = [0-9.]+%)', text, 'cli -v')}",
          flush=True)
    # The precomputed CLI: a CLI_PRE_ROWS-row Gram as CSV.
    xs = x[:CLI_PRE_ROWS].astype(np.float64)
    ys = y[:CLI_PRE_ROWS]
    sq = np.einsum("nd,nd->n", xs, xs)
    g = np.exp(-0.125 * np.maximum(sq[:, None] + sq[None, :]
                                   - 2.0 * xs @ xs.T, 0.0)).astype(np.float32)
    gram_p = os.path.join(out, "gram.csv")
    write_csv(gram_p, g, ys)
    pre_p = os.path.join(out, "cli_pre.npz")
    pre_out = os.path.join(out, "cli_pre.out")
    reset_counts()
    run_cli(["train", "-f", gram_p, "-m", pre_p, "--kernel", "precomputed",
             "-q", "-c", "10", "-e", "0.01"], "cli precomputed train")
    run_cli(["test", "-f", gram_p, "-m", pre_p, "-o", pre_out],
            "cli precomputed test")
    launches["cli precomputed"] = read_counts()
    got = np.loadtxt(pre_out, dtype=np.int64)
    g_file = np.loadtxt(gram_p, delimiter=",", dtype=np.float32)[:, 1:]
    res = solve(g_file, ys, SVMConfig(c=10.0, epsilon=0.01,
                                      kernel="precomputed"))
    want = PrecomputedSVCModel.from_solution(ys, res.alpha,
                                             res.b).predict(g_file)
    print(f"[cli multiclass] precomputed {CLI_PRE_ROWS}-row Gram: labels "
          f"equal the API's: {np.array_equal(got, want)}", flush=True)
    if not np.array_equal(got, want):
        raise AssertionError("[cli multiclass] the precomputed CLI's labels "
                             "are not the API's")
    return launches


# [serve]: the serving stack on the [multiclass] models (trained on rows
# 0-49999) and the [headline] binary model, against the held-out rows.
SERVE_STORAGES = ("f32", "bf16", "int8", "auto")
SERVE_TOL = 1e-5  # rtol and atol of f32 decisions
SERVE_NEAR = 1e-4  # a label may differ only where some |dec| <= this
SERVE_AGREE = 0.998  # bf16 / int8 labels against the f32 ones
SERVE_SIZES = tuple(1 << k for k in range(11))  # request rows 1 ... 1024
SERVE_SWEEP = 2000  # requests a sweep, in groups of 8
SERVE_WIRE = 500  # requests a ServeClient sends
SERVE_PEAK = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}


def near_rows(dec) -> np.ndarray:
    """Rows whose decision has a column within SERVE_NEAR of zero (the
    only rows where float32 summation order may move a label)."""
    return np.abs(np.asarray(dec)).min(axis=1) <= SERVE_NEAR


def labels_agree(got, want, ref_dec, label: str) -> int:
    """Labels equal except on near-zero rows of ref_dec; returns how many
    near rows differ (printed by the caller)."""
    diff = np.asarray(got) != np.asarray(want)
    near = near_rows(ref_dec)
    if (diff & ~near).any():
        raise AssertionError(f"{label}: {int((diff & ~near).sum())} labels "
                             f"differ on rows with every |dec| > "
                             f"{SERVE_NEAR}")
    return int(diff.sum())


def dispatch_ms(srv, bucket: int, reps: int = 10) -> tuple:
    """(device ms between events on the server's stream around one launch,
    host wall ms of launch + wait), medians over `reps` dispatches of a
    seeded (bucket, d) batch."""
    import torch

    qb = np.random.default_rng(bucket).random((bucket, srv.d),
                                              dtype=np.float32)
    srv._union.launch(qb).wait()
    dev, wall = [], []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record(srv.stream)
        pending = srv._union.launch(qb)
        e1.record(srv.stream)
        pending.wait()
        wall.append((time.perf_counter() - t0) * 1e3)
        e1.synchronize()
        dev.append(e0.elapsed_time(e1))
    return float(np.median(dev)), float(np.median(wall))


def phase_serve(x_mc, y_mc, mc_models: dict, head_model, x, smi: str) -> dict:
    """[serve]: (1) PredictServer on the OvO model with f32, bf16, int8
    and auto unions against decision_matrix on the 10000 held-out rows
    (f32 within SERVE_TOL, labels equal but on near-zero rows; bf16 and
    int8 labels >= SERVE_AGREE the f32 ones), the guard's storage and
    risks, dispatch ms at buckets 256 and 4096 beside their bound, and
    the binary headline model's f32 server against decision_function;
    (2) offered_load_sweep per storage; (3) ServingEngine with the OvR
    and OvO bundles, both hot-swapped from an admin thread under load
    (nothing lost, versions advance) and a dispatch_timeout_ms watchdog
    through the serve_stall seam; (4) ServeServer over a ReplicaFleet of
    2 on 127.0.0.1: SERVE_WIRE ServeClient requests, every verdict
    served, labels the in-process engine's, decisions within SERVE_TOL;
    (5) union_nbytes of each storage. Returns the figures."""
    import threading

    from dpsvm_tpu_torch import PredictServer, ServeConfig, decision_function
    from dpsvm_tpu_torch.models.multiclass import (decision_matrix,
                                                   predict_multiclass)
    from dpsvm_tpu_torch.serve import offered_load_sweep, union_nbytes
    from dpsvm_tpu_torch.serving import (ReplicaFleet, ServeClient,
                                         ServeServer, ServingEngine)
    from dpsvm_tpu_torch.testing import faults

    xh = np.ascontiguousarray(x_mc[MC_TRAIN:])
    ovo, ovo_path = mc_models["ovo"]
    _, ovr_path = mc_models["ovr"]
    ens = ovo.compacted
    s_rows, d, k = int(ens.sv_union.shape[0]), int(ens.sv_union.shape[1]), \
        ens.n_models
    rec = {"card": smi, "union_rows": s_rows, "d": d, "columns": k}
    print(f"[serve] OvO model: {k} columns over a {s_rows}-row union, d "
          f"{d}; {len(xh)} held-out rows; {smi}", flush=True)
    t0 = time.perf_counter()
    ref = decision_matrix(ovo, xh)
    ref_lab = predict_multiclass(ovo, xh)
    print(f"[serve] decision_matrix reference in "
          f"{time.perf_counter() - t0:.3f}s; rows with a |dec| <= "
          f"{SERVE_NEAR}: {int(near_rows(ref).sum())}", flush=True)

    # ---- (1) the four unions
    servers, lab32 = {}, None
    for storage in SERVE_STORAGES:
        t0 = time.perf_counter()
        srv = PredictServer(ovo, ServeConfig(union_storage=storage))
        built = time.perf_counter() - t0
        servers[storage] = srv
        t0 = time.perf_counter()
        dec = srv.decision(xh)
        dec_s = time.perf_counter() - t0
        lab = srv.labels(dec)
        err = float(np.max(np.abs(dec - ref)))
        guard = srv.storage_guard
        line = (f"[serve] {storage}: staged {srv.union_storage} (risks "
                f"{guard['risks']}, threshold {guard['threshold']}), built "
                f"+ warmed {built:.2f}s (warm "
                f"{sum(srv.stats['warm_seconds'].values()):.3f}s), "
                f"{len(xh)} rows in {dec_s:.3f}s, max |ddec| vs "
                f"decision_matrix {err:.3g}")
        if srv.union_storage == "f32":
            if not np.allclose(dec, ref, rtol=SERVE_TOL, atol=SERVE_TOL):
                raise AssertionError(f"[serve] {storage}: decisions off "
                                     f"decision_matrix by {err:.3g}")
            n_diff = labels_agree(lab, ref_lab, ref, f"[serve] {storage}")
            line += f"; labels differ on {n_diff} near-zero rows"
            if storage == "f32":
                lab32 = lab
        else:
            agree = float(np.mean(lab == lab32))
            line += f"; labels {100 * agree:.3f}% the f32 ones"
            if agree < SERVE_AGREE:
                raise AssertionError(f"[serve] {storage}: labels agree "
                                     f"{agree:.4f} < {SERVE_AGREE}")
        print(line + f"; {smi}", flush=True)
        rec[storage] = {"staged": srv.union_storage, "risks": guard["risks"],
                        "max_abs_ddec": err, "decision_s": dec_s}
        if storage != "auto":
            for bucket in (256, 4096):
                ms, wall = dispatch_ms(srv, bucket)
                nbytes = (union_nbytes(storage, s_rows, d) + bucket * d * 4
                          + bucket * k * 4)
                b_ms, b_by = bound(nbytes, 2.0 * bucket * s_rows * d,
                                   SERVE_PEAK[storage])
                print(f"[serve] {storage} bucket {bucket}: dispatch "
                      f"{ms:.4f} ms on the stream (wall {wall:.4f} ms), "
                      f"bound {b_ms:.4f} ms ({b_by}); {smi}", flush=True)
                rec[storage][f"bucket{bucket}"] = {
                    "ms": ms, "wall_ms": wall, "bound_ms": b_ms,
                    "bound_by": b_by}
    t0 = time.perf_counter()
    head = PredictServer(head_model, ServeConfig())
    hq = x[:10_000]
    hdec = head.decision(hq)[:, 0]
    href = decision_function(head_model, hq)
    herr = float(np.max(np.abs(hdec - href)))
    print(f"[serve] binary headline ({head.ens.n_union} SVs): f32 server "
          f"{time.perf_counter() - t0:.2f}s, max |ddec| vs "
          f"decision_function {herr:.3g}", flush=True)
    if not np.allclose(hdec, href, rtol=SERVE_TOL, atol=SERVE_TOL):
        raise AssertionError("[serve] the binary server's decisions are "
                             "off decision_function")
    labels_agree(head.predict(hq), np.where(href >= 0, 1, -1), href[:, None],
                 "[serve] binary")

    # ---- (2) offered load
    for storage in ("f32", "bf16", "int8"):
        sw = offered_load_sweep(servers[storage], SERVE_SIZES, SERVE_SWEEP,
                                group=8, seed=1)
        lat = sw["request_latency"]
        per = {b: round(v["p50"] * 1e3, 4)
               for b, v in sw["bucket_latency"].items()}
        print(f"[serve] sweep {storage}: {sw['rows_per_second']} rows/s, "
              f"{sw['requests_per_second']} requests/s, request p50 "
              f"{lat['p50'] * 1e3:.3f} ms p99 {lat['p99'] * 1e3:.3f} ms, "
              f"dispatch p50 ms by bucket {per} ({sw['rows']} rows, "
              f"{sw['wall_seconds']}s); {smi}", flush=True)
        rec[storage]["sweep"] = {"rows_per_second": sw["rows_per_second"],
                                 "p50_ms": lat["p50"] * 1e3,
                                 "p99_ms": lat["p99"] * 1e3,
                                 "bucket_p50_ms": per}
    del servers

    # ---- (3) the v2 engine: hot swaps under load, the watchdog
    paths = {"ovr": ovr_path, "ovo": ovo_path}
    eng = ServingEngine(ServeConfig())
    t0 = time.perf_counter()
    for name, path in paths.items():
        eng.register(name, path)
    reg_s = time.perf_counter() - t0

    def swaps():
        for name, path in paths.items():
            eng.swap(name, path)

    rng = np.random.default_rng(3)
    admin = threading.Thread(target=swaps, name="dpsvm-smoke-swap")
    tickets = {}
    t0 = time.perf_counter()
    for i in range(800):
        name = ("ovr", "ovo")[i % 2]
        n = int(rng.integers(1, 65))
        s = int(rng.integers(0, len(xh) - n))
        tickets[eng.submit(xh[s:s + n], name)] = name
        if i == 200:
            admin.start()
        if i == 600:
            admin.join(timeout=300)
            if admin.is_alive():
                raise AssertionError("[serve] the hot swaps did not finish")
        if i % 4 == 3:
            eng.pump()
    done = eng.drain()
    load_s = time.perf_counter() - t0
    seen = {name: sorted({done[t].version for t in tickets
                          if tickets[t] == name and t in done})
            for name in paths}
    verdicts = sorted({r.verdict for r in done.values()})
    snap = eng.snapshot()
    print(f"[serve] engine: registered OvR and OvO in {reg_s:.2f}s; "
          f"{len(tickets)} requests in {load_s:.2f}s, completed "
          f"{len(done)}, verdicts {verdicts}, versions served {seen}, hot "
          f"swaps {snap['hot_swaps']}, dispatches {snap['dispatches']} "
          f"(coalesced {snap['coalesced_dispatches']}), compiles "
          f"{snap['compiles']}, dispatch wait p50 "
          f"{snap['dispatch_seconds'].get('p50', 0) * 1e3:.3f} ms; {smi}",
          flush=True)
    if sorted(done) != sorted(tickets) or verdicts != ["ok"] \
            or any(v != [1, 2] for v in seen.values()) \
            or snap["hot_swaps"] != 2:
        raise AssertionError("[serve] the hot swap under load lost or "
                             "failed requests, or versions did not advance")
    edec = eng.decision(xh[:2000], "ovo")
    if not np.allclose(edec, ref[:2000], rtol=SERVE_TOL, atol=SERVE_TOL):
        raise AssertionError("[serve] the engine's decisions are off "
                             "decision_matrix")
    eng.close()
    faults.STALL_SECONDS = 2.0
    wd = ServingEngine(ServeConfig(buckets=(16, 64),
                                   dispatch_timeout_ms=500.0))
    wd.register("ovo", ovo_path)
    before = wd.decision(xh[:40], "ovo")
    with faults.install(faults.FaultPlan.parse("serve_stall@1")) as plan:
        t = wd.submit(xh[:40], "ovo")
        t0 = time.perf_counter()
        out = wd.drain()
        bounded = time.perf_counter() - t0
    after = wd.decision(xh[:40], "ovo")
    print(f"[serve] watchdog: serve_stall fired {plan.fired['serve_stall']}, "
          f"verdict {out[t].verdict} in {bounded:.3f}s (bound 0.5 s, stall "
          f"2 s), trips {wd.watchdog_trips.value}, then served again: "
          f"{np.allclose(after, before, rtol=SERVE_TOL, atol=SERVE_TOL)}",
          flush=True)
    if plan.fired["serve_stall"] != 1 or out[t].verdict != "failed" \
            or bounded >= 2.0 or not np.allclose(
                after, before, rtol=SERVE_TOL, atol=SERVE_TOL):
        raise AssertionError("[serve] the watchdog did not bound the stall")
    wd.close()

    # ---- (4) the front door over a fleet of two replicas
    journal = os.path.join(smoke_dir(), "serve.journal")
    if os.path.exists(journal):
        os.remove(journal)
    fleet = ReplicaFleet(ServeConfig(listen="127.0.0.1:0", replicas=2,
                                     journal_path=journal))
    server = ServeServer(fleet)
    ref_eng = ServingEngine(ServeConfig())
    try:
        fleet.register("ovo", ovo_path)
        ref_eng.register("ovo", ovo_path)
        entry = ref_eng.registry.get("ovo")
        rng = np.random.default_rng(4)
        got, rtt = [], []
        with ServeClient(server.host, server.port, seed=0) as cli:
            for i in range(SERVE_WIRE):
                n = int(rng.integers(1, 65))
                s = int(rng.integers(0, len(xh) - n))
                t0 = time.perf_counter()
                v = cli.request(xh[s:s + n], model="ovo",
                                want_decision=i % 2 == 0)
                rtt.append(time.perf_counter() - t0)
                got.append((s, n, v))
        routing = server.replica_snapshot()
        snap = server.close()
    finally:
        fleet.close()
    verdicts = sorted({v.verdict for _, _, v in got})
    near_diff, worst = 0, 0.0
    for s, n, v in got:
        want = ref_eng.decision(xh[s:s + n], "ovo")
        if v.decision is not None:
            worst = max(worst, float(np.max(np.abs(v.decision - want))))
            if not np.allclose(v.decision, want, rtol=SERVE_TOL,
                               atol=SERVE_TOL):
                raise AssertionError("[serve] a wire decision is off the "
                                     "in-process engine's")
        elif v.labels is not None:
            near_diff += labels_agree(v.labels, entry.labels(want), want,
                                      "[serve] wire labels")
    ref_eng.close()
    print(f"[serve] front door: ReplicaFleet of 2 on "
          f"{snap['frames_accepted']} frames, verdicts {verdicts}, served "
          f"by replica {[r['verdicts']['served'] for r in routing]}, "
          f"round trip p50 {np.percentile(rtt, 50) * 1e3:.3f} ms p99 "
          f"{np.percentile(rtt, 99) * 1e3:.3f} ms, max |ddec| vs the "
          f"engine {worst:.3g}, near-zero label differences {near_diff}; "
          f"{smi}", flush=True)
    if verdicts != ["served"] or snap["frames_accepted"] != SERVE_WIRE:
        raise AssertionError(f"[serve] front door verdicts {verdicts}")
    rec["wire"] = {"rtt_p50_ms": float(np.percentile(rtt, 50) * 1e3),
                   "rtt_p99_ms": float(np.percentile(rtt, 99) * 1e3)}

    # ---- (5) union bytes
    sizes = {st: union_nbytes(st, s_rows, d) for st in ("f32", "bf16",
                                                         "int8")}
    print(f"[serve] union bytes ({s_rows} x {d}): {sizes}; int8 cut "
          f"{sizes['f32'] / sizes['int8']:.3f}x of f32", flush=True)
    rec["union_bytes"] = sizes
    print(f"[serve] figures {json.dumps(rec)}", flush=True)
    return rec


# ---- 26-27. out of core, warm starts, the cascade, the learning loop

OOC_TILE = 8192
STREAM_ROWS = 500_000  # the [ooc] (e) stream: 500000 x 784 float32
STREAM_SEED_ROWS = 256  # one query block of the warm fold
PCIE_COPY_BYTES = 2 ** 28  # the plain pinned copy the stream is held to
WARM_BASE = 50_000  # [warm]: rows 0-49999, then the increment
# [warm]'s gated configuration: the oracle's (float32, eps 5e-4).
WARM_RUN = ORACLE_RUN
CASCADE_BLOCK = 16_384
LEARN = dict(d=784, rows=20_000, generations=3, drift=0.1, seed=7)


def agree_gate(label: str, model, ref_model, x, converged: bool = True,
               gate: bool = True, sv_gate: bool = True) -> float:
    """Gate (a): converged, SV count within SV_TOL of the reference model
    and decision signs on all rows of x agreeing at SIGN_TOL (`gate`
    False only reports; `sv_gate` False reports the SV count and gates
    the rest). Returns the sign agreement."""
    from dpsvm_tpu_torch import decision_function

    agree = float(np.mean(np.sign(decision_function(model, x))
                          == np.sign(decision_function(ref_model, x))))
    n_sv, ref_sv = int(model.sv_x.shape[0]), int(ref_model.sv_x.shape[0])
    sv_dev = abs(n_sv - ref_sv) / max(1, ref_sv)
    print(f"[gate] {label}: n_sv {n_sv} (reference {ref_sv}, dev "
          f"{100 * sv_dev:.2f}%) signs agree on {100 * agree:.3f}% of "
          f"{len(x)} rows", flush=True)
    if not gate:
        return agree
    if not converged:
        raise AssertionError(f"{label} did not converge")
    if (sv_gate and sv_dev > SV_TOL) or agree < SIGN_TOL:
        raise AssertionError(f"{label}: n_sv dev {sv_dev:.4f} / sign "
                             f"agreement {agree:.4f} outside the gate")
    return agree


def criterion_met(label: str, res, eps: float) -> None:
    """The stopping rule b_lo <= b_hi + 2 eps on the returned extrema."""
    if not (res.converged and res.b_lo <= res.b_hi + 2.0 * eps + 1e-6):
        raise AssertionError(f"{label}: b_lo {res.b_lo} > b_hi {res.b_hi} "
                             f"+ 2 eps")


def pinned_copy_gbps(nbytes: int = PCIE_COPY_BYTES, reps: int = 5) -> float:
    """Host -> card rate of a plain `copy_` of a pinned buffer (CUDA
    events, best of `reps`): the PCIe bound the ooc stream is held to."""
    import torch

    src = torch.empty(nbytes // 4, dtype=torch.float32, pin_memory=True)
    src.fill_(1.0)
    dst = torch.empty_like(src, device="cuda")
    best = float("inf")
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        dst.copy_(src, non_blocking=True)
        e1.record()
        torch.cuda.synchronize()
        best = min(best, e0.elapsed_time(e1))
    return nbytes / (best * 1e-3) / 1e9


def fold_only_ms(x_tile, f_tile, qx, coef, kp, reps: int = 10) -> float:
    """ms of one tile's fold on a tile already on the card (the stream's
    fold without its copies), CUDA events."""
    from dpsvm_tpu_torch.ops import ooc as ooc_ops
    from dpsvm_tpu_torch.ops.kernels import squared_norms

    qsq = squared_norms(qx)

    def fold():
        ooc_ops.ooc_fold_tile(x_tile, squared_norms(x_tile), f_tile, None,
                              qx, qsq, coef, kp)
    return time_ms(fold, reps)


def write_stream_memmap(path: str, rows: int, d: int, seed: int) -> tuple:
    """A (rows, d) float32 memmap written in 50000-row chunks from a
    seeded RNG; returns (the read-only memmap, seconds)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    mm = np.memmap(path, dtype=np.float32, mode="w+", shape=(rows, d))
    for s in range(0, rows, 50_000):
        e = min(rows, s + 50_000)
        mm[s:e] = rng.standard_normal((e - s, d), dtype=np.float32)
    mm.flush()
    del mm
    # Copy-on-write: readable as any array, never written back.
    return (np.memmap(path, dtype=np.float32, mode="c", shape=(rows, d)),
            time.perf_counter() - t0)


def phase_ooc(x, y, cfg, head_model, head_res, oracle, sk_dec,
              stream_rows: int = STREAM_ROWS) -> tuple:
    """[ooc] X on the host, streamed in OOC_TILE-row tiles.
    (a) the headline with ooc=True: gate (a) against the in-core plain
    headline (converged, SV count within 3%, signs on all rows at
    99.8%), B1 once a round and no other kernel; whether alpha is the
    in-core solve's bit for bit. (b) the oracle configuration with ooc
    against artifacts/oracle60k (check_oracle). (c) the shrunken stream
    and the 512-line cache on the headline: each meets the stopping rule.
    (d) a memmap X stopped after 3 rounds and resumed: bitwise (a).
    (e) one warm_f_rebuild pass over a stream_rows x 784 float32 memmap:
    within rtol 1e-5 of the in-core blocked_kernel_matvec, its GB/s
    against the pinned-copy rate, the fold's share of the pass.
    Returns the launches per path."""
    import torch

    from dpsvm_tpu_torch import SVMConfig, solve, train
    from dpsvm_tpu_torch.device import resolve_device
    from dpsvm_tpu_torch.ops.kernels import (KernelParams,
                                             blocked_kernel_matvec)
    from dpsvm_tpu_torch.solver.warmstart import warm_f_rebuild

    dev = resolve_device(None)
    paths = {}
    ocfg = cfg.replace(ooc=True, ooc_tile_rows=OOC_TILE)
    want_b1 = {"solve_subproblem": lambda r: r}
    model, res, counts, _ = counted("ooc headline",
                                    lambda: train(x, y, ocfg), want_b1)
    paths["ooc headline"] = counts
    st = res.stats
    bitwise = (np.array_equal(res.alpha, head_res.alpha)
               and res.iterations == head_res.iterations)
    print(f"[ooc] (a) headline: pairs={res.iterations} (in-core "
          f"{head_res.iterations}) rounds={st['outer_rounds']} (in-core "
          f"{head_res.stats['outer_rounds']}, its terminal round included) "
          f"B1={counts['solve_subproblem']} tiles={st['tiles_streamed']} "
          f"h2d={st['tile_bytes_h2d'] / 1e9:.3f} GB train_seconds="
          f"{res.train_seconds:.4f} (in-core {head_res.train_seconds:.4f}) "
          f"alpha bitwise the in-core solve's: {bitwise}", flush=True)
    agree_gate("ooc (a) headline", model, head_model, x, res.converged)

    omodel, ores, counts, _ = counted(
        "ooc oracle", lambda: train(x, y, SVMConfig(
            **ORACLE_RUN, ooc=True, ooc_tile_rows=OOC_TILE)), want_b1)
    paths["ooc oracle"] = counts
    check_oracle(omodel, ores, x, oracle, sk_dec, "ooc (b)")

    for label, kw in (("shrink", dict(ooc_shrink=True)),
                      ("cache512", dict(ooc_cache_lines=512))):
        smodel, sres, counts, _ = counted(
            f"ooc {label}", lambda: train(x, y, ocfg.replace(**kw)),
            want_b1)
        paths[f"ooc {label}"] = counts
        criterion_met(f"ooc (c) {label}", sres, cfg.epsilon)
        ss = sres.stats
        print(f"[ooc] (c) {label}: pairs={sres.iterations} rounds="
              f"{ss['outer_rounds']} tiles={ss['tiles_streamed']} "
              f"skipped={ss.get('tiles_skipped', 0)} reconstructions="
              f"{ss.get('shrink_reconstructions', 0)} cycles="
              f"{ss.get('shrink_cycles', 0)} demoted="
              f"{ss.get('shrink_demoted')} all-hit rounds="
              f"{ss['cached_rounds']} hit rate {ss['cache_hit_rate']:.4f} "
              f"train_seconds={sres.train_seconds:.4f}", flush=True)
        agree_gate(f"ooc (c) {label} against the in-core headline",
                   smodel, head_model, x, gate=False)

    out = smoke_dir()
    xm_path = os.path.join(out, "ooc_x.f32")
    mm = np.memmap(xm_path, dtype=np.float32, mode="w+", shape=x.shape)
    mm[:] = x
    mm.flush()
    del mm
    xm = np.memmap(xm_path, dtype=np.float32, mode="r", shape=x.shape)
    ck = _fresh(os.path.join(out, "ooc_resume.npz"))
    rcfg = ocfg.replace(checkpoint_every=10 ** 9)
    reset_counts()
    part = solve(xm, y, rcfg, checkpoint_path=ck, callback=_abort_after(3))
    resumed = solve(xm, y, rcfg, checkpoint_path=ck, resume=True)
    paths["ooc resume"] = read_counts()
    same = (resumed.iterations == res.iterations
            and np.array_equal(resumed.alpha, res.alpha)
            and np.array_equal(resumed.stats["f"], res.stats["f"])
            and resumed.b_hi == res.b_hi and resumed.b_lo == res.b_lo)
    print(f"[ooc] (d) memmap X stopped at {part.iterations} pairs "
          f"({part.stats['outer_rounds']} rounds), resumed from "
          f"{resumed.stats.get('resumed_from')}: {resumed.iterations} pairs, "
          f"bitwise the uninterrupted ooc solve: {same}", flush=True)
    if not same or part.converged:
        raise AssertionError("[ooc] (d) the resumed memmap solve is not "
                             "the uninterrupted one bit for bit")

    d = x.shape[1]
    sm_path = os.path.join(out, "ooc_stream.f32")
    xs, write_s = write_stream_memmap(sm_path, stream_rows, d, seed=11)
    nbytes = stream_rows * d * 4
    print(f"[ooc] (e) wrote {stream_rows} x {d} float32 ({nbytes / 1e9:.3f} "
          f"GB) in {write_s:.2f}s", flush=True)
    ys = np.where(np.arange(stream_rows) % 2 == 0, 1, -1).astype(np.int32)
    kp = KernelParams("rbf", 1.0 / (2 * d))  # exp(-1) at the mean distance
    alpha = np.zeros(stream_rows)
    alpha[np.arange(0, 2 * STREAM_SEED_ROWS, 2)] = 0.5  # y = +1 rows
    passes = []
    for _ in range(2):  # the second pass reads a warm page cache
        t0 = time.perf_counter()
        f = warm_f_rebuild(xs, ys, alpha, kp, tile_rows=OOC_TILE)
        passes.append(time.perf_counter() - t0)
    coef = (alpha * ys).astype(np.float32)
    ref = blocked_kernel_matvec(np.asarray(xs), coef, kp, device=dev)
    got = f + ys
    rel = float(np.max(np.abs(got - ref) / np.abs(ref)))
    print(f"[ooc] (e) stream vs in-core blocked_kernel_matvec: max rel "
          f"{rel:.3g} (K coef in [{float(ref.min()):.4g}, "
          f"{float(ref.max()):.4g}])", flush=True)
    if not rel <= 1e-5:
        raise AssertionError(f"[ooc] (e) stream fold off by rel {rel:.3g}")
    gbps = pinned_copy_gbps()
    tiles = -(-stream_rows // OOC_TILE)
    x_tile = torch.from_numpy(np.ascontiguousarray(xs[:OOC_TILE])).to(dev)
    qx = torch.from_numpy(np.ascontiguousarray(
        xs[:2 * STREAM_SEED_ROWS:2])).to(dev)
    fold_ms = tiles * fold_only_ms(
        x_tile, torch.zeros(len(x_tile), device=dev), qx,
        torch.full((len(qx),), 0.5, device=dev), kp)
    pass_ms = 1e3 * passes[-1]
    bound_ms = nbytes / (gbps * 1e9) * 1e3
    print(f"[ooc] (e) stream: pass {1e3 * passes[0]:.1f} ms cold, "
          f"{pass_ms:.1f} ms warm = {nbytes / passes[-1] / 1e9:.2f} GB/s "
          f"host->card; PCIe bound {bound_ms:.1f} ms at the pinned copy's "
          f"{gbps:.2f} GB/s ({PCIE_COPY_BYTES >> 20} MiB copy_); folds "
          f"{fold_ms:.1f} ms = {100 * fold_ms / pass_ms:.1f}% of the pass",
          flush=True)
    del xs, x_tile
    os.remove(sm_path)
    return paths


def warm_increment(x, y, cfg, label: str, gate: bool) -> tuple:
    """Rows 0-(WARM_BASE-1) trained on `cfg`, then the increment
    concat(sv_x, the rest) cold and warm from seed_from_model; the warm
    model against the cold one on all rows (gated when `gate`). Returns
    (launches per path, the base model, the increment, the cold model,
    the cold result)."""
    from dpsvm_tpu_torch import train
    from dpsvm_tpu_torch.models.svm_model import SVMModel
    from dpsvm_tpu_torch.solver.solve import solve
    from dpsvm_tpu_torch.solver.warmstart import seed_from_model

    want_b1 = {"solve_subproblem": lambda r: r}
    paths = {}
    base, _, paths[f"{label} base"], _ = counted(
        f"{label} base", lambda: train(x[:WARM_BASE], y[:WARM_BASE], cfg),
        want_b1)
    x_inc = np.concatenate([np.asarray(base.sv_x, np.float32),
                            x[WARM_BASE:]])
    y_inc = np.concatenate([np.asarray(base.sv_y, np.int32), y[WARM_BASE:]])

    def fit(tag, **kw):
        def run():
            r = solve(x_inc, y_inc, cfg, **kw)
            return (SVMModel.from_dense(x_inc, y_inc, r.alpha, r.b,
                                        base.kernel), r)
        return counted(f"{label} {tag}", run, want_b1)

    cmodel, cres, paths[f"{label} cold"], _ = fit("cold")
    wmodel, wres, paths[f"{label} warm"], _ = fit(
        "warm", warm_start=seed_from_model(base))
    print(f"[{label}] increment {len(y_inc)} rows "
          f"({base.sv_x.shape[0]} seed SVs of {WARM_BASE} + "
          f"{len(y) - WARM_BASE} fresh), eps {cfg.epsilon}: pairs warm "
          f"{wres.iterations} cold {cres.iterations} (saved "
          f"{cres.iterations - wres.iterations}); rounds warm "
          f"{wres.stats['outer_rounds']} cold {cres.stats['outer_rounds']}; "
          f"train_seconds warm {wres.train_seconds:.4f} cold "
          f"{cres.train_seconds:.4f}; seed "
          f"{ {k: wres.stats['warm_start'][k] for k in ('seed_rows', 'clipped', 'residual')} }",
          flush=True)
    agree_gate(f"{label} warm vs cold", wmodel, cmodel, x, wres.converged,
               gate=gate)
    return paths, base, (x_inc, y_inc), cmodel


def phase_warm(x, y, cfg, est_sweep, csv_path: str, head_model) -> dict:
    """[warm] Warm starts, the cascade, the warm C sweep, the learning
    loop and the CLI. The headline's increment (eps 0.01) is reported:
    there a warm solve stops with seed SVs at small alpha that the cold
    one never raised, so the SV counts part while the decisions agree.
    The gates run at the oracle configuration's eps 5e-4 (WARM_RUN),
    where the optimum's SV set is sharp: rows 0-(WARM_BASE-1), then the
    increment concat(sv_x, the rest) warm from seed_from_model and cold,
    SV count within 3% and signs at 99.8% on all rows; cascade_solve of
    the increment (CASCADE_BLOCK-row blocks, and the learning loop's
    4096) under the same gate against the cold one;
    svc_c_sweep(warm=True) on the block engine against the fleet's
    warm=False sweep at the same tolerance, every C under the gate (the
    same against [estimators]' eps-0.01 sweep, reported); run_learn on a
    synthetic 784-wide stream with the block engine, hot-swapped into a
    ServingEngine, every probe served; `cli learn --smoke`; `cli train
    --ooc` on [cli]'s CSV under gate (a). Returns the launches per
    path."""
    from dpsvm_tpu_torch import ServeConfig, SVMConfig
    from dpsvm_tpu_torch import estimators as est_mod
    from dpsvm_tpu_torch.learn import run_learn, synthetic_stream
    from dpsvm_tpu_torch.models.svm_model import SVMModel
    from dpsvm_tpu_torch.ops.kernels import KernelParams
    from dpsvm_tpu_torch.serving import ServingEngine
    from dpsvm_tpu_torch.solver.cascade import cascade_solve
    from dpsvm_tpu_torch.solver.warmstart import seed_from_model

    paths, _, _, _ = warm_increment(x, y, cfg, "warm headline", gate=False)
    wcfg = SVMConfig(**WARM_RUN)
    more, base, (x_inc, y_inc), cmodel = warm_increment(
        x, y, wcfg, "warm oracle", gate=True)
    paths.update(more)

    for block_rows in (CASCADE_BLOCK, 4096):
        reset_counts()
        t0 = time.perf_counter()
        kres, kst = cascade_solve(x_inc, y_inc, wcfg,
                                  seed=seed_from_model(base),
                                  block_rows=block_rows)
        wall = time.perf_counter() - t0
        paths[f"warm cascade {block_rows}"] = counts = read_counts()
        kmodel = SVMModel.from_dense(x_inc, y_inc, kres.alpha, kres.b,
                                     base.kernel)
        whole = "" if kst["blocks"] else " (the increment fits one)"
        print(f"[warm] cascade, {block_rows}-row blocks: "
              f"{len(kst['blocks'])} blocks{whole}, pairs "
              f"{kst['total_iterations']} (blocks "
              f"{[b['iterations'] for b in kst['blocks']]}, final "
              f"{kst['final_iterations']}, merged SVs {kst['merged_sv']}) in "
              f"{wall:.2f}s launches={counts}", flush=True)
        if counts["solve_subproblem"] < kres.stats["outer_rounds"] or sum(
                v for k, v in counts.items() if k != "solve_subproblem"):
            raise AssertionError("[warm] the cascade did not run on B1 alone")
        agree_gate(f"cascade {block_rows} vs flat", kmodel, cmodel, x,
                   kres.converged)

    xs = np.ascontiguousarray(x[:EST_ROWS])
    ys = y[:EST_ROWS]
    sweep_kw = dict(gamma=0.125, engine="block", working_set_size=256)
    for tol, cold in ((0.01, est_sweep), (WARM_RUN["epsilon"], None)):
        reset_counts()
        t0 = time.perf_counter()
        warm_fits = est_mod.svc_c_sweep(xs, ys, SWEEP_CS, warm=True,
                                        tol=tol, **sweep_kw)
        wall = time.perf_counter() - t0
        paths[f"warm c_sweep tol {tol}"] = counts = read_counts()
        if cold is None:
            t1 = time.perf_counter()
            cold = est_mod.svc_c_sweep(xs, ys, SWEEP_CS, gamma=0.125,
                                       tol=tol)
            print(f"[warm] svc_c_sweep(warm=False) tol {tol}: one fleet "
                  f"in {time.perf_counter() - t1:.2f}s, pairs "
                  f"{[f.fit_result_.iterations for f in cold]}", flush=True)
        print(f"[warm] svc_c_sweep(warm=True) C={list(SWEEP_CS)} tol {tol} "
              f"on the block engine: {wall:.2f}s pairs "
              f"{[f.fit_result_.iterations for f in warm_fits]} launches="
              f"{counts}", flush=True)
        for wf, cf in zip(warm_fits, cold):
            agree_gate(f"c_sweep C={wf.C} tol {tol} warm vs fleet",
                       wf._binary_model, cf._binary_model, xs,
                       wf.fit_result_.converged, gate=cold is not est_sweep)

    lcfg = SVMConfig(c=1.0, gamma=1.0 / LEARN["d"], epsilon=1e-3,
                     max_iter=2_000_000, engine="block", working_set_size=256)
    lkp = KernelParams("rbf", 1.0 / LEARN["d"])
    eng = ServingEngine(ServeConfig(buckets=(64,)))
    reset_counts()
    t0 = time.perf_counter()
    try:
        summary = run_learn(
            synthetic_stream(LEARN["seed"], LEARN["d"], LEARN["rows"],
                             LEARN["generations"], LEARN["drift"]),
            lcfg, os.path.join(smoke_dir(), "learn_models"), lkp,
            cold_baseline=True, engine=eng)
        swaps = eng.hot_swaps.value
    finally:
        eng.close()
    wall = time.perf_counter() - t0
    paths["warm learn"] = counts = read_counts()
    for g in summary["gens"]:
        print(f"[warm] learn gen {g['gen']}: rows={g['rows']} seed_sv="
              f"{g['seed_sv']} sv={g['sv']} pairs={g['pairs']} cold="
              f"{g['pairs_cold']} saved={g['pairs_saved']} probe="
              f"{g['probe_verdict']}", flush=True)
    print(f"[warm] learn: {summary['generations']} generations in "
          f"{wall:.2f}s, {summary['pairs_saved_total']} pairs saved against "
          f"the cold baseline, {swaps} hot swaps, launches={counts}",
          flush=True)
    if (any(g["probe_verdict"] != "ok" for g in summary["gens"])
            or swaps != LEARN["generations"] - 1
            or counts["solve_subproblem"] == 0):
        raise AssertionError("[warm] learn: a probe went unserved or no "
                             "generation ran on B1")

    reset_counts()
    text = run_cli(["learn", "--smoke", "--model-dir",
                    os.path.join(smoke_dir(), "learn_smoke")], "cli learn")
    paths["warm cli learn"] = read_counts()
    if "learn smoke PASS" not in text:
        raise AssertionError("cli learn --smoke did not pass")
    model_p = os.path.join(smoke_dir(), "cli_ooc.npz")
    reset_counts()
    text = run_cli(["train", "-f", csv_path, "-m", model_p, "-c", "10",
                    "-g", "0.125", "-e", "0.01", "--engine", "block",
                    "--working-set-size", "256", "--dtype", "bfloat16",
                    "--ooc", "--ooc-tile-rows", str(OOC_TILE), "-q"],
                   "cli ooc")
    paths["warm cli ooc"] = counts = read_counts()
    rounds = int(_grab(r"\((\d+) rounds\)", text, "cli ooc"))
    if counts["solve_subproblem"] != rounds:
        raise AssertionError(f"cli ooc: B1 {counts} over {rounds} rounds")
    agree_gate("cli train --ooc", SVMModel.load(model_p), head_model, x,
               "converged at iteration" in text)
    return paths


# ---- the rest of the mesh and the active-set engine (phases 28-35)

# [mesh] runs beside (a)-(c), on the headline configuration and data.
MESH_MORE = (
    ("d pipelined ring", dict(pipeline_rounds=True, ring_exchange=True)),
    ("e fused fold", dict(fused_fold=True)),
    ("f active", dict(active_set_size=2048)),
    ("g xla", dict(engine="xla")),
)
ACTIVE_M = 2048  # reconcile_rounds stays at its default, 8
# The fused fold needs q/2 <= n_loc/128 with n_loc padded to 1024: four
# shards of 60000 rows hold 15360, which allows q <= 240 only, so (e)
# runs the headline's q = 256 on two logical shards (n_loc 30720).
FUSED_SHARDS = 2
# [mesh state]: (c) observed in chunks of this many pairs, a file every
# chunk, stopped after the second chunk and resumed in a fresh call.
MESH_STATE_RUN = dict(local_working_sets=4, sync_rounds=2,
                      ring_exchange=True, chunk_iters=4096,
                      checkpoint_every=1)
PREDICT_BLOCK = 8192
PREDICT_ROWS = (50_000, 60_000)
PREDICT_TOL = 1e-5  # rtol and atol (ROADMAP C.24)


def phase_mesh_more(x, y, cfg, mesh, head_model, pair_model) -> dict:
    """[mesh] (d)-(g): the pipelined runner with the ring (B1 a round, B7
    a prefetch), the fused fold (on FUSED_SHARDS logical shards; B1 a
    round, B2 a shard and round), the
    active runner with m = ACTIVE_M (B1 an inner round) and the per-pair
    mesh engine (no kernel), each after a warm-up on 16384 rows: every
    one converged with its derived launches and under gate (a) against
    the plain single-device headline. Then fused_round=True with the
    fused fold: the warning, and (e)'s launches. Returns the launches
    per path."""
    from dpsvm_tpu_torch import train
    from dpsvm_tpu_torch.parallel.mesh import Mesh

    fused_mesh = Mesh([mesh.devices[0]] * FUSED_SHARDS)

    def on(kw):
        return fused_mesh if kw.get("fused_fold") else mesh

    t0 = time.perf_counter()
    for _, kw in MESH_MORE:
        train(x[:16384], y[:16384], cfg.replace(max_iter=2048, **kw),
              backend="mesh", mesh=on(kw))
    print(f"[mesh] warm-up solves of (d)-(g) on 16384 rows in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    paths = {}
    for label, kw in MESH_MORE:
        model, res, counts, _ = train_mesh_counted(x, y, cfg.replace(**kw),
                                                   on(kw), label)
        paths[f"mesh {label}"] = counts
        if kw.get("engine") == "xla":
            # The per-pair engine's optimum at eps 0.01 has its own SV
            # set (phase 6's one-device run keeps 5.7% fewer than the
            # block headline, ROADMAP C.35): its twin is that run.
            agree_gate(f"mesh {label} vs the block headline", model,
                       head_model, x, res.converged, gate=False)
            agree_gate(f"mesh {label} vs the one-device per-pair run",
                       model, pair_model, x, res.converged)
            continue
        # The active cycles stop at eps 0.01 with more small-alpha SVs
        # than the plain engine (ROADMAP C.34): the SV count is reported
        # here and gated at the oracle's eps ([mesh oracle]).
        agree_gate(f"mesh {label}", model, head_model, x, res.converged,
                   sv_gate=not kw.get("active_set_size"))
        if kw.get("fused_fold") and not res.stats["fused_fold"]:
            raise AssertionError("(e) did not run the fused fold")
    _, res, counts, texts = train_mesh_counted(
        x, y, cfg.replace(fused_fold=True, fused_round=True), fused_mesh,
        "e fused fold, fused_round=True")
    if not (res.stats["fused_fold"] and counts["fold_select"]
            and any("single-chip knob" in t for t in texts)):
        raise AssertionError("fused_round=True on the mesh did not warn "
                             "and run the fused fold")
    paths["mesh e fused_round"] = counts
    return paths


def phase_active(x, y, cfg, head_model, oracle, sk_dec) -> dict:
    """[active] The single-device headline with active_set_size=ACTIVE_M
    (after a warm-up on 16384 rows): converged, B1 once an inner round,
    the JAX package's warning, signs at SIGN_TOL against the plain
    headline with the SV count reported (ROADMAP C.34); then the
    oracle configuration with the same m against artifacts/oracle60k
    (the oracle contract, SV count gated)."""
    from dpsvm_tpu_torch import SVMConfig, train

    acfg = cfg.replace(active_set_size=ACTIVE_M)
    train(x[:16384], y[:16384], acfg.replace(max_iter=2048))
    want = {"solve_subproblem": lambda r: r}
    model, res, counts, texts = counted(
        "active", lambda: train(x, y, acfg), want)
    if not any("never beat the plain block" in t for t in texts):
        raise AssertionError("[active] the engine ran without its warning")
    agree_gate("active", model, head_model, x, res.converged, sv_gate=False)
    omodel, ores, ocounts, _ = counted(
        "active oracle", lambda: train(x, y, SVMConfig(
            **ORACLE_RUN, active_set_size=ACTIVE_M)), want)
    check_oracle(omodel, ores, x, oracle, sk_dec, "one device",
                 tag="active oracle")
    return {"active": counts, "active oracle": ocounts}


def phase_mesh_oracle_nu(x, y, mesh) -> dict:
    """[mesh oracle] run (f) at the oracle configuration against
    artifacts/oracle60k; [mesh nu] nu-SVC (nu 0.1) at the oracle
    configuration on the mesh against artifacts/oracle_nu60k, B1 (its
    nu rule) once a round. Returns the launches per path."""
    from dpsvm_tpu_torch import SVMConfig, train_nusvc

    paths = {}
    oracles = {}
    for name in ("oracle60k", "oracle_nu60k"):
        with open(os.path.join(ROOT, "artifacts", f"{name}.json")) as fh:
            meta = json.load(fh)
        with np.load(os.path.join(ROOT, "artifacts", f"{name}.npz")) as z:
            oracles[name] = (meta, np.asarray(z["dec"]))
    cfg = SVMConfig(**ORACLE_RUN, active_set_size=ACTIVE_M)
    model, res, paths["mesh oracle f active"], _ = train_mesh_counted(
        x, y, cfg, mesh, "f active (oracle configuration)",
        tag="mesh oracle")
    check_oracle(model, res, x, *oracles["oracle60k"], "mesh f active",
                 tag="mesh oracle")
    ncfg = SVMConfig(**NU_ORACLE)
    reset_counts()
    model, res = train_nusvc(x, y, NU, ncfg, backend="mesh", mesh=mesh)
    counts = read_counts()
    rounds = res.stats["outer_rounds"]
    print(f"[mesh nu] nu-SVC nu {NU} on {res.stats['mesh_devices']}: "
          f"rounds={rounds} launches={counts} nu_r={res.stats['nu_r']:.6f}",
          flush=True)
    if counts != {**{k: 0 for k in counts}, "solve_subproblem": rounds} \
            or not rounds:
        raise AssertionError(f"[mesh nu] launches {counts} over {rounds} "
                             "rounds")
    check_oracle(model, res, x, *oracles["oracle_nu60k"], "mesh block",
                 tag="mesh nu")
    paths["mesh nu"] = counts
    return paths


def phase_mesh_warm(x, y, mesh) -> dict:
    """[mesh warm] [warm]'s increment at the oracle's eps (WARM_RUN):
    rows 0-(WARM_BASE-1) on one device, then concat(sv_x, the rest) warm
    from seed_from_model on one device and on the mesh (the mesh rebuild,
    warm_rebuild_mesh): the mesh's warm model under gate (a) against the
    single device's."""
    from dpsvm_tpu_torch import SVMConfig, solve_mesh, train
    from dpsvm_tpu_torch.models.svm_model import SVMModel
    from dpsvm_tpu_torch.solver.solve import solve
    from dpsvm_tpu_torch.solver.warmstart import seed_from_model

    cfg = SVMConfig(**WARM_RUN)
    base, _ = train(x[:WARM_BASE], y[:WARM_BASE], cfg)
    x_inc = np.concatenate([np.asarray(base.sv_x, np.float32),
                            x[WARM_BASE:]])
    y_inc = np.concatenate([np.asarray(base.sv_y, np.int32), y[WARM_BASE:]])
    seed = seed_from_model(base)
    one = solve(x_inc, y_inc, cfg, warm_start=seed)
    reset_counts()
    t0 = time.perf_counter()
    res = solve_mesh(x_inc, y_inc, cfg, mesh=mesh, warm_start=seed)
    wall = time.perf_counter() - t0
    counts = read_counts()
    rounds = res.stats["outer_rounds"]
    print(f"[mesh warm] increment {len(y_inc)} rows ({base.sv_x.shape[0]} "
          f"seed SVs): pairs mesh {res.iterations} one device "
          f"{one.iterations}; rounds {rounds}; train_seconds "
          f"{res.train_seconds:.4f} (one device {one.train_seconds:.4f}); "
          f"wall {wall:.2f}s (rebuild included) launches={counts}",
          flush=True)
    if counts["solve_subproblem"] != rounds or not rounds:
        raise AssertionError(f"[mesh warm] launches {counts}")
    models = [SVMModel.from_dense(x_inc, y_inc, r.alpha, r.b, base.kernel)
              for r in (res, one)]
    agree_gate("mesh warm vs one-device warm", *models, x, res.converged)
    return {"mesh warm": counts}


def phase_mesh_state(x, y, cfg, mesh, head_model) -> dict:
    """[mesh state] (c) stopped after its second chunk (a file every
    chunk) and resumed in a fresh call: its launches derived from this
    call's rounds and syncs, converged, gate (a) against the plain
    headline. The [reconstruct] covtype stress in block legs on the
    mesh: certified, gate (a) against the one-device block legs."""
    from dpsvm_tpu_torch import SVMConfig, solve, solve_mesh
    from dpsvm_tpu_torch.data.synth import make_covtype_like
    from dpsvm_tpu_torch.models.svm_model import SVMModel
    from dpsvm_tpu_torch.ops.kernels import KernelParams
    from dpsvm_tpu_torch.utils.checkpoint import load_checkpoint_state

    paths = {}
    scfg = cfg.replace(**MESH_STATE_RUN)
    path = _fresh(os.path.join(smoke_dir(), "mesh_c.npz"))
    reset_counts()
    part = solve_mesh(x, y, scfg, mesh=mesh, checkpoint_path=path,
                      callback=_abort_after(2))
    paths["mesh state c stopped"] = read_counts()
    st = load_checkpoint_state(path)
    print(f"[mesh state] (c) stopped: pairs={part.iterations} chunks="
          f"{part.stats['chunks']} file at pairs {st.iteration} rounds "
          f"{st.rounds} launches={paths['mesh state c stopped']}",
          flush=True)
    if part.converged or st.iteration != part.iterations:
        raise AssertionError("[mesh state] (c) did not stop at its file")
    model, res, paths["mesh state c resumed"], _ = train_mesh_counted(
        x, y, scfg, mesh, "c resumed", tag="mesh state",
        start_rounds=st.rounds, checkpoint_path=path, resume=True)
    agree_gate("mesh state c resumed", model, head_model, x, res.converged)

    xc, yc = make_covtype_like(RECON_ROWS, seed=0)
    lcfg = SVMConfig(**RECON_RUN, engine="block", reconstruct_every=200_000)
    one = solve(xc, yc, lcfg)
    reset_counts()
    legs = solve_mesh(xc, yc, lcfg, mesh=mesh)
    counts = read_counts()
    paths["mesh reconstruct"] = counts
    print(f"[mesh state] covtype stress {RECON_ROWS} rows in legs on the "
          f"mesh: converged={legs.converged} pairs={legs.iterations} "
          f"legs={legs.stats['legs']} true_gap={legs.stats['true_gap']:.6g}"
          f" (one device {one.stats['true_gap']:.6g}, pairs "
          f"{one.iterations}) train_seconds={legs.train_seconds:.4f} "
          f"launches={counts}", flush=True)
    if not legs.converged or legs.stats["true_gap"] > 2 * lcfg.epsilon:
        raise AssertionError("[mesh state] the mesh legs are not certified")
    if {k for k, v in counts.items() if v} != {"solve_subproblem"}:
        raise AssertionError(f"[mesh state] mesh legs launched {counts}")
    kp = KernelParams("rbf", lcfg.gamma)
    agree_gate("mesh legs vs one-device legs",
               *(SVMModel.from_dense(xc, yc, r.alpha, r.b, kp)
                 for r in (legs, one)), xc, legs.converged)
    return paths


def phase_mesh_predict(x, mesh, head_model) -> None:
    """[mesh predict] decision_function_mesh of the headline model on
    rows PREDICT_ROWS against decision_function (rtol / atol
    PREDICT_TOL); ms per PREDICT_BLOCK-row block, the prepared shards
    cached on the model."""
    from dpsvm_tpu_torch import decision_function
    from dpsvm_tpu_torch.predict import decision_function_mesh

    q = x[PREDICT_ROWS[0]:PREDICT_ROWS[1]]
    want = decision_function(head_model, q)
    got = decision_function_mesh(head_model, q, mesh=mesh,
                                 block=PREDICT_BLOCK)
    blocks = -(-len(q) // PREDICT_BLOCK)
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        decision_function_mesh(head_model, q, mesh=mesh, block=PREDICT_BLOCK)
    ms = (time.perf_counter() - t0) * 1e3 / (reps * blocks)
    t0 = time.perf_counter()
    for _ in range(reps):
        decision_function(head_model, q, block=PREDICT_BLOCK)
    ms_one = (time.perf_counter() - t0) * 1e3 / (reps * blocks)
    err = float(np.max(np.abs(got - want)))
    print(f"[mesh predict] {len(q)} rows, {head_model.n_sv} SVs on "
          f"{mesh.describe()}: max |dec diff| {err:.3g}; {ms:.4f} ms per "
          f"{PREDICT_BLOCK}-row block (host clock, the copy back included; "
          f"decision_function {ms_one:.4f})", flush=True)
    if not np.allclose(got, want, rtol=PREDICT_TOL, atol=PREDICT_TOL):
        raise AssertionError("[mesh predict] decision_function_mesh parts "
                             "from decision_function")


def phase_cli_smoke() -> dict:
    """`cli smoke --num-devices 4`: the matvec on the card and the sum
    over four logical shards of it; exit code 0, no kernel launched."""
    from dpsvm_tpu_torch import cli

    reset_counts()
    rc = cli.main(["smoke", "--num-devices", "4"])
    counts = read_counts()
    print(f"[cli smoke] exit code {rc}, launches={counts}", flush=True)
    if rc != 0 or sum(counts.values()):
        raise AssertionError("`cli smoke` failed")
    return {"cli smoke": counts}


def check_tensor_cores() -> None:
    """Count the tensor-core instructions (HMMA) in the SASS of the
    kernels that must do their products on them (MMA_KERNELS), with
    cuobjdump, by instantiation and operand type. The bfloat16 X
    instantiation must hold bf16 HMMAs (m16n8k16) and no other; the
    float32 X one tf32 HMMAs (m16n8k8) and no other, exactly 3 x 2 times
    as many: three products (3xTF32) for each step of half the depth.
    One-pass TF32 would hold a third of them."""
    from dpsvm_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    for src, kernel in MMA_KERNELS:
        sass = subprocess.run([tool, "-sass", _build._lib_path(src)],
                              capture_output=True, text=True,
                              check=True).stdout
        counts, fn = {}, None  # (instantiation, HMMA opcode) -> count
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                fn = (None if kernel not in fn else "bfloat16"
                      if "__nv_bfloat16" in fn else "float32")
            elif fn and "MMA" in line:
                op = next(t for t in line.replace(";", " ").split()
                          if "MMA" in t)
                counts[fn, op] = counts.get((fn, op), 0) + 1
        print(f"[build] {src}: tensor-core instructions in the SASS of "
              f"{kernel}: " + ", ".join(f"{t} X {op} {c}" for (t, op), c
                                        in sorted(counts.items())),
              flush=True)
        per = {t: {op: c for (u, op), c in counts.items() if u == t}
               for t in ("bfloat16", "float32")}
        n_bf16 = sum(per["bfloat16"].values())
        n_tf32 = sum(per["float32"].values())
        ok = (n_bf16 > 0 and all(".BF16" in op for op in per["bfloat16"])
              and all(".TF32" in op for op in per["float32"])
              and n_tf32 == 3 * 2 * n_bf16)
        if not ok:
            raise AssertionError(f"{kernel}: the SASS holds {per}, not bf16 "
                                 "HMMAs and 3 x 2 times as many tf32 ones")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from dpsvm_tpu_torch import SVMConfig, SVMModel, decision_function, train
    from dpsvm_tpu_torch.data.synth import make_mnist_like
    from dpsvm_tpu_torch.device import resolve_device
    from dpsvm_tpu_torch.ops import _build
    from dpsvm_tpu_torch.ops.kernels import (KernelParams, kernel_diag,
                                             squared_norms)
    from dpsvm_tpu_torch.solver.smo import init_state

    t_start = time.perf_counter()

    def lap(phase: str) -> None:
        print(f"[time] {phase} done at "
              f"{time.perf_counter() - t_start:.1f}s", flush=True)

    # ---- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = resolve_device(None)
    print(f"[device] {torch.cuda.get_device_name(0)} | {smi} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    # ---- 2. build
    t0 = time.perf_counter()
    reports = _build.build(SOURCES)
    print(f"[build] {', '.join(SOURCES)} in {time.perf_counter() - t0:.2f}s",
          flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry" in line):
                print(f"[build] {name}: {line.strip()}", flush=True)
    check_tensor_cores()

    # ---- data
    t0 = time.perf_counter()
    x, y = make_mnist_like(n=60_000, d=784, seed=7, noise=0.1)
    print(f"[data] 60000 x 784 in {time.perf_counter() - t0:.2f}s", flush=True)
    cfg = SVMConfig(**HEADLINE)
    kp = KernelParams("rbf", cfg.gamma)
    c = cfg.c_bounds()
    tau = float(cfg.tau)
    q = cfg.working_set_size
    x_dev = torch.as_tensor(x, device=dev).to(torch.bfloat16)
    y_dev = torch.as_tensor(y.astype(np.float32), device=dev)
    x_sq = squared_norms(x_dev)
    k_diag = kernel_diag(x_sq, kp)
    alpha0, f0, _, _ = init_state(y_dev)

    # ---- 3. headline solve (its end state feeds phase 4), after a short
    # warm-up solve with each engine so train_seconds leaves out one-time
    # CUDA set-up.
    t0 = time.perf_counter()
    for knob in (None, *ENGINES):  # 16384 rows: q/2 <= n_pad/128 holds
        kw = {knob: True} if knob else {}
        train(x[:16384], y[:16384], cfg.replace(max_iter=2048, **kw))
    print(f"[headline] warm-up solves on 16384 rows (plain and each fused "
          f"engine) in {time.perf_counter() - t0:.2f}s", flush=True)
    model, res, counts, _ = counted(
        "headline", lambda: train(x, y, cfg),
        {"solve_subproblem": lambda r: r})
    head_model, head_res = model, res
    launches = {"solve_subproblem": counts["solve_subproblem"]}
    f_end = torch.as_tensor(res.stats["f"], device=dev)
    a_end = torch.as_tensor(res.alpha, device=dev)
    # ---- 4. kernels against their plain versions
    states = {"start": (alpha0, f0, cfg.epsilon),
              "converged@eps1e-3": (a_end, f_end, 1e-3)}
    rec = {"solve_subproblem": phase_kernels(
        dev, x_dev, y_dev, x_sq, k_diag, states, kp, c, tau, reps=20)}
    n_pad = -(-len(y) // 1024) * 1024
    y_pad = pad_rows(y_dev, n_pad, 1.0)
    valid = pad_rows(torch.ones_like(y_dev, dtype=torch.bool), n_pad, 0)
    xs = {"bfloat16": pad_rows(x_dev, n_pad, 0.0),
          "float32": pad_rows(torch.as_tensor(x, device=dev), n_pad, 0.0)}
    padded = {"start": (pad_rows(alpha0, n_pad, 0.0),
                        pad_rows(f0, n_pad, -1.0)),
              "converged@eps1e-3": (pad_rows(a_end, n_pad, 0.0),
                                    pad_rows(f_end, n_pad, -1.0))}
    rec.update(phase_fused_kernels(xs, y_pad, valid, padded, kp, c, tau, q,
                                   reps=10))
    del xs, padded
    stages = {"plain": phase_stages(x, y, cfg, PLAIN_STAGES, "headline")}

    lap("headline, kernels B1-B5, stages")

    # ---- 5. the fused engines on the headline
    for knob, want in ENGINES.items():
        _, eres, counts, _ = counted(
            f"engines {knob}",
            lambda: train(x, y, cfg.replace(**{knob: True})), want)
        for name in want:
            if name != "solve_subproblem":
                launches[name] = counts[name]
        print(f"[engines] {knob}: pairs={eres.iterations} (plain "
              f"{res.iterations}) rounds={eres.stats['outer_rounds']} (plain "
              f"{res.stats['outer_rounds']}) train_seconds="
              f"{eres.train_seconds:.4f} (plain {res.train_seconds:.4f})",
              flush=True)
    for knob, st in (("fused_round", FUSED_ROUND_STAGES),
                     ("fused_fold", FUSED_FOLD_STAGES),
                     ("pipeline_rounds", PIPELINE_STAGES)):
        stages[knob] = phase_stages(x, y, cfg.replace(**{knob: True}), st,
                                    knob)

    lap("fused engines")

    # ---- 6. the per-pair engines on the headline
    t0 = time.perf_counter()
    for _, kw in PER_PAIR:
        train(x[:16384], y[:16384], cfg.replace(max_iter=300, **kw))
    print(f"[perpair] warm-up solves on 16384 rows in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    pair_res = {}
    for label, kw in PER_PAIR:
        _, pres, counts = train_pair_counted(x, y, cfg.replace(**kw), label)
        pair_res[label] = pres
        if label == "pallas":
            launches["fused_update_select"] = counts["fused_update_select"]
    if not pair_res["xla"].stats["gram_resident"]:
        raise AssertionError("engine='xla' did not run on the resident Gram "
                             "at 60000 rows")
    if pair_res["xla cache512"].stats["cache_lookups"] == 0:
        raise AssertionError("the cached per-pair run made no lookups")
    for eng in ("xla", "pallas"):
        phase_pair_stages(x, y, cfg.replace(engine=eng), PAIR_STAGES[eng],
                          eng)

    # ---- 7. kernel B6 at the padded per-pair shape
    n_pad6 = -(-len(y) // 8192) * 8192
    y_pad6 = pad_rows(y_dev, n_pad6, 1.0)
    valid6 = pad_rows(torch.ones_like(y_dev, dtype=torch.bool), n_pad6, 0)
    a_pp = torch.as_tensor(pair_res["xla"].alpha, device=dev)
    f_pp = torch.as_tensor(pair_res["xla"].stats["f"], device=dev)
    rec["fused_update_select"] = phase_b6(
        pad_rows(x_dev, n_pad6, 0.0), y_pad6, valid6,
        {"start": (pad_rows(alpha0, n_pad6, 0.0), pad_rows(f0, n_pad6, -1.0)),
         "perpair_end": (pad_rows(a_pp, n_pad6, 0.0),
                         pad_rows(f_pp, n_pad6, -1.0))},
        c, tau, reps=20)

    lap("per-pair engines, B6")

    # ---- 8. the ring kernels on logical shards
    rec["ring_gather"] = phase_ring_gather(dev, reps=20)
    x_f32 = torch.as_tensor(x, device=dev)
    rec["ring_fold_window"] = phase_ring_fold(x_f32, x_dev, y_dev, c, tau, q,
                                              reps=5)
    del x_f32

    lap("ring kernels B7, B8")

    # ---- 9. the mesh block engines on four logical shards
    mesh_launches, mesh = phase_mesh(x, y, cfg, dev)
    launches.update(mesh_launches)

    lap("mesh runs")

    # ---- 10, 11. oracle
    with open(os.path.join(ROOT, "artifacts", "oracle60k.json")) as fh:
        oracle = json.load(fh)
    with np.load(os.path.join(ROOT, "artifacts", "oracle60k.npz")) as z:
        sk_dec = np.asarray(z["dec"])
    reset_counts()
    model, ores = train(x, y, SVMConfig(**ORACLE_RUN, ring_exchange=True),
                        backend="mesh", mesh=mesh)
    counts = read_counts()
    if not (counts["ring_gather"] == counts["solve_subproblem"]
            == ores.stats["outer_rounds"] > 0):
        raise AssertionError(f"mesh oracle: launches {counts} over "
                             f"{ores.stats['outer_rounds']} rounds")
    check_oracle(model, ores, x, oracle, sk_dec,
                 f"mesh {ores.stats['mesh_devices']} ring")
    for label, kw in ORACLE_ENGINES:  # the plain model is saved below
        model, ores = train(x, y, SVMConfig(**{**ORACLE_RUN, **kw}))
        dec = check_oracle(model, ores, x, oracle, sk_dec, label)
    out_dir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    for ext in ("txt", "npz"):
        path = os.path.join(out_dir, f"model60k.{ext}")
        model.save(path)
        diff = float(np.max(np.abs(
            decision_function(SVMModel.load(path), x) - dec)))
        print(f"[oracle] reloaded .{ext}: max |dec diff| = {diff:.3g}",
              flush=True)
        if diff > 1e-6:
            raise AssertionError(f".{ext} round trip changed decisions")
    lap("oracle runs")

    # ---- 12-14. the model families
    nu_rec, nu_counts = phase_nu(x, y, dev, x_dev, y_dev, x_sq, k_diag, kp,
                                 tau)
    rec["solve_subproblem"]["nu"] = {
        **nu_rec, "launches": nu_counts["solve_subproblem"],
        "main_path": "nu headline (train_nusvc, block engine)"}
    lap("nu-SVC: headline, kernel B1 nu, oracle runs")
    phase_oneclass(x)
    lap("one-class")
    svr_models = phase_svr(x)
    lap("SVRs")

    # ---- 15-18. the CLI and data surface, solver state, reconstruction
    # legs, the bf16 Gram gate
    paths = {f"cli {k}": v
             for k, v in phase_cli(x, y, head_model, head_res).items()}
    lap("CLI from CSV and LIBSVM files")
    paths.update(phase_state(x, y, cfg, head_res, mesh, oracle, sk_dec))
    lap("state: observed, stopped, resumed")
    paths.update(phase_reconstruct())
    lap("reconstruction legs")
    paths.update(phase_bf16_gram(x, y, cfg, head_res))
    lap("bf16 Gram gate")

    # ---- 19-24. multiclass and the fleet, precomputed kernels, Platt,
    # the estimators, the multiclass and precomputed CLI
    from dpsvm_tpu_torch.data.synth import make_mnist_multiclass

    x_mc, y_mc = make_mnist_multiclass(n=60_000, d=784, seed=7, noise=0.1)
    mc_paths, mc_models = phase_multiclass(x_mc, y_mc)
    paths.update(mc_paths)
    lap("multiclass")
    paths.update(phase_multiclass_oracle(x_mc, y_mc))
    lap("multiclass oracle")
    paths.update(phase_precomputed(x, y, head_res))
    lap("precomputed")
    paths.update(phase_platt(x, x_mc, y_mc))
    lap("platt")
    est_paths, est_sweep = phase_estimators(x, y, svr_models)
    paths.update(est_paths)
    lap("estimators")
    paths.update(phase_cli_multiclass(x_mc, y_mc, x, y))
    lap("cli multiclass")

    # ---- 25. serving
    reset_counts()
    phase_serve(x_mc, y_mc, mc_models, head_model, x, smi)
    paths["serve"] = read_counts()
    print(f"[serve] kernel launches in the phase: {paths['serve']} (no "
          f"TPU kernel lies on the serving path)", flush=True)
    lap("serve")

    # ---- 26, 27. out of core; warm starts, the cascade, the learning
    # loop
    print(f"[ooc] {smi}", flush=True)
    paths.update(phase_ooc(x, y, cfg, head_model, head_res, oracle, sk_dec))
    lap("ooc")
    print(f"[warm] {smi}", flush=True)
    paths.update(phase_warm(x, y, cfg, est_sweep,
                            os.path.join(smoke_dir(), "train.csv"),
                            head_model))
    lap("warm")

    # ---- 28-35. the rest of the mesh and the active-set engine
    print(f"[mesh] {smi}", flush=True)
    pair_model = SVMModel.from_dense(x, y, pair_res["xla"].alpha,
                                     pair_res["xla"].b, head_model.kernel)
    paths.update(phase_mesh_more(x, y, cfg, mesh, head_model, pair_model))
    lap("mesh (d)-(g)")
    paths.update(phase_active(x, y, cfg, head_model, oracle, sk_dec))
    lap("active")
    paths.update(phase_mesh_oracle_nu(x, y, mesh))
    lap("mesh oracle, mesh nu")
    paths.update(phase_mesh_warm(x, y, mesh))
    lap("mesh warm")
    paths.update(phase_mesh_state(x, y, cfg, mesh, head_model))
    lap("mesh state")
    phase_mesh_predict(x, mesh, head_model)
    paths.update(phase_cli_smoke())
    lap("mesh predict, cli smoke")

    meta = {
        "solve_subproblem": ("subproblem.cu",
                             "dpsvm_tpu/ops/pallas_subproblem.py:253"),
        "fold_select": ("fold_select.cu",
                        "dpsvm_tpu/ops/pallas_fold_select.py:143"),
        "select_rows": ("fold_select.cu",
                        "dpsvm_tpu/ops/pallas_fold_select.py:196"),
        "gather_gram": ("gather_gram.cu", "dpsvm_tpu/ops/pallas_round.py:158"),
        "fold_rows_select": ("fold_select.cu",
                             "dpsvm_tpu/ops/pallas_round.py:234"),
        "fused_update_select": ("fused_update.cu",
                                "dpsvm_tpu/ops/pallas_fused.py:105"),
        "ring_gather": ("ring.cu", "dpsvm_tpu/ops/ring.py:139"),
        "ring_fold_window": ("ring.cu", "dpsvm_tpu/ops/ring.py:241"),
    }
    kernels = []
    for name, (src, replaces) in meta.items():
        r = rec[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"dpsvm_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"),
            **{k: r[k] for k in ("launch_floor_ms", "contraction_ms",
                                 "serial_trips") if k in r},
            "path_launches": {p: c[name] for p, c in paths.items()
                              if c[name]},
            **({"nu": r["nu"]} if "nu" in r else {})})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def b6_turns_inputs(n_pad: int, dev) -> tuple:
    """B6's (f, alpha, y, valid, d_hi, d_lo, x_sq) views and scalars for
    --turns: alpha at 0, C and inside the box, the last 400 rows padding."""
    import torch

    rng = np.random.default_rng(6)
    shp = (n_pad // 128, 128)
    y = np.where(rng.random(n_pad) < 0.5, 1.0, -1.0)
    alpha = np.where(rng.random(n_pad) < 0.5, 0.0, rng.random(n_pad) * 10)
    valid = np.ones(n_pad)
    valid[-400:] = 0.0
    vecs = [rng.normal(size=n_pad), alpha, y, valid,
            rng.normal(size=n_pad) * 50, rng.normal(size=n_pad) * 50,
            np.abs(rng.normal(size=n_pad)) * 100]
    views = [torch.as_tensor(v.astype(np.float32).reshape(shp), device=dev)
             for v in vecs]
    return views, torch.tensor([0.37, -0.21, 96.0, 101.0], device=dev)


def b5_turns_inputs(q: int, n_pad: int, dev) -> tuple:
    """B5's (k_rows, coef, (f, err, alpha, y, valid)) for --turns: kernel
    rows in [0, 1), every seventh coefficient dead."""
    import torch

    rng = np.random.default_rng(5)
    shp = (n_pad // 128, 128)
    k_rows = torch.rand((q, n_pad), device=dev,
                        generator=torch.Generator(dev).manual_seed(5))
    coef = rng.normal(size=q).astype(np.float32) * 0.1
    coef[::7] = 0.0
    y = np.where(rng.random(n_pad) < 0.5, 1.0, -1.0)
    alpha = np.where(rng.random(n_pad) < 0.5, 0.0, rng.random(n_pad) * 10)
    vecs = [rng.normal(size=n_pad), rng.normal(size=n_pad) * 1e-7, alpha,
            y, np.ones(n_pad)]
    views = [torch.as_tensor(v.astype(np.float32).reshape(shp), device=dev)
             for v in vecs]
    return k_rows, torch.as_tensor(coef, device=dev), views


def time_clean_ms(fn, reps: int) -> float:
    """time_cold_ms with a flush that reads 256 MB in place of writing it,
    so L2 holds clean lines: the difference between the two is what
    writing back the dirty lines costs."""
    import torch

    flush = torch.zeros(2 ** 26, dtype=torch.float32, device="cuda")
    fn()
    total = 0.0
    for _ in range(reps):
        flush.sum()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        total += e0.elapsed_time(e1)
    return total / reps


def host_us(fn, calls: int = 1000) -> float:
    """The host's microseconds a call of fn(), over `calls` calls enqueued
    in four batches, each behind a device-side spin long enough that the
    card never drains the queue (so the host never waits on it)."""
    import torch

    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(4):
        torch.cuda._sleep(SPIN_CYCLES * 50)
        t0 = time.perf_counter()
        for _ in range(calls // 4):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return 1e6 * total / (4 * (calls // 4))


# The sizes --turns times B2 and B3 at: the 60000-row headline (n_pad
# 60416) and the JAX package's covtype-scale configuration
# (BENCH_COVTYPE.md: n 500000, n_pad 500736).
B23_ROWS = (472, 3912)


def b23_turns_inputs(rows: int, dev) -> list:
    """(f, err, alpha, y, valid, delta) (rows, 128) views for B2 and B3:
    alpha at 0, C and inside the box, the last 400 elements padding."""
    import torch

    rng = np.random.default_rng(rows)
    n = rows * 128
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0)
    pick = rng.integers(0, 3, n)
    alpha = np.where(pick == 0, 0.0, np.where(pick == 1, 10.0,
                                              rng.random(n) * 10))
    valid = np.ones(n)
    valid[-400:] = 0.0
    vecs = [rng.normal(size=n), rng.normal(size=n) * 1e-7, alpha, y, valid,
            rng.normal(size=n) * 0.05]
    return [torch.as_tensor(v.astype(np.float32).reshape(rows, 128),
                            device=dev) for v in vecs]


def b23_bytes(kernel: str, rows: int) -> int:
    """Bytes B2 / B3 must move: each input read once, each output written
    once (float32 vectors of rows x 128, four 32-bit candidate words a
    row)."""
    vec = 4 * 128 * rows
    return {"b3": 4, "b2": 6, "b2_comp": 8}[kernel] * vec + 16 * rows


# B2 and B3's stamps (csrc/fold_select.cu, built with -DDPSVM_STAMPS).
STAMPS = ("start", "loaded", "reduced", "stored", "acked")


def stamp_split(run, so, rows: int, flush: str, reps: int) -> dict:
    """Where a B2 / B3 launch spends its time, from the timing build's
    stamps: run(so) launches it behind a 256 MB flush that writes
    (`flush` "dirty") or reads ("clean") and a device spin. For each
    stamp, the ns from the first row's start to the first and to the
    last row reaching it (%globaltimer, across SMs); for each phase
    between stamps, the median and largest cycles a row spends in it
    (clock64, one SM). Medians over `reps` launches."""
    import ctypes

    import torch

    buf = torch.empty(2 ** 26, dtype=torch.float32, device="cuda")
    host = (ctypes.c_ulonglong * (4096 * len(STAMPS) * 2))()
    per = []
    for _ in range(reps):
        if flush == "dirty":
            buf.zero_()
        else:
            buf.sum()
        torch.cuda._sleep(SPIN_CYCLES)
        run(so)
        torch.cuda.synchronize()
        if so.stamps(host) != 0:
            raise RuntimeError("reading the stamps failed")
        a = np.frombuffer(host, dtype=np.uint64).astype(np.int64)
        a = a.reshape(4096, len(STAMPS), 2)[:rows]
        gt, clk = a[:, :, 0], a[:, :, 1]
        t0 = gt[:, 0].min()
        cyc = np.diff(clk, axis=1)
        per.append(np.concatenate([gt.min(axis=0) - t0, gt.max(axis=0) - t0,
                                   np.median(cyc, axis=0),
                                   cyc.max(axis=0)]))
    med = np.median(np.array(per), axis=0)
    k = len(STAMPS)
    phases = [f"{a}->{b}" for a, b in zip(STAMPS, STAMPS[1:])]
    return {"first_ns": dict(zip(STAMPS, med[:k].tolist())),
            "last_ns": dict(zip(STAMPS, med[k:2 * k].tolist())),
            "row_cycles_median": dict(zip(phases, med[2 * k:3 * k - 1]
                                          .tolist())),
            "row_cycles_max": dict(zip(phases, med[3 * k - 1:].tolist()))}


# Other launch plans --turns times beside the kept ones (this checkout
# only): B6's threads a block, one group of four a thread; B5's (warps,
# chunk, stages), q 256; B2 and B3's warps (rows) a block
# (ops/fold_select.py fold_select_plan).
B6_THREADS = (32, 64, 128, 256)
B5_PLANS = ((4, 8, 3), (8, 4, 3), (4, 8, 2), (2, 16, 3), (4, 4, 3))
B23_WARPS = (1, 2, 4, 8)


def turns_b23(fs, rows: int, dev, reps: int, rec: dict) -> dict:
    """B3, B2 and B2 compensated at `rows` rows on seeded views, through
    the package's public wrappers: ms behind the writing flush, behind a
    reading flush and back to back with no flush, and the wrapper's host
    us a call. Then each in the pair it forms on the main path, behind
    the writing flush: B2 after the alpha scatter it follows in a
    fused-fold round, B3 after the kernel that writes its f (f - err, the
    compensated pipelined prefetch). Adds them to `rec`; returns
    {kernel: call}."""
    import torch

    from dpsvm_tpu_torch.solver.block import scatter_alpha

    f2d, e2d, a2d, y2d, v2d, d2d = b23_turns_inputs(rows, dev)
    calls = {
        "b3": functools.partial(fs.select_rows, f2d, a2d, y2d, v2d, 10.0),
        "b2": functools.partial(fs.fold_select, f2d, None, a2d, y2d, v2d,
                                d2d, 10.0),
        "b2_comp": functools.partial(fs.fold_select, f2d, e2d, a2d, y2d,
                                     v2d, d2d, 10.0, compensated=True)}
    for name, fn in calls.items():
        key = f"{name}_{rows}"
        rec[f"{key}_ms"] = time_cold_ms(fn, reps)
        rec[f"{key}_ms_clean_flush"] = time_clean_ms(fn, reps)
        rec[f"{key}_warm_ms"] = time_ms(fn, reps)
        rec[f"{key}_host_us"] = host_us(fn)
        rec[f"{key}_bound_ms"] = b23_bytes(name, rows) / HBM_BYTES_PER_S * 1e3

    n = rows * 128
    w = torch.arange(0, n, n // 256, device=dev)[:256]
    ok = torch.ones(256, dtype=torch.bool, device=dev)
    a_w = torch.full((256,), 0.5, device=dev)
    eff = torch.empty_like(f2d)

    def pair2():
        alpha = scatter_alpha(a2d.view(-1), w, ok, a_w).view(f2d.shape)
        return fs.fold_select(f2d, None, alpha, y2d, v2d, d2d, 10.0)

    def pair3():
        torch.sub(f2d, e2d, out=eff)
        return fs.select_rows(eff, a2d, y2d, v2d, 10.0)

    rec[f"b2_pair_{rows}_ms"] = time_cold_ms(pair2, reps)
    rec[f"b3_pair_{rows}_ms"] = time_cold_ms(pair3, reps)
    return calls


def turns_b23_plans(fs, rows: int, dev, reps: int) -> dict:
    """This checkout's B2 / B3 launch plans at `rows` rows, each checked
    bitwise against the kept plan and timed twice (the second pass in the
    reverse order), and the timing build's stamp split of the kept plan
    behind both flushes. Returns the readings."""
    from dpsvm_tpu_torch.ops import _build

    f2d, e2d, a2d, y2d, v2d, d2d = b23_turns_inputs(rows, dev)
    c = 10.0
    so = fs.lib()
    stamped = fs.bind(_build.load("fold_select", defines=("DPSVM_STAMPS",)))

    def launches(plan):
        return {
            "b3": lambda lib: fs._select_launch(f2d, a2d, y2d, v2d, c, plan,
                                                lib),
            "b2": lambda lib: fs._fold_launch(f2d, None, a2d, y2d, v2d, d2d,
                                              c, False, plan, lib),
            "b2_comp": lambda lib: fs._fold_launch(f2d, e2d, a2d, y2d, v2d,
                                                   d2d, c, True, plan, lib)}

    kept = launches(fs.fold_select_plan(rows))
    want = {k: run(so) for k, run in kept.items()}
    runs, checks = {}, {}
    for warps in B23_WARPS:
        plan = fs.FoldSelectPlan(warps, -(-rows // warps))
        for k, run in launches(plan).items():
            name = f"{k} warps={warps}"
            runs[name] = functools.partial(run, so)
            checks[name] = all(same_bits(g, w)
                               for g, w in zip(runs[name](), want[k]))
    plans_ms = {name: [] for name in runs}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            plans_ms[name].append(time_cold_ms(runs[name], reps))
    out = {"plan_checks_ok": checks, "plans_ms": plans_ms,
           "kept_plan": tuple(fs.fold_select_plan(rows))}

    split = {}
    for k, run in kept.items():
        checks[f"{k} stamped"] = all(
            same_bits(g, w) for g, w in zip(run(stamped), want[k]))
        one = {"stamped_ms": time_cold_ms(functools.partial(run, stamped),
                                          reps)}
        for flush in ("dirty", "clean"):
            one[flush] = stamp_split(run, stamped, rows, flush,
                                     max(10, reps // 4))
        split[k] = one
    out["split"] = split
    return out


# The engines --turns trains on the headline (B2 and B3's main paths).
TURNS_ENGINES = ("fused_fold", "pipeline_rounds")


def turns_engines(rec: dict, solves: int = 3) -> None:
    """The headline (60000 x 784, HEADLINE) trained through the package's
    train() with each of TURNS_ENGINES, after a warm-up solve of each on
    16384 rows: `solves` solves an engine, the engines alternating, each
    solve's train_seconds, pairs and rounds added to `rec`."""
    from dpsvm_tpu_torch import SVMConfig, train
    from dpsvm_tpu_torch.data.synth import make_mnist_like

    x, y = make_mnist_like(n=60_000, d=784, seed=7, noise=0.1)
    cfg = SVMConfig(**HEADLINE)
    for knob in TURNS_ENGINES:
        train(x[:16384], y[:16384], cfg.replace(max_iter=2048, **{knob: True}))
    for knob in TURNS_ENGINES:
        rec[f"{knob}_train_seconds"] = []
    for _ in range(solves):
        for knob in TURNS_ENGINES:
            _, res = train(x, y, cfg.replace(**{knob: True}))
            rec[f"{knob}_train_seconds"].append(res.train_seconds)
            rec[f"{knob}_pairs"] = res.iterations
            rec[f"{knob}_rounds"] = res.stats["outer_rounds"]


def turns(package, reps: int) -> int:
    """Times, in ms, B6 at n_pad 65536 and B5 at q 256, n_pad 60416
    (plain and compensated) with time_cold_ms, beside the timer's floor
    (an empty launch, before and after) and B5's contraction alone through
    cuBLAS (torch.mv); B5 and B6 again back to back with no flush
    (time_ms) and behind a clean flush (time_clean_ms). B3, B2 and B2
    compensated at each of B23_ROWS behind both flushes, warm and in the
    pair each forms with the kernel ahead of it, with their bytes bound
    and the wrapper's host us a call (host_us); then the headline's
    train_seconds with the fused fold and the pipelined engine
    (turns_engines). For this checkout's package it also times the plans
    of B6_THREADS, B5_PLANS and B23_WARPS in two passes, the second in
    the reverse order, each checked against the kept plan (B6, B2 and B3
    bitwise; B5 within its tolerance, candidates bitwise), and splits B2
    and B3's time by the stamps of csrc/fold_select.cu (stamp_split,
    turns_b23_plans). Prints one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if package:
        sys.path.insert(0, os.path.abspath(package))
    import dpsvm_tpu_torch
    from dpsvm_tpu_torch.ops import fold_select as fs
    from dpsvm_tpu_torch.ops import fused_update as fu
    from dpsvm_tpu_torch.ops import round as rnd
    from dpsvm_tpu_torch.ops.kernels import KernelParams

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    rec = {"card": smi, "package": os.path.dirname(dpsvm_tpu_torch.__file__)}
    kp = KernelParams("rbf", 0.125)
    c = 10.0
    views6, sc = b6_turns_inputs(65536, dev)
    k_rows, coef, (f2d, e2d, a2d, y2d, v2d) = b5_turns_inputs(256, 60416,
                                                              dev)
    b6 = functools.partial(fu.fused_update_select, *views6, sc, kp, c)
    b5 = {comp: functools.partial(rnd.fold_rows_select, k_rows, coef, f2d,
                                  e2d, a2d, y2d, v2d, c, compensated=comp)
          for comp in (False, True)}
    empty = functools.partial(torch.cuda._sleep, 0)
    contraction = functools.partial(torch.mv, k_rows.t(), coef)
    rec["launch_floor_ms"] = time_cold_ms(empty, reps)
    rec["b6_ms"] = time_cold_ms(b6, reps)
    rec["b5_ms"] = time_cold_ms(b5[False], reps)
    rec["b5_comp_ms"] = time_cold_ms(b5[True], reps)
    rec["contraction_ms"] = time_cold_ms(contraction, reps)
    for rows in B23_ROWS:
        turns_b23(fs, rows, dev, reps, rec)
    rec["launch_floor_ms_after"] = time_cold_ms(empty, reps)
    rec["b6_warm_ms"] = time_ms(b6, reps)
    rec["b5_warm_ms"] = time_ms(b5[False], reps)
    rec["launch_floor_warm_ms"] = time_ms(empty, reps)
    for key, fn in (("launch_floor", empty), ("b6", b6), ("b5", b5[False]),
                    ("contraction", contraction)):
        rec[f"{key}_ms_clean_flush"] = time_clean_ms(fn, reps)
    turns_engines(rec)
    if package:
        print(json.dumps(rec), flush=True)
        return 0

    groups = 65536 // 4
    b6_plans = {t: fu.FusedUpdatePlan(t, -(-groups // t), 20 * (t // 32))
                for t in B6_THREADS}
    b5_plans = {}
    for w, ch, st in B5_PLANS:
        b5_plans[w, ch, st] = rnd.FoldRowsPlan(
            w, ch, st, rnd.fold_rows_smem(256, w, ch, st), f2d.shape[0])
    runs = {f"b6 threads {t}": functools.partial(
        fu._launch, (*views6, sc), plan, kp, c)
        for t, plan in b6_plans.items()}
    runs.update({f"b5 {key}": functools.partial(
        rnd._fold_rows_launch, k_rows, coef, f2d, e2d, a2d, y2d, v2d, c,
        False, plan) for key, plan in b5_plans.items()})
    want6, want5 = b6(), b5[False]()
    scale5 = (coef.abs() @ k_rows).view(f2d.shape)
    checks = {}
    for name, run in runs.items():
        got = run()
        if name.startswith("b6"):
            checks[name] = all(same_bits(g, w) for g, w in zip(got, want6))
        else:
            emitted = fs.emit_row_candidates(got[0], a2d, y2d, v2d, c)
            checks[name] = bool(((got[0] - want5[0]).abs()
                                 <= 1e-6 * want5[0].abs()
                                 + 2e-6 * scale5).all()) and all(
                same_bits(g, h) for g, h in zip(got[2:], emitted))
    plans_ms = {name: [] for name in runs}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            plans_ms[name].append(time_cold_ms(runs[name], reps))
    rec["plan_checks_ok"] = checks
    rec["plans_ms"] = plans_ms
    rec["kept_plans"] = {"b6": tuple(fu.fused_update_plan(65536)),
                         "b5": tuple(rnd.fold_rows_plan(256, 472))}
    ok = all(checks.values())
    for rows in B23_ROWS:
        b23 = turns_b23_plans(fs, rows, dev, reps)
        rec[f"b23_{rows}"] = b23
        ok = ok and all(b23["plan_checks_ok"].values())
    print(json.dumps(rec), flush=True)
    return 0 if ok else 1


def serve_profile(reps: int) -> int:
    """--serve-profile: where a serving dispatch spends its time. Trains
    [multiclass]'s OvO model (MC_RUN, MC_BLOCK on rows 0-49999), stages
    it in a PredictServer at f32, bf16 and int8, and for buckets 256 and
    4096 prints per dispatch the time between CUDA events on the
    server's stream (median of `reps`), the device's busy time and the
    largest kernels by device time (torch.profiler over `reps`
    dispatches); the last line is one JSON object with the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from dpsvm_tpu_torch import PredictServer, ServeConfig, SVMConfig
    from dpsvm_tpu_torch.data.synth import make_mnist_multiclass
    from dpsvm_tpu_torch.models.multiclass import train_multiclass

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    x, y = make_mnist_multiclass(n=60_000, d=784, seed=7, noise=0.1)
    model, _ = train_multiclass(x[:MC_TRAIN], y[:MC_TRAIN],
                                SVMConfig(**MC_RUN, **MC_BLOCK),
                                strategy="ovo")
    s_rows = int(model.compacted.sv_union.shape[0])
    out = {"card": smi, "union_rows": s_rows}
    for storage in ("f32", "bf16", "int8"):
        srv = PredictServer(model, ServeConfig(union_storage=storage))
        for bucket in (256, 4096):
            ms, _ = dispatch_ms(srv, bucket, reps)
            qb = np.random.default_rng(bucket).random((bucket, srv.d),
                                                      dtype=np.float32)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    srv._union.launch(qb).wait()
            kernels: dict = {}
            for evt in prof.events():
                if evt.device_type == torch.autograd.DeviceType.CUDA:
                    kernels[evt.name] = (kernels.get(evt.name, 0.0)
                                         + evt.device_time_total / 1e3 / reps)
            top = [(name[:48], round(t, 4)) for name, t in sorted(
                kernels.items(), key=lambda kv: -kv[1])[:6]]
            busy = sum(kernels.values())
            out[f"{storage} {bucket}"] = {"dispatch_ms": ms,
                                          "device_busy_ms": busy,
                                          "top_ms": top}
            print(f"[serve profile] {storage} bucket {bucket}: dispatch "
                  f"{ms:.4f} ms on the stream, device busy {busy:.4f} ms; "
                  f"largest {top} ({s_rows}-row union; {smi})", flush=True)
    print(json.dumps(out))
    return 0


def cli() -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke test of the port on "
                                 "one CUDA card (no arguments), or kernel "
                                 "timings in turns (--turns).")
    ap.add_argument("--turns", action="store_true",
                    help="time B2, B3, B5 and B6 only and print one JSON "
                    "line")
    ap.add_argument("--package", default=None,
                    help="with --turns: a directory holding the "
                    "dpsvm_tpu_torch to time")
    ap.add_argument("--reps", type=int, default=200,
                    help="with --turns: timed calls per reading")
    ap.add_argument("--serve-profile", action="store_true",
                    help="profile serving dispatches only (10 a reading)")
    args = ap.parse_args()
    if args.serve_profile:
        return serve_profile(10)
    if not args.turns:
        return main()
    return turns(args.package, args.reps)


if __name__ == "__main__":
    sys.exit(cli())
