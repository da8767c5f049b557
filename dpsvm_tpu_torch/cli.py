"""Command-line entry points ``train``, ``test``, ``serve``, ``smoke``
and ``learn`` (that subset of dpsvm_tpu/cli.py, same flag names, plus
``--device``).

Usage:
    python -m dpsvm_tpu_torch.cli train -f train.csv -m model.txt -c 10 \\
        -g 0.125 [--format auto|csv|libsvm] [--kernel rbf|linear|poly|
        sigmoid|precomputed --degree 3 --coef0 0] [-w1 2 -w-1 1]
        [--engine xla|pallas|block] [--backend mesh --num-devices 4
        --ring-exchange on | --backend reference|native]
        [-t nu-svc|eps-svr|nu-svr|one-class --nu 0.5 -p 0.1]
        [--multiclass ovr|ovo --fleet-size 16] [-b 1] [-v 5]
        [--checkpoint ck.npz --checkpoint-every 4096 --checkpoint-keep 2
        --resume] [--chunk-iters 2048] [--bf16-gram] [-q]
        [--ooc --ooc-tile-rows 8192 --ooc-cache-lines 512
        --ooc-shrink auto|on|off] [--active-set-size 4096
        --reconcile-rounds 8] [--coordinator-address HOST:PORT
        --num-processes W --process-id K]
    python -m dpsvm_tpu_torch.cli smoke [--num-devices 4] [--device cuda:0]
    python -m dpsvm_tpu_torch.cli test -f test.csv -m model.txt \\
        [-o predictions.txt] [--precision auto|float32|float64] [-b 1]
    python -m dpsvm_tpu_torch.cli serve -m model.npz [--server-bench]
        | --registry NAME=model.npz [--listen 127.0.0.1:0 --replicas 2]
        [--journal registry.json] [--union-storage f32|bf16|int8|auto]
        [--device cuda]
    python -m dpsvm_tpu_torch.cli learn [--smoke] [--stream s.npz]
        [--serve] [--cold-baseline] [--device cpu]  (learn.py)

A training file whose labels are not +-1 trains a multiclass bundle
(.npz) by the OvR / OvO reduction; --kernel precomputed reads the square
(n, n) Gram as the features and saves SV indices (.npz), and its test
file holds K(test, train) rows.

A multi-process job (the JAX package's multi-host launch, the
reference's ``mpirun``): every process runs the same ``train`` command
with its own ``--process-id``; ``--backend mesh --num-devices L --device
cuda:0`` gives each process L logical shards of the card (without
``--device``, its L visible cards). Every path of ``train`` runs in a
job: the svm types, multiclass files, ``-v``, ``-b 1``, ``--kernel
precomputed`` and ``--ooc``. Process 0 writes the model, the checkpoint
and the run log, and prints the scores (train accuracy, cross-validation,
the Platt calibration).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="dpsvm-tpu-torch",
        description="SMO SVM trainer (PyTorch/CUDA port)")
    sub = parser.add_subparsers(dest="command", required=True)
    # `learn ...` is forwarded to learn.run_cli before parsing (main);
    # this entry lists it in --help.
    # `obs ...` likewise goes verbatim to obs/analyze.py run_cli.
    sub.add_parser(
        "obs", add_help=False,
        help="run-log analytics (obs/analyze.py): `obs report <paths>` "
             "aggregates run summaries (--md for markdown), `obs diff A B` "
             "attributes a regression to the phase that moved, `obs tail "
             "<path>` shows the last records of a stream; reads files "
             "only, no device")
    # `autotune ...` goes verbatim to autotune/__init__.py run_cli, and
    # `lint ...` to _cmd_lint (the structural linter, or threadlint).
    sub.add_parser(
        "autotune", add_help=False,
        help="measured device profiling for the solvers' auto gates "
             "(autotune/): `autotune run [--device cpu] [--smoke] [--out "
             "P]` probes the device and writes its profile, `autotune "
             "show [P]` prints the active one, `autotune diff A B` "
             "compares two")
    sub.add_parser(
        "lint", add_help=False,
        help="`lint --check [--entries a,b] [--device cpu]` runs the hot "
             "entrypoints one step each and diffs their ops, host reads, "
             "collectives and kernel calls against the committed budgets "
             "(analysis/budgets), `lint --write-budgets` regenerates them; "
             "`lint --threads --check` diffs the threaded modules' "
             "concurrency facts against analysis/contracts (threadlint), "
             "`lint --threads --write-contracts` regenerates them")
    sub.add_parser(
        "learn", add_help=False,
        help="continuous-learning loop (learn.py): retrain each increment "
             "warm-started from the previous generation's support vectors "
             "and hot-swap every generation into a serving engine; "
             "`learn --smoke` is the CI shape, `learn --help` the flags")
    p = sub.add_parser("train", help="train an SVM with modified SMO")
    p.add_argument("-f", "--file-path", required=True,
                   help="training data: CSV (label,f1,...,fd) or sparse "
                        "LIBSVM format (label idx:val ...)")
    p.add_argument("--format", choices=["auto", "csv", "libsvm"],
                   default="auto",
                   help="input format (default auto: LIBSVM rows are "
                        "recognized by their idx:val tokens)")
    p.add_argument("-m", "--model", required=True,
                   help="output model path (.txt or .npz)")
    p.add_argument("-t", "--svm-type", default="c-svc",
                   choices=["c-svc", "nu-svc", "eps-svr", "nu-svr",
                            "one-class"],
                   help="problem type (default c-svc; svr/one-class models "
                        "save as .npz)")
    p.add_argument("--nu", type=float, default=0.5,
                   help="nu for nu-svc / nu-svr / one-class (default 0.5)")
    p.add_argument("-p", "--svr-epsilon", type=float, default=0.1,
                   help="epsilon-SVR tube width (LibSVM -p; default 0.1)")
    p.add_argument("-a", "--num-att", type=int, default=None,
                   help="number of features (inferred from file if omitted)")
    p.add_argument("-x", "--num-ex", type=int, default=None,
                   help="number of training examples (inferred if omitted)")
    p.add_argument("-c", "--cost", type=float, default=1.0)
    p.add_argument("-g", "--gamma", type=float, default=None,
                   help="RBF gamma (default 1/num_features)")
    p.add_argument("-e", "--epsilon", type=float, default=1e-3)
    p.add_argument("-n", "--max-iter", type=int, default=150_000)
    p.add_argument("-s", "--cache-size", type=int, default=0,
                   help="kernel-row cache lines of the per-pair engines "
                        "(default 0 = off; SVMConfig.cache_lines)")
    p.add_argument("--kernel", choices=["rbf", "linear", "poly", "sigmoid",
                                        "precomputed"], default="rbf",
                   help="kernel family (precomputed = LibSVM -t 4: the "
                        "training file's feature columns ARE the square "
                        "(n, n) Gram matrix; the model saves SV indices "
                        "as .npz, and the test file must hold "
                        "K(test, train) rows)")
    p.add_argument("--degree", type=int, default=3)
    p.add_argument("--coef0", type=float, default=0.0)
    p.add_argument("-w1", "--weight-pos", type=float, default=1.0,
                   help="C multiplier for the +1 class (LibSVM -w1)")
    p.add_argument("-w-1", "--weight-neg", type=float, default=1.0,
                   dest="weight_neg",
                   help="C multiplier for the -1 class (LibSVM -w-1)")
    p.add_argument("--engine", choices=["xla", "pallas", "block"],
                   default="xla",
                   help="single-device engine: xla = per-pair SMO (row "
                        "cache, resident Gram, micro-batching); pallas = "
                        "per-pair SMO on the fused update+select kernel; "
                        "block = blockwise decomposition, the fastest "
                        "path")
    p.add_argument("--working-set-size", type=int, default=128)
    p.add_argument("--inner-iters", type=int, default=0,
                   help="pair updates per block (0 = 2 * working-set-size)")
    p.add_argument("--selection", choices=["mvp", "second_order"],
                   default="mvp")
    p.add_argument("--pair-batch", type=int, default=1,
                   choices=[1, 2, 4, 8],
                   help="pair updates per inner-loop trip (mvp only; see "
                        "SVMConfig.pair_batch). On --engine xla, 2/4/8 "
                        "select the micro-batched per-pair executor")
    p.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="float32", help="storage dtype of X")
    p.add_argument("--fleet-size", type=int, default=16,
                   help="multiclass submodels trained per fleet "
                        "(solver/fleet.py; a power of two, 1 = "
                        "sequential solves)")
    p.add_argument("--multiclass", choices=["ovr", "ovo"], default="ovr",
                   help="reduction for files whose labels are not +-1: "
                        "one-vs-rest (k models) or one-vs-one (k(k-1)/2 "
                        "models); c-svc only, the bundle saves as .npz")
    p.add_argument("-b", "--probability", type=int, choices=[0, 1],
                   default=0,
                   help="1 = fit Platt probability calibration (5-fold "
                        "refits, LibSVM -b; c-svc / nu-svc only; the "
                        "model saves as .npz)")
    p.add_argument("-v", "--cross-validate", type=int, default=0,
                   metavar="N",
                   help="LibSVM svm-train -v: N-fold cross-validation "
                        "(N >= 2); prints held-out accuracy (classifiers) "
                        "or MSE and squared correlation (SVR) and writes "
                        "NO model file")
    p.add_argument("--fused-round", choices=["auto", "on", "off"],
                   default="auto",
                   help="block engine: one-pass rounds (gather, kernel "
                        "rows and Gram block in one pass over X, fold and "
                        "next selection in one pass over f; "
                        "SVMConfig.fused_round). auto = the device "
                        "profile's decision (autotune/), else off")
    p.add_argument("--pipeline-rounds", choices=["auto", "on", "off"],
                   default="auto",
                   help="block engine: select, gather and build the next "
                        "round's Gram block from the pre-fold gradient "
                        "(stale selection, exact updates; "
                        "SVMConfig.pipeline_rounds). auto = the device "
                        "profile's decision (autotune/), else off")
    p.add_argument("--local-working-sets", type=int, default=0,
                   help="mesh block engine: 0 = auto (the device "
                        "profile's decision with more than one shard, "
                        "else off), 1 = one "
                        "global working set per round, >= 2 = shard-"
                        "parallel working sets: every shard solves a "
                        "subproblem selected from its OWN rows, "
                        "reconciling at syncs, with an endgame demotion "
                        "to the exact global runner "
                        "(SVMConfig.local_working_sets)")
    p.add_argument("--sync-rounds", type=int, default=1,
                   help="shard-parallel working sets: local rounds "
                        "between cross-shard syncs (needs "
                        "--local-working-sets >= 2; default 1)")
    p.add_argument("--ring-exchange", choices=["auto", "on", "off"],
                   default="auto",
                   help="mesh block engine: route the candidate exchange "
                        "and the shard-local sync through the ring "
                        "kernels (ops/ring.py); bit-identical "
                        "trajectories (SVMConfig.ring_exchange). auto = "
                        "the device profile's decision, else off")
    p.add_argument("--backend",
                   choices=["auto", "single", "mesh", "reference", "native"],
                   default="auto",
                   help="single device, or the data mesh over the "
                        "visible cards (auto = the mesh when more than "
                        "one card is visible and --engine block); "
                        "reference (NumPy) and native (C++) run the "
                        "sequential mvp SMO on the host")
    p.add_argument("--bf16-gram", action="store_true",
                   help="store X in bfloat16 only where the per-problem "
                        "perturbation bound accepts (C * p90|dK| <= "
                        "0.1); a refusal stays float32 and says so "
                        "(SVMConfig.bf16_gram)")
    p.add_argument("--ooc", action="store_true",
                   help="out-of-core training (block engine): X stays in "
                        "host memory and each round's fold streams over "
                        "double-buffered host->device tiles "
                        "(SVMConfig.ooc; solver/ooc.py)")
    p.add_argument("--ooc-tile-rows", type=int, default=8192,
                   help="--ooc: rows per streamed X tile (default 8192)")
    p.add_argument("--ooc-cache-lines", type=int, default=0,
                   help="--ooc: lines of the device cache of dot rows "
                        "keyed by training row (LRU; a round whose whole "
                        "working set hits streams nothing). 0 = off; "
                        "must be >= --working-set-size")
    p.add_argument("--ooc-shrink", choices=["auto", "on", "off"],
                   default="auto",
                   help="--ooc: the shrunken tile stream (in-cycle rounds "
                        "stream only the tiles of an active view of the m "
                        "most-violating rows, with full reconstructions "
                        "and the endgame demotion; auto = the device "
                        "profile's decision (autotune/), else off)")
    p.add_argument("--active-set-size", type=int, default=0,
                   help="block engine: shrink per-round work to the m "
                        "most-violating rows, reconciling the full "
                        "gradient in batches (0 = off; one device and the "
                        "mesh; with --ooc, m sizes the shrunken tile "
                        "stream's active view, 0 = auto-sized)")
    p.add_argument("--reconcile-rounds", type=int, default=8,
                   help="block engine shrinking: rounds between full-"
                        "gradient reconciliations (default 8)")
    p.add_argument("--chunk-iters", type=int, default=2048,
                   help="pair updates per observed chunk (block engines: "
                        "chunk-iters // inner rounds)")
    p.add_argument("--checkpoint", default=None,
                   help="solver checkpoint path")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="pair updates between checkpoints (0 = off)")
    p.add_argument("--checkpoint-keep", type=int, default=1,
                   help="rotating checkpoint generations to keep (path, "
                        "path.1, ...); --resume falls back to the newest "
                        "loadable one (default 1 = overwrite in place)")
    p.add_argument("--retry-faults", type=int, default=2,
                   help="automatic retries on transient device faults, "
                        "resuming from --checkpoint when this run wrote "
                        "it (default 2); a CUDA device-side fault is not "
                        "retried in the process: relaunch with --resume")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint if it exists")
    p.add_argument("--metrics-jsonl", default=None,
                   help="write per-chunk metrics records to this JSONL "
                        "file (observes the solve chunk by chunk)")
    p.add_argument("--trace-dir", "--profile-dir", dest="profile_dir",
                   default=None,
                   help="capture a torch.profiler trace (Chrome trace "
                        "JSON) into this directory; with --obs the solver "
                        "owns the capture and its spans appear named in "
                        "it")
    p.add_argument("--obs", action="store_true",
                   help="write a schema-versioned JSONL run log "
                        "(manifest / chunk / event / span / final "
                        "records) with registry metrics and trace spans; "
                        "launches, chunk cadence and results are "
                        "unchanged")
    p.add_argument("--obs-dir", default=None,
                   help="run-log directory for --obs (default obs_runs; "
                        "env DPSVM_OBS_DIR)")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="no load line and no per-chunk progress (an "
                        "unobserved solve runs as one chunk)")
    p.add_argument("--num-devices", type=int, default=None,
                   help="devices in the data mesh (default: all visible)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card); with "
                        "--backend mesh and --num-devices N, the device "
                        "every one of the N shards lives on (N logical "
                        "shards of it)")
    # The multi-process launch (the JAX package's multi-host flags, the
    # reference's `mpirun --hostfile` role): every process runs the same
    # command with its own --process-id.
    p.add_argument("--coordinator-address", default=None,
                   help="host:port of process 0 for a multi-process job "
                        "(parallel/mesh.py initialize_multihost)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="total processes in the multi-process job")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's index in the multi-process job")

    p = sub.add_parser("smoke", help="device and mesh bring-up check: a "
                       "known 3x3 matvec on every device and a sum over "
                       "the mesh")
    p.add_argument("--num-devices", type=int, default=None,
                   help="shards of the mesh (default: the visible cards); "
                        "more than the visible cards places logical shards "
                        "on them in turn")
    p.add_argument("--device", default=None,
                   help="check this torch device only; the mesh is "
                        "--num-devices logical shards of it")
    p = sub.add_parser("test", help="evaluate a trained model on a CSV")
    p.add_argument("-f", "--file-path", required=True,
                   help="test data (CSV or sparse LIBSVM format)")
    p.add_argument("--format", choices=["auto", "csv", "libsvm"],
                   default="auto")
    p.add_argument("-m", "--model", required=True,
                   help="model path (.txt or .npz)")
    p.add_argument("-a", "--num-att", type=int, default=None)
    p.add_argument("-x", "--num-ex", type=int, default=None)
    p.add_argument("-g", "--gamma", type=float, default=None,
                   help="override the model file's gamma")
    p.add_argument("-o", "--output", default=None,
                   help="write per-row predictions here, one per line "
                        "(labels for classifiers and one-class, values "
                        "for SVR)")
    p.add_argument("--precision", choices=["auto", "float32", "float64"],
                   default="auto",
                   help="binary decision evaluation precision (auto: "
                        "exact host float64 where predict.decision_risk "
                        "says float32 is not enough)")
    p.add_argument("-b", "--probability", type=int, choices=[0, 1],
                   default=0,
                   help="1 = report calibrated probabilities (the model "
                        "must have been trained with -b 1); -o then "
                        "writes 'label p(+1)' lines with the label from "
                        "p >= 0.5, svm-predict -b 1 style")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    _build_serve_parser(sub)
    return parser


def _build_serve_parser(sub) -> argparse.ArgumentParser:
    p = sub.add_parser(
        "serve",
        help="persistent prediction server (compacted SV union resident "
             "on the device, bucketed micro-batching; serve.py)")
    p.add_argument("-m", "--model", default=None,
                   help="model path (.npz multiclass bundle or binary "
                        "model, .txt binary): the v1 single-model server; "
                        "--registry runs the v2 multi-model engine")
    p.add_argument("--registry", action="append", metavar="NAME=PATH",
                   default=None,
                   help="register NAME -> model file on the v2 engine "
                        "(hot swap, deadline-aware batching, async "
                        "dispatch); repeatable. stdin rows may prefix "
                        "'NAME|' to route; a line 'swap NAME=PATH' "
                        "hot-swaps a model mid-stream")
    p.add_argument("--listen", default=None, metavar="HOST:PORT",
                   help="v2 engine: serve the binary frame protocol "
                        "(serving/wire.py) on this TCP endpoint instead "
                        "of stdin; SIGTERM drains gracefully. Port 0 = "
                        "ephemeral, printed at start")
    p.add_argument("--replicas", type=int, default=1,
                   help="--listen: N engine replicas behind the one front "
                        "door, registered in lockstep over --journal "
                        "(default 1)")
    p.add_argument("--admission-max-rows", type=int, default=None,
                   help="--listen: queued rows past which a request is "
                        "rejected with a retry hint (default: "
                        "max_pending)")
    p.add_argument("--conn-timeout-ms", type=float, default=None,
                   help="--listen: per-connection read and write timeout "
                        "(defaults 30000 / 10000)")
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="v2 engine: default per-request deadline; expired "
                        "requests are shed with a verdict (default none)")
    p.add_argument("--dispatch-timeout-ms", type=float, default=None,
                   help="v2 engine: dispatch watchdog; a batch not done "
                        "within it fails with explicit verdicts and the "
                        "engine serves on (default: unbounded)")
    p.add_argument("--journal", default=None, metavar="PATH",
                   help="v2 engine: the registry journal, rewritten on "
                        "every register / swap and replayed at start")
    p.add_argument("--buckets", default="16,64,256,1024,4096",
                   help="comma-separated power-of-two query buckets, or "
                        "'auto' for the default ladder")
    p.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="legacy SV-union storage dtype (--union-storage "
                        "wins when given)")
    p.add_argument("--union-storage",
                   choices=["f32", "bf16", "int8", "auto"], default=None,
                   help="SV-union storage: f32; bf16 (warns if risky); "
                        "int8 (refused with a wider fallback when the "
                        "perturbation bound rejects the model); auto "
                        "(the narrowest storage the bound accepts)")
    p.add_argument("--precision", choices=["auto", "float32", "float64"],
                   default="auto",
                   help="per-submodel routing (auto: host float64 where "
                        "decision_risk says float32 is not enough)")
    p.add_argument("--num-devices", type=int, default=1,
                   help="shard the SV union over this many shards (of "
                        "--device when given, else of that many cards)")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve OpenMetrics text (GET /metrics) on this "
                        "port (0 = ephemeral, printed at start)")
    p.add_argument("--metrics-host", default="127.0.0.1",
                   help="bind address for --metrics-port")
    p.add_argument("--slo-ms", type=float, default=50.0,
                   help="latency objective of the SLO-attainment gauges")
    p.add_argument("--server-bench", action="store_true",
                   help="run the offered-load micro-benchmark instead of "
                        "serving stdin")
    p.add_argument("--requests", type=int, default=512,
                   help="--server-bench: number of requests")
    p.add_argument("--request-sizes", default="1,2,4,8,16,32,64,128",
                   help="--server-bench: request row counts drawn from")
    p.add_argument("--group", type=int, default=8,
                   help="--server-bench: requests arriving together")
    p.add_argument("--obs", action="store_true",
                   help="write a serve run log (manifest, events, the "
                        "final snapshot) and trace spans around bucket "
                        "dispatches")
    p.add_argument("--obs-dir", default=None,
                   help="run-log directory for --obs (default obs_runs; "
                        "env DPSVM_OBS_DIR)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("-q", "--quiet", action="store_true")
    return p


_TRI = {"auto": None, "on": True, "off": False}


def _check_svm_type(args) -> str | None:
    """The flags an svm type cannot take, as the JAX package's CLI
    refuses them: an error message, or None."""
    if args.svm_type in ("nu-svc", "nu-svr", "one-class"):
        # These duals fix their own selection rule and box.
        if args.selection != "mvp":
            return (f"--selection {args.selection} is not applicable to "
                    f"{args.svm_type} (per-class nu selection is fixed)")
        if args.svm_type in ("nu-svc", "nu-svr") and args.engine == "pallas":
            return (f"--engine pallas is not applicable to {args.svm_type} "
                    "(per-class nu selection; use --engine xla or block)")
        if args.svm_type in ("nu-svc", "one-class") and (
                args.weight_pos != 1.0 or args.weight_neg != 1.0):
            return (f"-w1/-w-1 are not applicable to {args.svm_type} (the "
                    "nu box is fixed at [0, 1])")
    if args.probability and args.svm_type not in ("c-svc", "nu-svc"):
        return (f"-b 1 (Platt probability) applies to classifiers only, "
                f"not {args.svm_type}")
    if args.kernel == "precomputed":
        # LibSVM -t 4: the training file's features ARE the Gram matrix.
        if args.svm_type != "c-svc":
            return ("--kernel precomputed supports c-svc only (the other "
                    "duals would need transformed Gram sub-matrices)")
        if args.probability:
            return "-b 1 is not supported with --kernel precomputed"
        if args.backend in ("reference", "native"):
            return "--kernel precomputed needs the single or mesh backend"
    return None


def _fit(args, x, y, config, mesh, callback=None):
    """Train the requested svm type: (model, result)."""
    from dpsvm_tpu_torch import models
    from dpsvm_tpu_torch.train import train

    common = dict(backend=args.backend, device=args.device,
                  num_devices=args.num_devices, mesh=mesh,
                  checkpoint_path=args.checkpoint, resume=args.resume,
                  callback=callback)
    if args.svm_type == "c-svc":
        return train(x, y, config, **common)
    if args.svm_type == "nu-svc":
        return models.train_nusvc(x, y, nu=args.nu, config=config, **common)
    if args.svm_type == "eps-svr":
        return models.train_svr(x, y, config, svr_epsilon=args.svr_epsilon,
                                **common)
    if args.svm_type == "nu-svr":
        return models.train_nusvr(x, y, nu=args.nu, config=config, **common)
    return models.train_oneclass(x, nu=args.nu, config=config, **common)


def _cmd_smoke(args) -> int:
    """Bring-up check (the JAX package's `smoke`, the role of the
    reference's mpi_sample.cpp / testblas.c): a known 3x3 matvec on every
    device, and a sum of ones over a mesh of --num-devices shards. With
    --device D only D, the mesh D repeated; without, the visible CUDA
    cards, and a mesh wider than them takes them in turn (logical
    shards of one card on a one-card host)."""
    import torch

    from dpsvm_tpu_torch.parallel.mesh import Mesh

    if args.device is not None:
        devices = [torch.device(args.device)]
    else:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            print("error: no CUDA device is visible; pass --device cpu to "
                  "check the CPU path", file=sys.stderr)
            return 2
    print(f"platform={devices[0].type} devices={len(devices)}")
    a = np.arange(9, dtype=np.float32).reshape(3, 3)
    v = np.array([1.0, 2.0, 3.0], np.float32)
    want = np.array([8.0, 26.0, 44.0], np.float32)
    ok = True
    for dev in devices:
        got = (torch.as_tensor(a, device=dev)
               @ torch.as_tensor(v, device=dev)).cpu().numpy()
        good = bool(np.allclose(got, want))
        ok &= good
        print(f"  {dev}: matvec {'OK' if good else 'FAIL ' + str(got)}")
    n = args.num_devices or len(devices)
    mesh = Mesh([devices[i % len(devices)] for i in range(n)])
    got = mesh.psum([torch.ones(1, device=dev) for dev in mesh.devices])
    good = all(bool(np.allclose(t.cpu().numpy(), n)) for t in got)
    ok &= good
    print(f"  mesh({n}) {mesh.describe()} psum "
          f"{'OK' if good else 'FAIL ' + str([t.item() for t in got])}")
    return 0 if ok else 1


def _cmd_train(args) -> int:
    """train, in one process or as one process of a multi-process job
    (the three multihost flags): the process group is made first, and
    left at the end whatever happens."""
    if not (args.coordinator_address or args.num_processes
            or args.process_id is not None):
        return _train(args)
    from dpsvm_tpu_torch.parallel.mesh import (initialize_multihost,
                                               shutdown_multihost)

    bad = _multiprocess_refusal(args)
    if bad:
        print(f"error: {bad}", file=sys.stderr)
        return 2
    try:
        backend = initialize_multihost(
            args.coordinator_address, args.num_processes, args.process_id,
            devices=_process_devices(args))
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(f"process {args.process_id} of {args.num_processes}: {backend} "
          "process group", flush=True)
    try:
        try:
            mesh = _train_mesh(args)
        except (ValueError, RuntimeError) as e:
            hint = ("" if args.device is not None else " (--device cuda:0 "
                    "runs --num-devices logical shards of one card)")
            print(f"error: {e}{hint}", file=sys.stderr)
            return 2
        rc = _train(args, mesh)
    finally:
        shutdown_multihost()
    # Every solve of the job ran on this mesh (a multiclass file's
    # submodels, the refits of -v and -b 1 too).
    print(f"process {args.process_id} job exchanges: {mesh.exchanges} in "
          f"{mesh.exchange_seconds:.6f}s", flush=True)
    return rc


def _multiprocess_refusal(args):
    """Why a multi-process train cannot run, or None: the job trains on
    the mesh, so a one-device or host backend is refused."""
    if args.backend not in ("auto", "mesh"):
        return (f"--backend {args.backend} runs in one process; a "
                "multi-process job trains on the mesh (--backend mesh)")
    return None


def _process_devices(args):
    """The devices this process of a job holds shards on: --device, or
    its first --num-devices visible cards (None: initialize_multihost
    takes the visible cards, and raises without one)."""
    if args.device is not None:
        return [args.device]
    import torch

    cards = [torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
    return cards[:args.num_devices] or None


def _train_mesh(args):
    """The mesh every path of `train` runs on: --num-devices logical
    shards of --device with --backend mesh or in a job; in a job without
    --device, the process's first --num-devices visible cards; else None
    (the solver takes the visible cards). In a job it spans the
    processes."""
    from dpsvm_tpu_torch.parallel.mesh import (Mesh, make_data_mesh,
                                               process_count)

    job = process_count() > 1
    if args.device is not None and (args.backend == "mesh" or job):
        return Mesh([args.device] * (args.num_devices or 1),
                    span_processes=True)
    return make_data_mesh(args.num_devices) if job else None


def _train(args, mesh=None) -> int:
    """train in one process, or in a job on its mesh (_train_mesh)."""
    from dpsvm_tpu_torch.config import ObsConfig, SVMConfig
    from dpsvm_tpu_torch.parallel.mesh import process_index
    from dpsvm_tpu_torch.data.loader import load_data

    bad = _check_svm_type(args)
    if bad:
        print(f"error: {bad}", file=sys.stderr)
        return 2
    regression = args.svm_type in ("eps-svr", "nu-svr")
    t0 = time.perf_counter()
    try:
        x, y = load_data(args.file_path, args.num_ex, args.num_att,
                         float_labels=regression, fmt=args.format)
    except ValueError as e:
        print(f"error: could not load {args.file_path} "
              f"(format={args.format}): {e}\nhint: pass --format "
              "csv|libsvm to override auto-detection", file=sys.stderr)
        return 2
    if not args.quiet:
        print(f"loaded {x.shape[0]} examples x {x.shape[1]} features "
              f"in {time.perf_counter() - t0:.2f}s")
    try:
        config = SVMConfig(
            c=args.cost, gamma=args.gamma, epsilon=args.epsilon,
            max_iter=args.max_iter, cache_lines=args.cache_size,
            kernel=args.kernel, degree=args.degree, coef0=args.coef0,
            weight_pos=args.weight_pos, weight_neg=args.weight_neg,
            selection=args.selection, pair_batch=args.pair_batch,
            engine=args.engine, working_set_size=args.working_set_size,
            inner_iters=args.inner_iters, dtype=args.dtype,
            fleet_size=args.fleet_size,
            fused_round=_TRI[args.fused_round],
            pipeline_rounds=_TRI[args.pipeline_rounds],
            local_working_sets=args.local_working_sets or None,
            sync_rounds=args.sync_rounds,
            ring_exchange=_TRI[args.ring_exchange],
            bf16_gram=args.bf16_gram, active_set_size=args.active_set_size,
            reconcile_rounds=args.reconcile_rounds,
            ooc=args.ooc, ooc_tile_rows=args.ooc_tile_rows,
            ooc_cache_lines=args.ooc_cache_lines,
            ooc_shrink=_TRI[args.ooc_shrink], chunk_iters=args.chunk_iters,
            checkpoint_every=args.checkpoint_every,
            checkpoint_keep=args.checkpoint_keep,
            retry_faults=args.retry_faults, verbose=not args.quiet,
            # With --obs the solver owns the trace (its spans appear
            # named in it); without it profile_trace below wraps the run.
            obs=ObsConfig(enabled=bool(args.obs),
                          trace_dir=args.profile_dir if args.obs else None,
                          runlog_dir=args.obs_dir))
        config.check_ported()
    except (ValueError, NotImplementedError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if mesh is None:
        mesh = _train_mesh(args)  # every path below trains on it
    # Labels other than +-1 train the OvR / OvO reduction (as LibSVM's
    # svm-train trains a multiclass file); two arbitrary labels too, so
    # the model predicts the file's own labels.
    if args.svm_type in ("c-svc", "nu-svc"):
        classes = np.unique(y)
        if len(classes) < 2:
            print("error: training data holds a single class",
                  file=sys.stderr)
            return 2
        if not set(classes.tolist()) <= {-1, 1}:
            return _train_multiclass_cli(args, x, y, config, mesh)
    if args.cross_validate:
        return _cross_validate(args, x, y, config, mesh)
    if args.kernel == "precomputed":
        return _train_precomputed(args, x, y, config, mesh)
    logger = None
    if args.metrics_jsonl and process_index() == 0:
        from dpsvm_tpu_torch.utils.metrics import MetricsLogger

        logger = MetricsLogger(
            jsonl_path=args.metrics_jsonl,
            lookups_per_iter=0 if args.engine == "block" else 2)
    elif args.metrics_jsonl:
        # Process k > 0 observes the same chunks as process 0, whose
        # logger writes the file: the chunking (and so every collective)
        # is the same in every process.
        from dpsvm_tpu_torch.solver.smo import _noop_callback as logger
    trace_dir = None if config.obs.enabled else args.profile_dir
    try:
        from dpsvm_tpu_torch.utils.metrics import profile_trace

        with profile_trace(trace_dir, device=_trace_device(args, mesh)):
            model, result = _fit(args, x, y, config, mesh, callback=logger)
    except (ValueError, NotImplementedError) as e:
        hint = ""
        if args.backend == "mesh" and args.device is None:
            hint = (" (--device cuda:0 runs --num-devices logical shards of "
                    "one card)")
        print(f"error: {e}{hint}", file=sys.stderr)
        return 2
    finally:
        if logger is not None and hasattr(logger, "close"):
            logger.close()
    if result.converged:
        print(f"converged at iteration {result.iterations}")
    else:
        print(f"stopped at max-iter {result.iterations} without converging")
    rounds = result.stats.get("outer_rounds")
    where = (result.stats.get("mesh_devices")
             or result.stats.get("device", f"the host ({args.backend})"))
    print(f"training took {result.train_seconds:.2f}s on {where}"
          + (f" ({rounds} rounds)" if rounds is not None else ""))
    if result.stats.get("cache_lookups"):
        print(f"cache hit rate: {result.stats['cache_hit_rate']:.4f}")
    if "tiles_streamed" in result.stats:
        st = result.stats
        own = ""
        if "process_tiles_streamed" in st:
            own = (f" (this process {st['process_tiles_streamed']} tiles, "
                   f"{st['process_tile_bytes_h2d'] / 1e9:.6f} GB)")
        print(f"ooc stream: {st['tiles_streamed']} tiles, "
              f"{st['tile_bytes_h2d'] / 1e9:.6f} GB host to device{own}")
    if "exchanges" in result.stats:
        print(f"cross-process exchange: {result.stats['exchanges']} "
              f"exchanges in {result.stats['exchange_seconds']:.6f}s "
              f"({result.stats['process_backend']})")
    print(f"b: {result.b:.6f}")
    print(f"support vectors: {result.n_sv}")
    if process_index() == 0:  # the job's scores come from process 0
        _print_train_score(args, model, x, y, regression)
    if args.probability:
        _fit_probability(args, model, x, y, config, mesh)
    if args.svm_type in ("eps-svr", "nu-svr", "one-class") \
            and not args.model.endswith(".npz"):
        args.model += ".npz"
        print(f"note: {args.svm_type} models use the .npz format")
    _write_model(model, args.model)
    return 0


def _print_train_score(args, model, x, y, regression: bool) -> None:
    from dpsvm_tpu_torch.predict import accuracy

    if args.svm_type in ("c-svc", "nu-svc"):
        print(f"train accuracy: "
              f"{accuracy(model, x, y, device=args.device):.4f}")
    elif regression:
        resid = np.asarray(model.predict(x, device=args.device)) - y
        print(f"train RMSE: {float(np.sqrt(np.mean(resid ** 2))):.6f}")
    else:
        inlier = float(np.mean(model.predict(x, device=args.device) > 0))
        print(f"train inlier fraction: {inlier:.4f} (nu={args.nu})")


def _write_model(model, path: str) -> None:
    """Save the model: process 0 of a multi-process job writes it, the
    others name the writer."""
    from dpsvm_tpu_torch.parallel.mesh import process_index

    if process_index() == 0:
        model.save(path)
        print(f"model written to {path}")
    else:
        print(f"model written to {path} by process 0")


def _trace_device(args, mesh):
    """The device a --trace-dir capture records: the mesh's, the named
    one, or the card; the host backends run on the CPU."""
    if mesh is not None:
        return mesh.devices[0]
    if args.backend in ("reference", "native"):
        return "cpu"
    return args.device


def _log_loss(p, y) -> float:
    p = np.clip(p, 1e-15, 1 - 1e-15)
    t = (np.asarray(y) > 0).astype(np.float64)
    return float(-np.mean(t * np.log(p) + (1 - t) * np.log(1 - p)))


def _fit_probability(args, model, x, y, config, mesh=None) -> None:
    """-b 1: the Platt pair from 5-fold refits of the same dual (in-sample
    decision values are margin-biased; models/platt.py fit_platt_cv),
    set on the model, which then saves as .npz. The refits train on
    `mesh` where the backend takes it (every process of a job); process
    0 prints the calibration."""
    from dpsvm_tpu_torch.models.platt import fit_platt_cv, platt_probability
    from dpsvm_tpu_torch.parallel.mesh import process_index
    from dpsvm_tpu_torch.predict import decision_function

    train_fn = None
    if args.svm_type == "nu-svc":
        from dpsvm_tpu_torch.models.nusvm import train_nusvc

        def train_fn(xf, yf, cfg, backend="auto", num_devices=None,
                     mesh=None):
            return train_nusvc(xf, yf, nu=args.nu, config=cfg,
                               backend=backend, num_devices=num_devices,
                               device=args.device, mesh=mesh)
    model.prob_a, model.prob_b = fit_platt_cv(
        x, y, config, backend=args.backend, num_devices=args.num_devices,
        train_fn=train_fn, device=args.device, mesh=mesh)
    if process_index() == 0:
        dec = np.asarray(decision_function(model, x, device=args.device),
                         np.float64)
        p = platt_probability(dec, model.prob_a, model.prob_b)
        print(f"platt calibration: A={model.prob_a:.6f} "
              f"B={model.prob_b:.6f} train log-loss={_log_loss(p, y):.4f}")
    if not args.model.endswith(".npz"):
        args.model += ".npz"
        print("note: probability models use the .npz format (the "
              "reference text format cannot carry the calibration)")


def _train_multiclass_cli(args, x, y, config, mesh=None) -> int:
    """A file whose labels are not +-1: the OvR / OvO reduction
    (models/multiclass.py), saved as the .npz bundle `test` dispatches
    on; -v cross-validates it instead. The submodels train on `mesh`
    where the backend takes it (every process of a job, in the same
    order); process 0 scores and writes the bundle."""
    classes = np.unique(y)
    blockers = [
        ("-t nu-svc", args.svm_type != "c-svc"),
        ("-b 1", bool(args.probability)),
        ("--kernel precomputed", args.kernel == "precomputed"),
        ("--checkpoint/--resume", bool(args.checkpoint or args.resume)),
        # The +-1 remapping rotates over the submodels, so -w1/-w-1
        # would weight a different original class in each.
        ("-w1/-w-1", args.weight_pos != 1.0 or args.weight_neg != 1.0),
    ]
    bad = [f for f, hit in blockers if hit]
    if bad:
        print(f"error: multiclass training ({len(classes)} labels "
              f"{classes.tolist()[:6]}{'...' if len(classes) > 6 else ''}) "
              f"does not compose with {', '.join(bad)}; it trains plain "
              "binary C-SVC submodels", file=sys.stderr)
        return 2
    if args.cross_validate:
        return _cross_validate_multiclass(args, x, y, config, mesh)
    from dpsvm_tpu_torch.models.multiclass import (accuracy_multiclass,
                                                   train_multiclass)
    from dpsvm_tpu_torch.parallel.mesh import process_index

    if not args.quiet:
        k = len(classes)
        if k == 2:
            plan = "1 binary submodel (2 non-±1 labels)"
        else:
            n_models = k if args.multiclass == "ovr" else k * (k - 1) // 2
            plan = f"{n_models} {args.multiclass} binary submodels"
        print(f"multiclass: {k} classes -> {plan}")
    t0 = time.perf_counter()
    try:
        model, results = train_multiclass(
            x, y, config, strategy=args.multiclass, backend=args.backend,
            num_devices=args.num_devices, verbose=not args.quiet,
            device=args.device, mesh=mesh)
    except (ValueError, NotImplementedError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    wall = time.perf_counter() - t0
    dev_s = sum(r.train_seconds for r in results)
    conv = sum(r.converged for r in results)
    print(f"training took {wall:.2f}s ({dev_s:.2f}s device; "
          f"{conv}/{len(results)} submodels converged)")
    if process_index() == 0:
        print(f"train accuracy: "
              f"{accuracy_multiclass(model, x, y, device=args.device):.4f}")
    if not args.model.endswith(".npz"):
        args.model += ".npz"
        print("note: multiclass models use the .npz format (the "
              "reference text format is binary-only)")
    _write_model(model, args.model)
    return 0


def _fold_fit_factory(args, config, mesh=None):
    """The fold refit of -v for each svm type: a throwaway model, no
    callbacks or checkpoints, on `mesh` where the backend takes it."""
    from dpsvm_tpu_torch import models
    from dpsvm_tpu_torch.train import train

    common = dict(backend=args.backend, num_devices=args.num_devices,
                  device=args.device, mesh=mesh)
    if args.svm_type == "c-svc":
        def fit(xf, yf):
            return train(xf, yf, config, **common)[0]
    elif args.svm_type == "nu-svc":
        def fit(xf, yf):
            return models.train_nusvc(xf, yf, nu=args.nu, config=config,
                                      **common)[0]
    elif args.svm_type == "eps-svr":
        def fit(xf, yf):
            return models.train_svr(xf, yf, config,
                                    svr_epsilon=args.svr_epsilon,
                                    **common)[0]
    else:  # nu-svr
        def fit(xf, yf):
            return models.train_nusvr(xf, yf, nu=args.nu, config=config,
                                      **common)[0]
    return fit


def _fold_split(y, k: int, seed: int = 0, stratify: bool = False):
    """Deterministic k-fold index split (the JAX package's): stratify=True
    spreads each class over the folds, remainders rotated by class."""
    rng = np.random.default_rng(seed)
    if not stratify:
        return np.array_split(rng.permutation(len(y)), k)
    parts = [[] for _ in range(k)]
    for ci, cls in enumerate(np.unique(y)):
        idx = rng.permutation(np.nonzero(y == cls)[0])
        for i, p in enumerate(np.array_split(idx, k)):
            if p.size:
                parts[(i + ci) % k].append(p)
    return [rng.permutation(np.concatenate(p)) if p
            else np.empty(0, np.int64) for p in parts]


def _cv_folds(args, y, classify: bool):
    """The -v folds after the checks every -v run makes, or None after
    printing the diagnostic."""
    k = args.cross_validate
    if k < 2:
        print("error: -v requires N >= 2 folds", file=sys.stderr)
        return None
    if len(y) < k:
        print(f"error: -v {k} needs at least {k} rows", file=sys.stderr)
        return None
    folds = _fold_split(y, k, seed=0, stratify=classify)
    if classify:
        for i, held in enumerate(folds):
            tr_mask = np.ones(len(y), bool)
            tr_mask[held] = False
            if len(np.unique(y[tr_mask])) < 2:
                print(f"error: fold {i} would lose a class (a class has "
                      "too few members); lower -v or provide more data",
                      file=sys.stderr)
                return None
    return folds


def _run_folds(args, x, y, folds, fit_predict) -> np.ndarray:
    """Each fold refit on the others and scored: the held-out
    predictions in row order."""
    pred = np.empty(len(y), np.float64)
    for i, held in enumerate(folds):
        tr = np.concatenate([f for j, f in enumerate(folds) if j != i])
        pred[held] = np.asarray(fit_predict(x[tr], y[tr], x[held]),
                                np.float64)
        if not args.quiet:
            print(f"  fold {i + 1}/{len(folds)}: trained on {len(tr)}, "
                  f"scored {len(held)}", file=sys.stderr)
    return pred


def _cross_validate(args, x, y, config, mesh=None) -> int:
    """LibSVM svm-train -v: stratified (classifiers) k-fold refits of the
    requested family, LibSVM's output lines (process 0's in a job), and
    no model file."""
    if args.svm_type == "one-class":
        print("error: -v cross-validation is not defined for one-class "
              "(no held-out labels to score)", file=sys.stderr)
        return 2
    if args.kernel == "precomputed":
        print("error: -v does not compose with --kernel precomputed "
              "(folds would need per-fold Gram sub-matrices; precompute "
              "per-fold Grams and run them separately)", file=sys.stderr)
        return 2
    ignored = [flag for flag, val in (
        ("-b 1", args.probability), ("--checkpoint", args.checkpoint),
        ("--resume", args.resume)) if val]
    if ignored:
        print(f"error: -v does not compose with {', '.join(ignored)} "
              "(fold refits are throwaway models; run a plain train for "
              "those)", file=sys.stderr)
        return 2
    classify = args.svm_type in ("c-svc", "nu-svc")
    folds = _cv_folds(args, y, classify)
    if folds is None:
        return 2
    from dpsvm_tpu_torch.parallel.mesh import process_index
    from dpsvm_tpu_torch.predict import predict

    fit = _fold_fit_factory(args, config, mesh)

    def fit_predict(xt, yt, xh):
        model = fit(xt, yt)
        if classify:
            return predict(model, xh, device=args.device)
        return model.predict(xh, device=args.device)

    t0 = time.perf_counter()
    pred = _run_folds(args, x, y, folds, fit_predict)
    if process_index() != 0:  # the job's report comes from process 0
        return 0
    if classify:
        acc = float(np.mean(pred == y))
        print(f"Cross Validation Accuracy = {100.0 * acc:g}%")
    else:
        z = np.asarray(y, np.float64)
        mse = float(np.mean((pred - z) ** 2))
        vp, vz = pred - pred.mean(), z - z.mean()
        denom = float(np.sum(vp ** 2) * np.sum(vz ** 2))
        r2 = float(np.sum(vp * vz) ** 2 / denom) if denom > 0 else 0.0
        print(f"Cross Validation Mean squared error = {mse:g}")
        print(f"Cross Validation Squared correlation coefficient = {r2:g}")
    if not args.quiet:
        print(f"({len(folds)}-fold over {len(y)} rows in "
              f"{time.perf_counter() - t0:.2f}s; no model file written — "
              "LibSVM -v contract)", file=sys.stderr)
    return 0


def _cross_validate_multiclass(args, x, y, config, mesh=None) -> int:
    """svm-train -v on a multiclass file: stratified k-fold over the
    OvR / OvO reduction (on `mesh` where the backend takes it), LibSVM's
    accuracy line (process 0's in a job), no model file."""
    from dpsvm_tpu_torch.models.multiclass import (predict_multiclass,
                                                   train_multiclass)
    from dpsvm_tpu_torch.parallel.mesh import process_index

    folds = _cv_folds(args, y, classify=True)
    if folds is None:
        return 2

    def fit_predict(xt, yt, xh):
        model, _ = train_multiclass(xt, yt, config,
                                    strategy=args.multiclass,
                                    backend=args.backend,
                                    num_devices=args.num_devices,
                                    device=args.device, mesh=mesh)
        return predict_multiclass(model, xh, device=args.device)

    t0 = time.perf_counter()
    pred = _run_folds(args, x, y, folds, fit_predict)
    acc = float(np.mean(pred == np.asarray(y, np.float64)))
    if process_index() == 0:
        print(f"Cross Validation Accuracy = {100.0 * acc:g}%")
    if not args.quiet:
        print(f"({len(folds)}-fold over {len(y)} rows in "
              f"{time.perf_counter() - t0:.2f}s; no model file written — "
              "LibSVM -v contract)", file=sys.stderr)
    return 0


def _train_precomputed(args, x, y, config, mesh=None) -> int:
    """Train on a user-supplied Gram matrix (LibSVM -t 4), on `mesh`
    where the backend takes it. The model carries SV indices
    (models/precomputed.py) and saves as .npz (process 0's in a job)."""
    from dpsvm_tpu_torch.models.precomputed import PrecomputedSVCModel
    from dpsvm_tpu_torch.parallel.mesh import process_index
    from dpsvm_tpu_torch.train import resolve_backend, solve_on

    n = x.shape[0]
    if x.shape[1] != n:
        print(f"error: --kernel precomputed needs the square (n, n) Gram "
              f"matrix as features; {args.file_path} is {x.shape[0]} x "
              f"{x.shape[1]}", file=sys.stderr)
        return 2
    try:
        # The mesh's precomputed path is the block engine's (auto takes
        # the mesh only there).
        backend = resolve_backend(args.backend, config, args.device,
                                  args.num_devices, mesh)
        result = solve_on(backend, x, y, config, args.device,
                          args.num_devices, mesh,
                          checkpoint_path=args.checkpoint,
                          resume=args.resume)
    except (ValueError, NotImplementedError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    model = PrecomputedSVCModel.from_solution(y, result.alpha, result.b)
    if result.converged:
        print(f"converged at iteration {result.iterations}")
    else:
        print(f"stopped at max-iter {result.iterations} without converging")
    print(f"training took {result.train_seconds:.2f}s")
    print(f"b: {result.b:.6f}")
    print(f"support vectors: {model.n_sv}")
    if process_index() == 0:
        # The training Gram's rows ARE K(train, train).
        acc = float(np.mean(model.predict(x, device=args.device) == y))
        print(f"train accuracy: {acc:.4f}")
    if not args.model.endswith(".npz"):
        args.model += ".npz"
        print("note: precomputed-kernel models use the .npz format "
              "(they store SV indices, not feature rows)")
    _write_model(model, args.model)
    return 0


def _model_type(path: str) -> str:
    """The .npz model_type field ("svr", "oneclass", "precomputed_svc",
    "multiclass"), else "classifier" (the text format is
    classifier-only)."""
    if not path.endswith(".npz"):
        return "classifier"
    with np.load(path, allow_pickle=False) as z:
        kind = str(z["model_type"]) if "model_type" in z else ""
        if kind not in ("svr", "oneclass", "precomputed_svc",
                        "multiclass"):
            kind = "classifier"
        if kind == "classifier" and "n_models" in z and "strategy" in z:
            kind = "multiclass"  # a bundle saved before the tag existed
    return kind


def _load_eval_data(args, model_width: int, float_labels: bool = False):
    """The test file at its own width, reconciled with the model's (the
    JAX package's rules): a wider CSV is an error unless -a consents to
    truncation, a wider LIBSVM file is truncated with a warning, a
    narrower LIBSVM file is zero-padded, a narrower CSV is an error.
    Returns (x, y), or None after printing the diagnostic."""
    from dpsvm_tpu_torch.data.loader import load_data, sniff_format

    fmt = args.format
    if fmt == "auto":
        fmt = sniff_format(args.file_path)
    if args.num_att is not None and args.num_att != model_width:
        print(f"error: -a {args.num_att} conflicts with the model's "
              f"{model_width} features (the model fixes the width; use "
              f"-a {model_width} to consent to truncation)",
              file=sys.stderr)
        return None
    try:
        x, y = load_data(args.file_path, args.num_ex, None,
                         float_labels=float_labels, fmt=fmt)
    except ValueError as e:
        print(f"error: could not load {args.file_path} (format={fmt}): "
              f"{e}\nhint: pass --format csv|libsvm to override "
              "auto-detection", file=sys.stderr)
        return None
    w = x.shape[1]
    if w < model_width:
        if fmt != "libsvm":
            print(f"error: {args.file_path} has {w} features but the "
                  f"model expects {model_width} (CSV columns are "
                  "positional)", file=sys.stderr)
            return None
        x = np.pad(x, ((0, 0), (0, model_width - w)))
    elif w > model_width:
        if args.num_att is None and fmt != "libsvm":
            print(f"error: {args.file_path} has {w} features but the "
                  f"model expects {model_width}; pass -a {model_width} to "
                  "truncate explicitly if this is intended",
                  file=sys.stderr)
            return None
        print(f"warning: {args.file_path} has {w} features; using the "
              f"first {model_width} the model expects", file=sys.stderr)
        x = np.ascontiguousarray(x[:, :model_width])
    return x, y


def _write_predictions(args, values, fmt: str = "%d") -> None:
    """-o: one prediction per line."""
    if not args.output:
        return
    with open(args.output, "w") as fh:
        fh.writelines((fmt % v) + "\n" for v in values)
    print(f"predictions written to {args.output}")


def _test_svr(args) -> int:
    from dpsvm_tpu_torch.models.svr import SVRModel

    model = SVRModel.load(args.model)
    loaded = _load_eval_data(args, model.sv_x.shape[1], float_labels=True)
    if loaded is None:
        return 2
    x, z_true = loaded
    pred = np.asarray(model.predict(x, device=args.device), np.float64)
    rmse = float(np.sqrt(np.mean((pred - z_true) ** 2)))
    ss_tot = float(np.sum((z_true - z_true.mean()) ** 2))
    r2 = (1.0 - float(np.sum((pred - z_true) ** 2)) / ss_tot
          if ss_tot else 0.0)
    print(f"loaded SVR model: {model.n_sv} SVs, gamma={model.kernel.gamma}")
    print(f"test RMSE: {rmse:.6f}  R2: {r2:.4f} ({x.shape[0]} examples)")
    _write_predictions(args, pred, fmt="%.9g")
    return 0


def _test_oneclass(args) -> int:
    from dpsvm_tpu_torch.models.oneclass import OneClassModel

    model = OneClassModel.load(args.model)
    loaded = _load_eval_data(args, model.sv_x.shape[1])
    if loaded is None:
        return 2
    x, y = loaded
    pred = model.predict(x, device=args.device)
    print(f"loaded one-class model: {model.n_sv} SVs, rho={model.rho:.6f}")
    print(f"test inlier fraction: {float(np.mean(pred > 0)):.4f} "
          f"({x.shape[0]} examples)")
    if set(np.unique(y).tolist()) <= {-1, 1}:
        print(f"test accuracy vs +-1 labels: "
              f"{float(np.mean(pred == y)):.4f}")
    _write_predictions(args, pred)
    return 0


def _test_multiclass(args) -> int:
    from dpsvm_tpu_torch.models.multiclass import (MulticlassSVM,
                                                   predict_multiclass)

    if args.gamma is not None:
        print("error: -g does not apply to a multiclass bundle (its "
              "submodels carry their trained kernels); retrain with the "
              "desired gamma", file=sys.stderr)
        return 2
    model = MulticlassSVM.load(args.model)
    loaded = _load_eval_data(args, model.models[0].sv_x.shape[1])
    if loaded is None:
        return 2
    x, y = loaded
    extra = sorted(set(np.unique(y).tolist()) - set(model.classes.tolist()))
    if extra:
        print(f"error: test labels {extra[:6]} are not among the model's "
              f"classes {model.classes.tolist()[:6]}", file=sys.stderr)
        return 2
    pred = predict_multiclass(model, x, device=args.device)
    acc = float(np.mean(pred == y))
    print(f"loaded multiclass model: {len(model.classes)} classes, "
          f"{model.strategy}, {len(model.models)} submodels, "
          f"{sum(m.n_sv for m in model.models)} total SVs")
    print(f"test accuracy: {acc:.4f} ({x.shape[0]} examples)")
    _write_predictions(args, pred)
    return 0


def _test_precomputed(args) -> int:
    from dpsvm_tpu_torch.models.precomputed import PrecomputedSVCModel

    model = PrecomputedSVCModel.load(args.model)
    # The test file's columns are K(test, train): width n_train, as in
    # LibSVM's precomputed svm-predict.
    loaded = _load_eval_data(args, model.n_train)
    if loaded is None:
        return 2
    x, y = loaded
    pred = model.predict(x, device=args.device)
    print(f"loaded precomputed-kernel model: {model.n_sv} SVs over "
          f"{model.n_train} training points, b={model.b:.6f}")
    print(f"test accuracy: {float(np.mean(pred == y)):.4f} "
          f"({x.shape[0]} examples)")
    _write_predictions(args, pred)
    return 0


def _cmd_test(args) -> int:
    from dpsvm_tpu_torch.models.svm_model import SVMModel
    from dpsvm_tpu_torch.ops.kernels import KernelParams
    from dpsvm_tpu_torch.predict import (decision_function, decision_risk,
                                         resolve_precision)

    kind = _model_type(args.model)
    if kind != "classifier" and args.probability:
        print(f"error: -b 1 is not applicable to a {kind} model",
              file=sys.stderr)
        return 2
    if kind != "classifier" and args.precision != "auto":
        print(f"error: --precision {args.precision} applies to binary "
              f"classifier models only, not a {kind} model",
              file=sys.stderr)
        return 2
    tests = {"svr": _test_svr, "oneclass": _test_oneclass,
             "multiclass": _test_multiclass,
             "precomputed_svc": _test_precomputed}
    if kind in tests:
        return tests[kind](args)
    model = SVMModel.load(args.model)
    if args.gamma is not None:
        model.kernel = KernelParams(model.kernel.kind, args.gamma,
                                    model.kernel.degree, model.kernel.coef0)
    loaded = _load_eval_data(args, model.num_features)
    if loaded is None:
        return 2
    x, y = loaded
    if not set(np.unique(y).tolist()) <= {-1, 1}:
        print(f"error: {args.model} is a binary +-1 model but the test "
              f"file's labels are {np.unique(y).tolist()[:6]}",
              file=sys.stderr)
        return 2
    prec = args.precision
    if prec == "auto":
        prec = resolve_precision(model)
        if prec == "float64":
            print(f"precision auto: decision_risk {decision_risk(model):.3g}"
                  " >= 0.1 -> exact float64 evaluation (pass --precision "
                  "float32 to force the device path)", file=sys.stderr)
    dec = decision_function(model, x, precision=prec, device=args.device)
    proba = None
    if args.probability:
        if not model.has_probability:
            print("error: -b 1 needs a model trained with -b 1 (no Platt "
                  "calibration in this model file)", file=sys.stderr)
            return 2
        from dpsvm_tpu_torch.models.platt import platt_probability

        proba = platt_probability(dec, model.prob_a, model.prob_b)
    # Under -b 1 the label is the max-probability one (Platt's B can move
    # p = 0.5 off dec = 0), as LibSVM's svm-predict -b 1 scores it.
    pred = (np.where(proba >= 0.5, 1, -1) if proba is not None
            else np.where(dec >= 0, 1, -1))
    acc = float(np.mean(pred == y))
    print(f"loaded model: {model.n_sv} SVs, gamma={model.kernel.gamma}, "
          f"b={model.b:.6f}"
          + (", platt-calibrated" if model.has_probability else ""))
    print(f"test accuracy: {acc:.4f} ({x.shape[0]} examples)"
          + (" [labels by max probability, svm-predict -b 1 style]"
             if proba is not None else ""))
    if proba is None:
        _write_predictions(args, pred)
        return 0
    print(f"test log-loss: {_log_loss(proba, y):.4f} (Platt "
          f"A={model.prob_a:.6f} B={model.prob_b:.6f})")
    if args.output:
        with open(args.output, "w") as fh:
            fh.write("label p(+1)\n")
            fh.writelines(f"{int(pi)} {pr:.6f}\n"
                          for pi, pr in zip(pred, proba))
        print(f"predictions written to {args.output}")
    return 0


def _serve_obs(args):
    """The serve run log's ObsConfig from --obs / --obs-dir."""
    from dpsvm_tpu_torch.config import ObsConfig

    return ObsConfig(enabled=bool(args.obs),
                     runlog_dir=args.obs_dir)


def _serve_buckets(text: str):
    """--buckets: None for 'auto' (the default ladder), else the ints."""
    if text.strip() == "auto":
        return None
    return tuple(int(t) for t in text.split(",") if t)


def _cmd_serve(args) -> int:
    """Run the v1 server (serve.py PredictServer) on a saved model: the
    offered-load micro-benchmark (--server-bench), or a stdin loop (one
    comma-separated feature row a line -> one label a line, micro-batched
    into the buckets; a blank line flushes). --registry, --journal,
    --listen or --replicas > 1 run the v2 engine instead."""
    import json

    from dpsvm_tpu_torch.config import ServeConfig
    from dpsvm_tpu_torch.serve import PredictServer, offered_load_sweep

    if args.registry or args.journal or args.listen or args.replicas > 1:
        return _cmd_serve_v2(args)
    if not args.model:
        print("error: -m/--model is required (or --registry NAME=PATH "
              "for the v2 engine)", file=sys.stderr)
        return 2
    kind = _model_type(args.model)
    if kind not in ("classifier", "multiclass"):
        print(f"error: cannot serve a {kind} model (the serving engine "
              "is the classifier decision path)", file=sys.stderr)
        return 2
    if kind == "multiclass":
        from dpsvm_tpu_torch.models.multiclass import MulticlassSVM
        model = MulticlassSVM.load(args.model)
    else:
        from dpsvm_tpu_torch.models.svm_model import SVMModel
        model = SVMModel.load(args.model)
    try:
        config = ServeConfig(buckets=_serve_buckets(args.buckets),
                             dtype=args.dtype,
                             union_storage=args.union_storage,
                             precision=args.precision,
                             num_devices=args.num_devices,
                             metrics_port=args.metrics_port,
                             metrics_host=args.metrics_host,
                             slo_ms=args.slo_ms, obs=_serve_obs(args))
        t0 = time.perf_counter()
        server = PredictServer(model, config, device=args.device)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if server.exporter is not None and not args.quiet:
        print(f"metrics: {server.exporter.url} (OpenMetrics)",
              file=sys.stderr)
    if not args.quiet:
        ens = server.ens
        print(f"server ready in {time.perf_counter() - t0:.2f}s on "
              f"{server.device}: {server.k} decision columns over a "
              f"{ens.n_union}-row SV union ({int(ens.counts.sum())} "
              f"stacked SVs compacted; {len(server.f64_cols)} "
              f"float64-routed columns), buckets {server.buckets}, union "
              f"storage {server.union_storage}", file=sys.stderr)
    if args.server_bench:
        try:
            sizes = [int(t) for t in args.request_sizes.split(",") if t]
            rec = offered_load_sweep(server, sizes, args.requests,
                                     group=args.group)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if not args.quiet:
            lat = rec["request_latency"]
            print("request latency (shared histogram): "
                  + " ".join(f"{k}={v * 1e3:.2f}ms"
                             for k, v in lat.items()), file=sys.stderr)
        server.close()
        print(json.dumps(rec))
        return 0

    buf: list = []

    def _emit(lines) -> None:
        rows = np.asarray([[float(v) for v in ln.split(",")]
                           for ln in lines], np.float32)
        for lab in server.predict(rows):
            print(int(lab))
        sys.stdout.flush()  # piped clients wait on these labels

    try:
        for line in sys.stdin:
            ln = line.strip()
            if not ln:
                if buf:
                    _emit(buf)
                    buf = []
                continue
            buf.append(ln)
            if len(buf) >= server.buckets[-1]:
                _emit(buf)
                buf = []
        if buf:
            _emit(buf)
    except ValueError as e:
        print(f"error: bad query row ({e})", file=sys.stderr)
        return 2
    server.close()
    if not args.quiet:
        st = server.stats
        print(f"served {st['rows']} rows in {st['dispatches']} "
              f"dispatches (bucket counts {st['bucket_counts']}, "
              f"{st['padded_rows']} padded rows)", file=sys.stderr)
    return 0


def _cmd_serve_v2(args) -> int:
    """`serve --registry NAME=PATH [...]`: the v2 engine. stdin: one
    comma-separated feature row a line, optionally prefixed ``NAME|``
    (bare rows need exactly one model); ``swap NAME=PATH`` hot-swaps; a
    blank line (or EOF) drains and prints ``NAME label`` per request in
    submit order (``NAME MISS`` for work shed past its deadline). With
    --listen, the network front door instead of stdin."""
    from dpsvm_tpu_torch.config import ServeConfig
    from dpsvm_tpu_torch.serving import (ModelLoadError, ReplicaFleet,
                                         ServingEngine)

    if args.model:
        print("error: use either -m (v1 single-model server) or "
              "--registry (v2 engine), not both", file=sys.stderr)
        return 2
    if args.server_bench:
        print("error: --server-bench drives the v1 server (-m)",
              file=sys.stderr)
        return 2
    if args.precision != "auto":
        print("error: the v2 engine always risk-routes per submodel "
              "(--precision auto semantics); the forced modes are the "
              "v1 server's", file=sys.stderr)
        return 2
    specs = []
    for spec in args.registry or []:
        name, sep, path = spec.partition("=")
        if not sep or not name or not path:
            print(f"error: --registry wants NAME=PATH, got {spec!r}",
                  file=sys.stderr)
            return 2
        specs.append((name, path))
    try:
        timeouts = {}
        if args.conn_timeout_ms is not None:
            timeouts = dict(conn_read_timeout_ms=args.conn_timeout_ms,
                            conn_write_timeout_ms=args.conn_timeout_ms)
        config = ServeConfig(
            buckets=_serve_buckets(args.buckets), dtype=args.dtype,
            union_storage=args.union_storage,
            num_devices=args.num_devices, deadline_ms=args.deadline_ms,
            dispatch_timeout_ms=args.dispatch_timeout_ms,
            journal_path=args.journal, listen=args.listen,
            replicas=args.replicas,
            admission_max_rows=args.admission_max_rows,
            metrics_port=args.metrics_port,
            metrics_host=args.metrics_host, slo_ms=args.slo_ms,
            obs=_serve_obs(args), **timeouts)
        t0 = time.perf_counter()
        if config.replicas > 1:
            engine = ReplicaFleet(config, device=args.device)
            eng0 = engine.engines[0]
        else:
            engine = ServingEngine(config, device=args.device)
            eng0 = engine
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if eng0._rehydrated and not args.quiet:
        print(f"rehydrated {len(eng0._rehydrated)} model(s) from "
              f"{config.journal_path}: "
              + ", ".join(f"{e.name} v{e.version}"
                          for e in eng0.registry.entries()),
              file=sys.stderr)
    try:
        for name, path in specs:
            entry = engine.register(name, path)
            if not args.quiet:
                print(f"registered {name} v{entry.version}: {entry.k} "
                      f"decision columns over a {int(entry.ens.n_union)}"
                      f"-row SV union ({entry.strategy}, d={entry.d})",
                      file=sys.stderr)
    except ModelLoadError as e:
        print(f"error: {e}", file=sys.stderr)
        engine.close()
        return 2
    if not eng0.registry.names():
        print("error: no models to serve (--registry NAME=PATH, or a "
              "--journal with recorded models)", file=sys.stderr)
        engine.close()
        return 2
    if engine.exporter is not None and not args.quiet:
        print(f"metrics: {engine.exporter.url} (OpenMetrics)",
              file=sys.stderr)
    if not args.quiet:
        print(f"engine ready in {time.perf_counter() - t0:.2f}s on "
              f"{eng0.device}: {len(eng0.registry.names())} models"
              + (f" x {config.replicas} replicas"
                 if config.replicas > 1 else "")
              + f", deadline {config.deadline_ms or 'none'} ms",
              file=sys.stderr)
    if args.listen:
        return _serve_listen(args, engine)

    order: list = []

    def _drain_print() -> None:
        done = engine.drain()
        for ticket in order:
            if ticket not in done:
                continue
            res = done[ticket]
            lab = res.labels()  # the SERVING version's fold
            if lab is None:
                print(f"{res.model} MISS")
            else:
                print(f"{res.model} {int(lab[0])}")
        order.clear()
        sys.stdout.flush()  # piped clients wait on these labels

    for line in sys.stdin:
        ln = line.strip()
        if not ln:
            _drain_print()
            continue
        if ln.startswith("swap "):
            name, sep, path = ln[5:].strip().partition("=")
            if not sep:
                print("error: swap wants NAME=PATH", file=sys.stderr)
                continue
            try:
                entry = engine.swap(name, path)
                print(f"swapped {name} -> v{entry.version}",
                      file=sys.stderr)
            except (ModelLoadError, KeyError) as e:
                # A bad file or name is refused; the prior version serves.
                print(f"error: {e}", file=sys.stderr)
            continue
        name, sep, row = ln.partition("|")
        if not sep:
            name, row = None, ln
        try:
            rows = np.asarray([[float(v) for v in row.split(",")]],
                              np.float32)
            order.append(engine.submit(rows, model=name))
        except (ValueError, KeyError) as e:
            print(f"error: skipped bad query line ({e})", file=sys.stderr)
    _drain_print()
    engine.close()
    if not args.quiet:
        snap = engine.snapshot()
        print(f"served {snap['rows']} rows in {snap['dispatches']} "
              f"dispatches ({snap['coalesced_dispatches']} coalesced; "
              f"{snap['deadline_misses']} deadline misses, "
              f"{snap['hot_swaps']} hot swaps)", file=sys.stderr)
    return 0


def _serve_listen(args, engine, stop_event=None) -> int:
    """`serve --listen HOST:PORT`: the network front door until SIGTERM
    or SIGINT, then a graceful drain (finish or shed in-flight work by
    its own deadline, flush the verdicts, GOODBYE each connection) and
    the engine's close. `stop_event` replaces the signals (tests)."""
    import signal
    import threading

    from dpsvm_tpu_torch.serving.server import ServeServer

    server = ServeServer(engine)
    stop = stop_event if stop_event is not None else threading.Event()
    handled = {}
    if stop_event is None:
        def _on_signal(signum, frame):
            stop.set()  # the drain runs on the main thread

        for sig in (signal.SIGTERM, signal.SIGINT):
            handled[sig] = signal.signal(sig, _on_signal)
    if not args.quiet:
        print(f"front door listening on {server.host}:{server.port} "
              "(SIGTERM = graceful drain)", file=sys.stderr, flush=True)
    try:
        stop.wait()
        # Our handler stays installed through the drain: a second
        # SIGTERM is a no-op, not a kill mid-drain.
        snap = server.close()
        engine.close()
    finally:
        for sig, prev in handled.items():
            signal.signal(sig, prev)
    if not args.quiet:
        v = snap["verdicts"]
        print(f"drained: {snap['frames_accepted']} frames over "
              f"{snap['conns_opened']} connections -> "
              + " ".join(f"{k}={v[k]}" for k in sorted(v))
              + (f" undeliverable={snap['undeliverable_total']}"
                 if snap["undeliverable_total"] else ""),
              file=sys.stderr)
    return 0


def _cmd_lint(argv: list) -> int:
    """`lint --threads ...` runs threadlint with the rest of argv; `lint
    ...` without it the structural linter (analysis/budget.py run_lint,
    the JAX package's tpulint)."""
    if "--threads" not in argv:
        from dpsvm_tpu_torch.analysis.budget import run_lint

        return run_lint(argv)
    from dpsvm_tpu_torch.analysis.threadlint import run_threadlint

    return run_threadlint([a for a in argv if a != "--threads"])


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["learn"]:
        # Forwarded verbatim: learn.py owns the flags of the loop.
        from dpsvm_tpu_torch.learn import run_cli

        return run_cli(argv[1:])
    if argv[:1] == ["obs"]:
        # Forwarded verbatim: obs/analyze.py owns the flags.
        from dpsvm_tpu_torch.obs.analyze import run_cli as obs_cli

        return obs_cli(argv[1:])
    if argv[:1] == ["autotune"]:
        # Forwarded verbatim: autotune/__init__.py owns the flags.
        from dpsvm_tpu_torch.autotune import run_cli as autotune_cli

        return autotune_cli(argv[1:])
    if argv[:1] == ["lint"]:
        return _cmd_lint(argv[1:])
    args = _build_parser().parse_args(argv)
    if args.command == "train":
        return _cmd_train(args)
    if args.command == "smoke":
        return _cmd_smoke(args)
    if args.command == "serve":
        return _cmd_serve(args)
    return _cmd_test(args)


def train_main() -> int:
    """The `svmtrain` console entry (the reference's ./svmTrain role):
    `train` with this process's arguments."""
    return main(["train"] + sys.argv[1:])


def test_main() -> int:
    """The `svmtest` console entry (the reference's svmTest role)."""
    return main(["test"] + sys.argv[1:])


def serve_main() -> int:
    """The `svmserve` console entry: the persistent serving engine."""
    return main(["serve"] + sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
