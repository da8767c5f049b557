"""Command-line entry points ``train`` and ``test`` (the train/test subset
of dpsvm_tpu/cli.py, same flag names, plus ``--device``).

Usage:
    python -m dpsvm_tpu_torch.cli train -f train.csv -m model.txt -c 10 \\
        -g 0.125 [--engine xla|pallas|block] [--backend mesh \
        --num-devices 4 --ring-exchange on]
        [-t nu-svc|eps-svr|nu-svr|one-class --nu 0.5 -p 0.1]
    python -m dpsvm_tpu_torch.cli test -f test.csv -m model.txt
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
    p = sub.add_parser("train", help="train an SVM with modified SMO")
    p.add_argument("-f", "--file-path", required=True,
                   help="training data: CSV (label,f1,...,fd)")
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
    p.add_argument("--fused-round", choices=["auto", "on", "off"],
                   default="auto",
                   help="block engine: one-pass rounds (gather, kernel "
                        "rows and Gram block in one pass over X, fold and "
                        "next selection in one pass over f; "
                        "SVMConfig.fused_round). auto = off")
    p.add_argument("--pipeline-rounds", choices=["auto", "on", "off"],
                   default="auto",
                   help="block engine: select, gather and build the next "
                        "round's Gram block from the pre-fold gradient "
                        "(stale selection, exact updates; "
                        "SVMConfig.pipeline_rounds). auto = off")
    p.add_argument("--local-working-sets", type=int, default=0,
                   help="mesh block engine: 0 = auto (off), 1 = one "
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
                        "off")
    p.add_argument("--backend", choices=["auto", "single", "mesh"],
                   default="auto",
                   help="single device, or the data mesh over the "
                        "visible cards; auto = the mesh when more than "
                        "one card is visible and --engine block")
    p.add_argument("--num-devices", type=int, default=None,
                   help="devices in the data mesh (default: all visible)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card); with "
                        "--backend mesh and --num-devices N, the device "
                        "every one of the N shards lives on (N logical "
                        "shards of it)")

    p = sub.add_parser("test", help="evaluate a trained model on a CSV")
    p.add_argument("-f", "--file-path", required=True)
    p.add_argument("-m", "--model", required=True,
                   help="model path (.txt or .npz)")
    p.add_argument("-a", "--num-att", type=int, default=None)
    p.add_argument("-x", "--num-ex", type=int, default=None)
    p.add_argument("-g", "--gamma", type=float, default=None,
                   help="override the model file's gamma")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return parser


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
    return None


def _fit(args, x, y, config, mesh):
    """Train the requested svm type: (model, result)."""
    from dpsvm_tpu_torch import models
    from dpsvm_tpu_torch.train import train

    common = dict(backend=args.backend, device=args.device,
                  num_devices=args.num_devices, mesh=mesh)
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


def _cmd_train(args) -> int:
    from dpsvm_tpu_torch.config import SVMConfig
    from dpsvm_tpu_torch.data.loader import load_csv
    from dpsvm_tpu_torch.predict import accuracy

    bad = _check_svm_type(args)
    if bad:
        print(f"error: {bad}", file=sys.stderr)
        return 2
    regression = args.svm_type in ("eps-svr", "nu-svr")
    t0 = time.perf_counter()
    x, y = load_csv(args.file_path, args.num_ex, args.num_att,
                    float_labels=regression)
    print(f"loaded {x.shape[0]} examples x {x.shape[1]} features "
          f"in {time.perf_counter() - t0:.2f}s")
    if args.svm_type in ("c-svc", "nu-svc") \
            and not set(np.unique(y).tolist()) <= {-1, 1}:
        print(f"error: {args.svm_type} trains +-1 labels; this file has "
              f"{np.unique(y).tolist()[:6]} (multiclass is not ported: "
              "ROADMAP queue A item 7a)", file=sys.stderr)
        return 2
    try:
        config = SVMConfig(
            c=args.cost, gamma=args.gamma, epsilon=args.epsilon,
            max_iter=args.max_iter, cache_lines=args.cache_size,
            selection=args.selection, pair_batch=args.pair_batch,
            engine=args.engine, working_set_size=args.working_set_size,
            inner_iters=args.inner_iters, dtype=args.dtype,
            fused_round=_TRI[args.fused_round],
            pipeline_rounds=_TRI[args.pipeline_rounds],
            local_working_sets=args.local_working_sets or None,
            sync_rounds=args.sync_rounds,
            ring_exchange=_TRI[args.ring_exchange])
        config.check_ported()
    except (ValueError, NotImplementedError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    mesh = None
    if args.backend == "mesh" and args.device is not None:
        from dpsvm_tpu_torch.parallel.mesh import Mesh

        mesh = Mesh([args.device] * (args.num_devices or 1))
    try:
        model, result = _fit(args, x, y, config, mesh)
    except (ValueError, NotImplementedError) as e:
        hint = ""
        if args.backend == "mesh" and args.device is None:
            hint = (" (--device cuda:0 runs --num-devices logical shards of "
                    "one card)")
        print(f"error: {e}{hint}", file=sys.stderr)
        return 2
    if result.converged:
        print(f"converged at iteration {result.iterations}")
    else:
        print(f"stopped at max-iter {result.iterations} without converging")
    rounds = result.stats.get("outer_rounds")
    where = result.stats.get("mesh_devices") or result.stats["device"]
    print(f"training took {result.train_seconds:.2f}s on {where}"
          + (f" ({rounds} rounds)" if rounds is not None else ""))
    if result.stats.get("cache_lookups"):
        print(f"cache hit rate: {result.stats['cache_hit_rate']:.4f}")
    print(f"b: {result.b:.6f}")
    print(f"support vectors: {result.n_sv}")
    if args.svm_type in ("c-svc", "nu-svc"):
        print(f"train accuracy: "
              f"{accuracy(model, x, y, device=args.device):.4f}")
    elif regression:
        resid = np.asarray(model.predict(x, device=args.device)) - y
        print(f"train RMSE: {float(np.sqrt(np.mean(resid ** 2))):.6f}")
    else:
        inlier = float(np.mean(model.predict(x, device=args.device) > 0))
        print(f"train inlier fraction: {inlier:.4f} (nu={args.nu})")
    if args.svm_type in ("eps-svr", "nu-svr", "one-class") \
            and not args.model.endswith(".npz"):
        args.model += ".npz"
        print(f"note: {args.svm_type} models use the .npz format")
    model.save(args.model)
    print(f"model written to {args.model}")
    return 0


def _model_type(path: str) -> str:
    """The .npz model_type field ("svr", "oneclass"), else
    "classifier" (the text format is classifier-only)."""
    if not path.endswith(".npz"):
        return "classifier"
    with np.load(path, allow_pickle=False) as z:
        kind = str(z["model_type"]) if "model_type" in z else ""
        if not kind and "n_models" in z and "strategy" in z:
            kind = "multiclass"  # a bundle saved before the tag existed
    if kind in ("svr", "oneclass", "classifier", ""):
        return kind or "classifier"
    raise NotImplementedError(
        f"{path}: model_type {kind!r} is not ported (multiclass and "
        "precomputed models: ROADMAP queue A items 7a and 6)")


def _test_svr(args) -> int:
    from dpsvm_tpu_torch.data.loader import load_csv
    from dpsvm_tpu_torch.models.svr import SVRModel

    model = SVRModel.load(args.model)
    x, z_true = load_csv(args.file_path, args.num_ex,
                         args.num_att or model.sv_x.shape[1],
                         float_labels=True)
    pred = np.asarray(model.predict(x, device=args.device), np.float64)
    rmse = float(np.sqrt(np.mean((pred - z_true) ** 2)))
    ss_tot = float(np.sum((z_true - z_true.mean()) ** 2))
    r2 = (1.0 - float(np.sum((pred - z_true) ** 2)) / ss_tot
          if ss_tot else 0.0)
    print(f"loaded SVR model: {model.n_sv} SVs, gamma={model.kernel.gamma}")
    print(f"test RMSE: {rmse:.6f}  R2: {r2:.4f} ({x.shape[0]} examples)")
    return 0


def _test_oneclass(args) -> int:
    from dpsvm_tpu_torch.data.loader import load_csv
    from dpsvm_tpu_torch.models.oneclass import OneClassModel

    model = OneClassModel.load(args.model)
    x, y = load_csv(args.file_path, args.num_ex,
                    args.num_att or model.sv_x.shape[1])
    pred = model.predict(x, device=args.device)
    print(f"loaded one-class model: {model.n_sv} SVs, rho={model.rho:.6f}")
    print(f"test inlier fraction: {float(np.mean(pred > 0)):.4f} "
          f"({x.shape[0]} examples)")
    if set(np.unique(y).tolist()) <= {-1, 1}:
        print(f"test accuracy vs +-1 labels: "
              f"{float(np.mean(pred == y)):.4f}")
    return 0


def _cmd_test(args) -> int:
    from dpsvm_tpu_torch.data.loader import load_csv
    from dpsvm_tpu_torch.models.svm_model import SVMModel
    from dpsvm_tpu_torch.ops.kernels import KernelParams
    from dpsvm_tpu_torch.predict import decision_function

    try:
        kind = _model_type(args.model)
    except NotImplementedError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if kind == "svr":
        return _test_svr(args)
    if kind == "oneclass":
        return _test_oneclass(args)
    model = SVMModel.load(args.model)
    if args.gamma is not None:
        model.kernel = KernelParams(model.kernel.kind, args.gamma,
                                    model.kernel.degree, model.kernel.coef0)
    x, y = load_csv(args.file_path, args.num_ex,
                    args.num_att or model.num_features)
    if not set(np.unique(y).tolist()) <= {-1, 1}:
        print(f"error: {args.model} is a binary +-1 model but the test "
              f"file's labels are {np.unique(y).tolist()[:6]}",
              file=sys.stderr)
        return 2
    dec = decision_function(model, x, precision="auto", device=args.device)
    acc = float(np.mean(np.where(dec >= 0, 1, -1) == y))
    print(f"loaded model: {model.n_sv} SVs, gamma={model.kernel.gamma}, "
          f"b={model.b:.6f}")
    print(f"test accuracy: {acc:.4f} ({x.shape[0]} examples)")
    return 0


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.command == "train":
        return _cmd_train(args)
    return _cmd_test(args)


if __name__ == "__main__":
    sys.exit(main())
