"""Multiclass SVM by one-vs-rest / one-vs-one reductions (counterpart of
dpsvm_tpu/models/multiclass.py; the two packages read each other's
bundles).

K binary problems (OvR) or K(K-1)/2 (OvO), each a run of the binary
solver, or all of them batched through the fleet (solver/fleet.py).
Prediction evaluates every submodel at once on the card: the stacked
form is one batched product over a (k, m_pad, d) stack of SVs, the
compacted form one kernel product against the union of all submodels'
SVs (they are rows of one training matrix) followed by an exact gather
of each submodel's columns. Where a submodel's float32 evaluation is
noise by predict.decision_risk_columns, its column is evaluated exactly
in float64 on the host (precision "auto").
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from dpsvm_tpu_torch.config import SVMConfig
from dpsvm_tpu_torch.device import resolve_device
from dpsvm_tpu_torch.models.svm_model import SVMModel
from dpsvm_tpu_torch.ops.kernels import KernelParams, kernel_from_dots
from dpsvm_tpu_torch.predict import (AUTO_F64_RISK, decision_function,
                                     decision_risk_columns)


@dataclasses.dataclass
class CompactedEnsemble:
    """Shared-SV compacted view of a multiclass ensemble.

    sv_union  (S+1, d) float32: the deduplicated SV rows (exact byte
              identity) plus one trailing all-zero PAD row, so a
              non-finite kernel value of a real row can never leak
              through pad slots (inf * 0) into other columns; empty when
              no submodel has SVs;
    coef      (S+1, k) float32: column j holds submodel j's alpha * y at
              its rows' union positions (duplicates within a model
              accumulate; the pad row is zero);
    b         (k,) float32 offsets;
    idx       (k, m_pad) int32: submodel j's SVs as union positions in
              its OWN SV order (pad slots point at the PAD row);
    coef_pad  (k, m_pad) float32: submodel j's dual coefficients in that
              order;
    counts    (k,) int32 true n_sv per submodel;
    kernel    the shared KernelParams.
    """

    sv_union: np.ndarray
    coef: np.ndarray
    b: np.ndarray
    idx: np.ndarray
    coef_pad: np.ndarray
    counts: np.ndarray
    kernel: KernelParams
    # The arrays on a device, uploaded once per (ensemble, device). The
    # arrays are frozen after build: rebuild through compact_models.
    _device: dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)

    @property
    def n_union(self) -> int:
        """Deduplicated REAL SV rows (the pad row excluded)."""
        return max(0, int(self.sv_union.shape[0]) - 1)

    @property
    def n_models(self) -> int:
        return int(self.coef.shape[1])

    @property
    def m_pad(self) -> int:
        return int(self.idx.shape[1])

    def device_arrays(self, dev: torch.device) -> tuple:
        """(sv_union, coef_pad, idx, b) on `dev`, uploaded once."""
        key = (dev.type, dev.index)
        if key not in self._device:
            self._device[key] = (
                torch.as_tensor(self.sv_union, device=dev),
                torch.as_tensor(self.coef_pad, device=dev),
                torch.as_tensor(self.idx.astype(np.int64), device=dev),
                torch.as_tensor(self.b, device=dev))
        return self._device[key]


def _sv_bucket(models) -> int:
    """The padded SV height shared by the stacked and compacted forms."""
    return 1 << max(4, (max((mm.sv_x.shape[0] for mm in models),
                            default=1) - 1).bit_length())


def compact_models(models, x_train=None) -> CompactedEnsemble:
    """Deduplicate SV rows across submodels into a CompactedEnsemble, by
    raw float32 bytes. With the training matrix at hand the union keeps
    training-row order (rows not found there keep first-seen order at
    the tail); without it, first-seen order. The exact contraction
    gathers each model's kernel values back into its own SV order, so
    the result does not depend on the union's order."""
    kp = models[0].kernel
    d = models[0].sv_x.shape[1]
    k = len(models)
    m_pad = _sv_bucket(models)
    svs_list = []
    coef_pad = np.zeros((k, m_pad), np.float32)
    counts = np.zeros((k,), np.int32)
    b = np.zeros((k,), np.float32)
    for j, mm in enumerate(models):
        if mm.kernel != kp:
            raise ValueError(
                "compact_models needs all submodels on one shared kernel "
                f"(model 0 has {kp}, model {j} has {mm.kernel})")
        svs = np.ascontiguousarray(np.asarray(mm.sv_x, np.float32))
        svs_list.append(svs)
        counts[j] = svs.shape[0]
        b[j] = mm.b
        coef_pad[j, :svs.shape[0]] = mm.dual_coef

    def _void(a):
        """Rows as opaque byte scalars: exact row identity at C speed."""
        return np.ascontiguousarray(a).view(
            np.dtype((np.void, a.dtype.itemsize * d))).reshape(-1)

    if int(counts.sum()) == 0:
        return CompactedEnsemble(
            sv_union=np.zeros((0, d), np.float32),
            coef=np.zeros((0, k), np.float32), b=b,
            idx=np.zeros((k, m_pad), np.int32), coef_pad=coef_pad,
            counts=counts, kernel=kp)
    all_rows = np.concatenate([s for s in svs_list if len(s)])
    _, first_idx, inverse = np.unique(_void(all_rows), return_index=True,
                                      return_inverse=True)
    # np.unique sorts by bytes; re-rank to first-seen order.
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty(len(first_idx), np.int64)
    rank[order] = np.arange(len(first_idx))
    pos_of_row = rank[inverse.reshape(-1)]
    union_rows = all_rows[first_idx[order]]
    if x_train is not None:
        xt = np.ascontiguousarray(np.asarray(x_train, np.float32))
        if xt.ndim == 2 and xt.shape[1] == d and xt.shape[0]:
            # Training-row order where the rows are found in x_train: one
            # np.unique over both row sets gives the join.
            both = np.concatenate([_void(xt), _void(union_rows)])
            _, inv2 = np.unique(both, return_inverse=True)
            inv2 = inv2.reshape(-1)
            tid, uid = inv2[:xt.shape[0]], inv2[xt.shape[0]:]
            tpos = np.full(int(inv2.max()) + 1, np.iinfo(np.int64).max,
                           np.int64)
            np.minimum.at(tpos, tid, np.arange(xt.shape[0]))
            order2 = np.argsort(tpos[uid], kind="stable")
            union_rows = union_rows[order2]
            rank2 = np.empty(len(order2), np.int64)
            rank2[order2] = np.arange(len(order2))
            pos_of_row = rank2[pos_of_row]
    s_real = union_rows.shape[0]
    sv_union = np.concatenate([union_rows, np.zeros((1, d), np.float32)])
    idx = np.full((k, m_pad), s_real, np.int32)
    coef = np.zeros((s_real + 1, k), np.float32)
    off = 0
    for j, svs in enumerate(svs_list):
        nsv = svs.shape[0]
        pj = pos_of_row[off:off + nsv]
        idx[j, :nsv] = pj
        np.add.at(coef[:, j], pj, coef_pad[j, :nsv])
        off += nsv
    return CompactedEnsemble(sv_union=sv_union, coef=coef, b=b, idx=idx,
                             coef_pad=coef_pad, counts=counts, kernel=kp)


@dataclasses.dataclass
class MulticlassSVM:
    classes: np.ndarray  # (k,) sorted original labels
    models: list  # OvR: k SVMModels; OvO: k(k-1)/2 in (i < j) order
    strategy: str  # "ovr" | "ovo"
    # The compacted view (None until built, or when the submodels do not
    # share one kernel); saved in the .npz bundle (format version 2).
    compacted: Optional[CompactedEnsemble] = None

    def shared_kernel(self) -> bool:
        return bool(self.models) and all(
            mm.kernel == self.models[0].kernel for mm in self.models)

    def ensure_compacted(self, x_train=None) -> Optional[CompactedEnsemble]:
        """Build (once) and return the compacted view; None when the
        submodels do not share one kernel."""
        if self.compacted is None and self.shared_kernel():
            self.compacted = compact_models(self.models, x_train=x_train)
        return self.compacted

    def save(self, path: str) -> None:
        if not path.endswith(".npz"):
            raise ValueError("multiclass models are saved as .npz")
        payload = {
            "format_version": 2,
            "model_type": "multiclass",
            "strategy": self.strategy,
            "classes": self.classes,
            "n_models": len(self.models),
        }
        for i, m in enumerate(self.models):
            payload.update(m.npz_payload(f"m{i}_"))
        comp = self.ensure_compacted()
        if comp is not None:
            payload.update(
                c_sv_union=comp.sv_union, c_coef=comp.coef,
                c_coef_pad=comp.coef_pad, c_idx=comp.idx,
                c_counts=comp.counts, c_b=comp.b)
        np.savez_compressed(path, **payload)

    @classmethod
    def load(cls, path: str) -> "MulticlassSVM":
        with np.load(path, allow_pickle=False) as z:
            models = [SVMModel.from_npz_payload(z, f"m{i}_")
                      for i in range(int(z["n_models"]))]
            obj = cls(classes=z["classes"], models=models,
                      strategy=str(z["strategy"]))
            if "c_sv_union" in z and obj.shared_kernel():
                obj.compacted = CompactedEnsemble(
                    sv_union=z["c_sv_union"].astype(np.float32),
                    coef=z["c_coef"].astype(np.float32),
                    b=z["c_b"].astype(np.float32),
                    idx=z["c_idx"].astype(np.int32),
                    coef_pad=z["c_coef_pad"].astype(np.float32),
                    counts=z["c_counts"].astype(np.int32),
                    kernel=models[0].kernel)
        # A version-1 bundle (or a mixed-kernel one) compacts at load.
        obj.ensure_compacted()
        return obj


def _fleet_eligible(config: SVMConfig, backend: str,
                    num_devices: Optional[int], trainer, device=None,
                    forced: bool = False) -> bool:
    """Whether the reduction routes through the fleet (solver/fleet.py)
    instead of K sequential solves: the plain C-SVC trainer on one
    device, with a config whose iteration the fleet reproduces. `forced`
    (use_fleet=True) raises on a disqualifying config instead."""
    from dpsvm_tpu_torch.solver.fleet import fleet_routing_reasons
    from dpsvm_tpu_torch.train import resolve_backend

    reasons = fleet_routing_reasons(config)
    if trainer is not None:
        reasons.append("a custom trainer is installed")
    if backend not in ("auto", "single"):
        reasons.append(f"backend={backend!r} (fleet is single-chip)")
    if config.fleet_size <= 1:
        reasons.append("fleet_size=1")
    if config.budget_mode:
        reasons.append("budget_mode pins per-solve pair budgets")
    if backend == "auto" and not reasons and resolve_backend(
            backend, config, device, num_devices) != "single":
        reasons.append("auto backend resolves to the mesh "
                       "(pass backend='single' to batch the fleet)")
    if reasons and forced:
        raise ValueError(
            "use_fleet=True but the config cannot route through the "
            "fleet executor: " + "; ".join(reasons))
    return not reasons


def _train_multiclass_fleet(x, y, classes, config: SVMConfig,
                            strategy: str, verbose: bool, device):
    """The fleet-batched reduction: OvR's k problems (all rows) or OvO's
    k(k-1)/2 masked problems in ceil(K / fleet_size) fleets. Each
    result's alpha covers exactly its problem's rows, so the models are
    assembled as on the sequential path."""
    from dpsvm_tpu_torch.solver.fleet import (FleetProblem, fleet_chunks,
                                              solve_fleet)

    kp = KernelParams(config.kernel, config.resolve_gamma(x.shape[1]),
                      config.degree, config.coef0)
    if strategy == "ovr":
        problems = [
            FleetProblem(y=np.where(y == cl, 1, -1).astype(np.int32),
                         tag=("ovr", cl))
            for cl in classes]
    else:
        problems = []
        for a in range(len(classes)):
            for b in range(a + 1, len(classes)):
                mask = (y == classes[a]) | (y == classes[b])
                problems.append(FleetProblem(
                    y=np.where(y == classes[a], 1, -1).astype(np.int32),
                    row_mask=mask, tag=("ovo", classes[a], classes[b])))
    models, results = [], []
    for chunk in fleet_chunks(problems, config.fleet_size):
        for p, res in zip(chunk, solve_fleet(x, chunk, config,
                                             device=device)):
            if p.row_mask is None:
                xs, ys = x, p.y
            else:
                xs, ys = x[p.row_mask], p.y[p.row_mask]
            models.append(SVMModel.from_dense(xs, ys, res.alpha, res.b, kp))
            results.append(res)
            if verbose:
                tag = p.tag
                name = (f"ovr class={tag[1]}" if tag[0] == "ovr"
                        else f"ovo {tag[1]} vs {tag[2]}")
                print(f"[fleet {name}] iters={res.iterations} "
                      f"n_sv={res.n_sv} "
                      f"(fleet of {res.stats['fleet']['size']}, "
                      f"{res.stats['fleet']['trips']} trips)")
    mc = MulticlassSVM(classes=classes, models=models, strategy=strategy)
    mc.ensure_compacted(x_train=x)
    return mc, results


def train_multiclass(x, y, config: SVMConfig = SVMConfig(),
                     strategy: str = "ovr", backend: str = "auto",
                     num_devices: Optional[int] = None,
                     verbose: bool = False, trainer=None,
                     use_fleet: Optional[bool] = None,
                     device=None) -> tuple:
    """Train a multiclass SVM on `device` (None: the CUDA card); y may
    hold any integer labels. Returns (MulticlassSVM, [SolveResult]).

    `trainer(x, y_pm, config, backend=..., num_devices=..., pad_to=...)
    -> (SVMModel, SolveResult)` swaps the binary solver under the
    reduction (estimators.NuSVC passes a nu-SVC trainer); the default is
    C-SVC train on `device`. OvO hands each pair's subset a power-of-two
    `pad_to` bucket, as the JAX package does (the port's solve sizes
    the resident-Gram budget by it and pads nothing).

    `use_fleet`: None routes eligible configs through the fleet
    (_fleet_eligible), True forces it (raising on a disqualifying
    config), False keeps the sequential solves."""
    if config.kernel == "precomputed":
        raise ValueError(
            "kernel='precomputed' is implemented for binary C-SVC only "
            "(each OvR/OvO split needs its own Gram sub-matrix); the "
            "reduction would need a transformed Gram matrix, not "
            "transformed features")
    from dpsvm_tpu_torch.train import train

    user_trainer = trainer
    if trainer is None:
        def trainer(xx, yy, cfg, backend="auto", num_devices=None,
                    pad_to=None):
            return train(xx, yy, cfg, backend=backend, device=device,
                         num_devices=num_devices, pad_to=pad_to)

    x = np.asarray(x, np.float32)
    y = np.asarray(y)
    classes = np.unique(y)
    if classes.shape[0] < 2:
        raise ValueError("need at least 2 classes")
    if classes.shape[0] == 2:
        # Two classes: the OvO reduction IS one binary model.
        strategy = "ovo"
    if strategy in ("ovr", "ovo") and use_fleet is not False \
            and _fleet_eligible(config, backend, num_devices, user_trainer,
                                device, forced=use_fleet is True):
        return _train_multiclass_fleet(x, y, classes, config, strategy,
                                       verbose, device)
    models, results = [], []
    if strategy == "ovr":
        for k, cls_label in enumerate(classes):
            yk = np.where(y == cls_label, 1, -1).astype(np.int32)
            model, res = trainer(x, yk, config, backend=backend,
                                 num_devices=num_devices)
            if verbose:
                print(f"[ovr {k + 1}/{len(classes)}] class={cls_label} "
                      f"iters={res.iterations} n_sv={res.n_sv}")
            models.append(model)
            results.append(res)
    elif strategy == "ovo":
        for a in range(len(classes)):
            for b in range(a + 1, len(classes)):
                mask = (y == classes[a]) | (y == classes[b])
                xa = x[mask]
                ya = np.where(y[mask] == classes[a], 1, -1).astype(np.int32)
                bucket = 1 << (len(xa) - 1).bit_length()
                model, res = trainer(xa, ya, config, backend=backend,
                                     num_devices=num_devices, pad_to=bucket)
                if verbose:
                    print(f"[ovo {classes[a]} vs {classes[b]}] "
                          f"iters={res.iterations} n_sv={res.n_sv}")
                models.append(model)
                results.append(res)
    else:
        raise ValueError(f"unknown strategy {strategy!r}; use 'ovr' or 'ovo'")
    mc = MulticlassSVM(classes=classes, models=models, strategy=strategy)
    if mc.shared_kernel():
        mc.ensure_compacted(x_train=x)
    return mc, results


def _query_blocks(q, blk: int, d: int, dev):
    """The queries in blocks of `blk` rows on `dev`, each padded to a
    power of two rows (as the JAX package buckets them): (block, rows)."""
    for s in range(0, q.shape[0], blk):
        qb = q[s:s + blk]
        nb = qb.shape[0]
        nb_pad = 1 << max(4, (nb - 1).bit_length())
        if nb_pad != nb:
            qp = np.zeros((nb_pad, d), np.float32)
            qp[:nb] = qb
            qb = qp
        yield torch.as_tensor(qb, device=dev), nb


def _block_rows(block: int, per_row: int) -> int:
    """Query rows a block may take so its largest tile stays near 1 GB,
    rounded down to a power of two."""
    blk = max(128, min(block, (1 << 28) // max(1, per_row)))
    return 1 << (blk.bit_length() - 1)


def _compacted_decision(ens: CompactedEnsemble, q, block: int,
                        dev) -> np.ndarray:
    """Every submodel's decision values through the compacted path,
    (n, k) float32: ONE kernel product against the SV union, then each
    submodel's kernel values gathered back into its own SV order and
    contracted with its coefficients."""
    k, m_pad = ens.idx.shape
    s_union = int(ens.sv_union.shape[0])
    d = ens.sv_union.shape[1]
    q = np.asarray(q, np.float32)
    if s_union == 0:
        return np.broadcast_to(-ens.b, (q.shape[0], k)).astype(np.float32)
    sv, coef_pad, idx, b = ens.device_arrays(dev)
    ssq = (sv * sv).sum(dim=1)
    out = []
    for qb, nb in _query_blocks(q, _block_rows(block, k * m_pad + s_union),
                                d, dev):
        qsq = (qb * qb).sum(dim=1)
        kv = kernel_from_dots(qb @ sv.t(), ssq, qsq, ens.kernel)  # (n, S)
        kg = kv[:, idx]  # (n, k, m_pad)
        dec = torch.einsum("nkm,km->nk", kg, coef_pad) - b
        out.append(dec[:nb].cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0, k), np.float32)


def _stacked_decision(models, q, block: int, dev) -> np.ndarray:
    """Every submodel's decision values through the stacked path, (n, k)
    float32: the SVs padded to one power-of-two height (zero
    coefficients add nothing) and evaluated as one batched product per
    query block."""
    kp = models[0].kernel
    d = models[0].sv_x.shape[1]
    m_pad = _sv_bucket(models)
    k = len(models)
    sv = np.zeros((k, m_pad, d), np.float32)
    coef = np.zeros((k, m_pad), np.float32)
    b = np.zeros((k,), np.float32)
    for i, mm in enumerate(models):
        ns = mm.sv_x.shape[0]
        sv[i, :ns] = mm.sv_x
        coef[i, :ns] = mm.dual_coef
        b[i] = mm.b
    sv, coef, b = (torch.as_tensor(a, device=dev) for a in (sv, coef, b))
    ssq = (sv * sv).sum(dim=2)[:, None, :]  # (k, 1, m_pad)
    out = []
    q = np.asarray(q, np.float32)
    for qb, nb in _query_blocks(q, _block_rows(block, k * m_pad), d, dev):
        qsq = (qb * qb).sum(dim=1)
        kv = kernel_from_dots(torch.matmul(qb, sv.transpose(1, 2)), ssq,
                              qsq, kp)  # (k, n, m_pad)
        dec = torch.bmm(kv, coef[:, :, None])[:, :, 0] - b[:, None]
        out.append(dec.t()[:nb].cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0, k), np.float32)


def decision_matrix(m: MulticlassSVM, q, block: int = 8192,
                    path: str = "auto", precision: str = "auto",
                    device=None) -> np.ndarray:
    """Raw decision values on `device` (None: the CUDA card), one column
    per submodel: (n, k) per-class scores for OvR, (n, k(k-1)/2)
    pairwise columns (a < b order) for OvO.

    path: "auto" takes the compacted form for a shared kernel and the
    per-model loop otherwise; "compacted" / "stacked" force those forms
    (raising on mixed kernels); "per_model" the loop. precision "auto"
    evaluates in float64 on the host the columns whose float32 noise
    estimate (predict.decision_risk_columns) reaches AUTO_F64_RISK;
    "float32" keeps every column on the device."""
    dev = resolve_device(device)
    if precision not in ("auto", "float32"):
        raise ValueError("precision must be 'auto' or 'float32'")
    q = np.asarray(q, np.float32)
    shared = m.shared_kernel()
    if path == "auto":
        path = "compacted" if shared else "per_model"
    if path in ("compacted", "stacked") and not shared:
        raise ValueError(
            f"path={path!r} needs all submodels on one shared kernel; "
            "this ensemble mixes kernels (use path='per_model')")
    if path == "compacted":
        ens = m.ensure_compacted()
        dec = _compacted_decision(ens, q, block, dev)
        risky = (np.nonzero(decision_risk_columns(ens.coef)
                            >= AUTO_F64_RISK)[0]
                 if precision == "auto" else [])
    elif path == "stacked":
        dec = _stacked_decision(m.models, q, block, dev)
        risky = [j for j, mm in enumerate(m.models)
                 if precision == "auto"
                 and decision_risk_columns(mm.dual_coef[:, None])[0]
                 >= AUTO_F64_RISK]
    elif path == "per_model":
        prec = "auto" if precision == "auto" else "float32"
        return np.stack([decision_function(mm, q, block, precision=prec,
                                           device=dev)
                         for mm in m.models], axis=1)
    else:
        raise ValueError(
            f"unknown path {path!r}; use 'auto', 'compacted', 'stacked' "
            "or 'per_model'")
    if len(risky):
        dec = dec.astype(np.float64)
        for j in risky:
            dec[:, j] = decision_function(m.models[j], q, block,
                                          precision="float64", device=dev)
    return dec


def ovo_vote_fold(dec, k: int) -> np.ndarray:
    """(n, k(k-1)/2) pairwise decision columns (a < b order) -> (n, k)
    vote scores: pairwise votes plus a sub-unit confidence term, so ties
    rank by margin while the vote order is never overturned."""
    dec = np.asarray(dec, np.float64)
    votes = np.zeros((dec.shape[0], k), np.float64)
    conf = np.zeros((dec.shape[0], k), np.float64)
    idx = 0
    for a in range(k):
        for b in range(a + 1, k):
            d = dec[:, idx]
            win_a = d >= 0
            votes[:, a] += win_a
            votes[:, b] += ~win_a
            conf[:, a] += d
            conf[:, b] -= d
            idx += 1
    return votes + conf / (3.0 * (np.abs(conf) + 1.0))


def vote_matrix(m: MulticlassSVM, q, block: int = 8192, path: str = "auto",
                device=None) -> np.ndarray:
    """(n, k) per-class scores: OvO votes (ovo_vote_fold), or the OvR
    decision matrix."""
    dec = decision_matrix(m, q, block, path=path, device=device)
    if m.strategy != "ovo":
        return dec
    return ovo_vote_fold(dec, len(m.classes))


def predict_multiclass(m: MulticlassSVM, q, block: int = 8192,
                       device=None) -> np.ndarray:
    """Predicted class labels of a batch of query points."""
    return m.classes[np.argmax(vote_matrix(m, q, block, device=device),
                               axis=1)]


def accuracy_multiclass(m: MulticlassSVM, q, y, block: int = 8192,
                        device=None) -> float:
    return float(np.mean(predict_multiclass(m, q, block, device=device)
                         == np.asarray(y)))
