"""Persistent serving: compacted multiclass inference under bucketed
micro-batching (counterpart of dpsvm_tpu/serve.py).

``PredictServer`` keeps the compacted SV union of a model
(models/multiclass.py CompactedEnsemble) RESIDENT on the device, runs
each of a small set of power-of-two query buckets once at start-up, and
micro-batches queued requests into the next bucket: a steady request
stream costs one kernel product per merged batch and no upload.

Decision algebra: ``K(Q, sv_union) @ coef - b``, ONE (n, S) kernel
product for all k submodel columns plus an (S, k) coefficient
contraction; dense, so it sums in another order than the model layer's
gathered path (multiclass._compacted_decision), by ~1e-7 relative.

Storage: the union stages at f32, bf16 (bf16 x bf16 products accumulated
in float32, ops/kernels.py mm_f32) or int8 (per-row symmetric scales,
queries quantized per row on the device, int8 x int8 -> int32 products,
ops/kernels.py mm_i8_i32), behind one guard (resolve_union_storage).
Columns whose float32 noise estimate reaches predict.AUTO_F64_RISK are
evaluated exactly on the host in float64 instead, from the unquantized
union.

Devices: every entry point takes ``device=None`` (the CUDA card; without
one it raises) and runs on the CPU when asked (``device="cpu"``).
``ServeConfig.num_devices > 1`` row-shards the union, its scales and its
coefficient rows over a parallel.mesh.Mesh (logical shards of `device`
when one is named, else the first num_devices cards) and sums the
partial decision columns. On CUDA a server owns one stream: queries
cross through pinned host buffers (two per bucket, alternating) and the
result comes back into pinned memory behind a recorded event, so a
dispatch returns before the device finishes and waiting is the event's
synchronize, never a device-wide one. Eager torch builds no executor per
bucket, and no kernel build or graph capture (what obs/compilelog.py
counts) happens on the serving path, so the ``serve_compiles`` counter
is exported and reads 0. With ``config.obs`` on, the server writes a
``serve`` run log (manifest at construction, the snapshot at close()).
"""

from __future__ import annotations

import contextlib
import time
import warnings
import weakref
from typing import Union

import numpy as np
import torch

from dpsvm_tpu_torch.autotune.profile import device_kind_of
from dpsvm_tpu_torch.config import ServeConfig
from dpsvm_tpu_torch.device import resolve_device
from dpsvm_tpu_torch.models.multiclass import (CompactedEnsemble,
                                               MulticlassSVM, compact_models,
                                               ovo_vote_fold)
from dpsvm_tpu_torch.models.svm_model import SVMModel
from dpsvm_tpu_torch.obs import run_obs
from dpsvm_tpu_torch.obs import export as openmetrics
from dpsvm_tpu_torch.obs.metrics import Registry
from dpsvm_tpu_torch.obs.trace import span
from dpsvm_tpu_torch.ops.kernels import (BF16_RISK_THRESHOLD,
                                         dequantize_rows_int8,
                                         kernel_from_dots, mm_f32,
                                         mm_i8_i32, quantize_rows_int8,
                                         storage_perturbation)
from dpsvm_tpu_torch.parallel.mesh import Mesh, make_data_mesh, pad_rows
from dpsvm_tpu_torch.predict import AUTO_F64_RISK, decision_risk_columns
from dpsvm_tpu_torch.solver.reconstruct import gram_matvec_f64

# Per-dispatch kernel-tile budget in f32 elements (~1 GB), the model
# layer's blocking discipline (multiclass._block_rows).
_TILE_BUDGET_ELEMS = 1 << 28

#: The ladder ``buckets=None`` resolves to: the ServeConfig default.
DEFAULT_BUCKETS = (16, 64, 256, 1024, 4096)


def effective_buckets(buckets, s_rows: int) -> tuple:
    """The configured buckets cut so a (bucket, S) kernel tile stays
    under the ~1 GB budget: a large union shrinks its top buckets
    instead of running out of memory in the warm-up."""
    cap = max(1, _TILE_BUDGET_ELEMS // max(1, s_rows))
    cap = 1 << (cap.bit_length() - 1)  # floor to a power of two
    return tuple(b for b in buckets if b <= cap) or (cap,)


def resolve_buckets(config: ServeConfig, device_kind: str = ""):
    """``(ladder, provenance)`` of ``ServeConfig.buckets`` (the JAX
    package's, the solvers' resolve_auto_gate discipline applied to the
    bucket ladder).

    An explicit tuple ALWAYS wins: ``{"source": "config"}``, no profile
    consulted, no auto-apply. ``buckets=None`` consults the device
    profile's ``serve_buckets`` decision for `device_kind` (""
    = the CUDA card's): the ladder starts at the default either way (the
    probe measures whether dispatch cost tracks the bucket on this
    device, not what traffic will arrive), and the provenance carries
    ``auto_apply``, True only on an AUTHORITATIVE pays verdict (a CUDA
    probe; the CPU profile's verdicts are pinned False). With
    ``auto_apply`` the serving engine applies its own occupancy
    suggestion between serving legs
    (serving/dispatch.py maybe_apply_bucket_suggestion) and records what
    it applied in the same provenance record."""
    if config.buckets is not None:
        return tuple(config.buckets), {
            "source": "config",
            "buckets": [int(b) for b in config.buckets]}
    from dpsvm_tpu_torch.autotune.profile import gate_decision

    gd = gate_decision("serve_buckets", device_kind or None)
    if gd is None:
        return DEFAULT_BUCKETS, {
            "source": "default", "buckets": list(DEFAULT_BUCKETS),
            "auto_apply": False,
            "note": "no profile decision for serve_buckets; "
                    "default ladder"}
    return DEFAULT_BUCKETS, {
        "source": "profile", **gd,
        "buckets": list(DEFAULT_BUCKETS),
        "auto_apply": bool(gd["decision"])}


def stage_union_host(sv_f32: np.ndarray, storage: str):
    """Host staging of a union at one RESOLVED storage: ``(sv_store,
    sv_scale, sv_sq)``, the rows as a CPU tensor of the storage dtype,
    the per-row float32 dequantization scales (int8 only, else None)
    and the squared norms of the ROUNDED / dequantized rows (the values
    the dot operands carry), float32 summed by NumPy as the JAX package
    sums them."""
    sv_f32 = np.ascontiguousarray(sv_f32, np.float32)
    if storage == "bf16":
        sv_store = torch.from_numpy(sv_f32).to(torch.bfloat16)
        rounded = sv_store.float().numpy()
        return sv_store, None, (rounded ** 2).sum(1, dtype=np.float32)
    if storage == "int8":
        sv_q, scales = quantize_rows_int8(sv_f32)
        deq = dequantize_rows_int8(sv_q, scales)
        return (torch.from_numpy(sv_q), scales,
                (deq * deq).sum(1, dtype=np.float32))
    if storage != "f32":
        raise ValueError(f"unknown union storage {storage!r}")
    return (torch.from_numpy(sv_f32), None,
            (sv_f32 * sv_f32).sum(1, dtype=np.float32))


def union_nbytes(storage: str, s_rows: int, d: int) -> int:
    """Resident union bytes at a storage: rows plus (int8) the float32
    row scales. The serving_union_bytes gauge's one definition."""
    per_elem = {"f32": 4, "bf16": 2, "int8": 1}[storage]
    return s_rows * d * per_elem + (4 * s_rows if storage == "int8" else 0)


def resolve_union_storage(ens, kp, requested: str, stacklevel: int = 4):
    """The serving storage guard: the precision the union of THIS model
    stages at, given the requested ``ServeConfig`` storage ('f32' |
    'bf16' | 'int8' | 'auto'). The decision perturbation from storage
    rounding is bounded per column by ||coef||_1 * |dK|, so the risk is
    the largest column L1 norm times the sampled p90 kernel
    perturbation (ops/kernels.py storage_perturbation), against
    BF16_RISK_THRESHOLD.

    'f32' is accepted as is; 'bf16' stages bf16 either way and warns when
    the bound refuses; 'int8' refused falls back to the widest narrower
    storage the bound accepts (bf16, else f32) with a warning; 'auto'
    takes the narrowest accepted storage (int8, bf16, f32) silently.
    Precomputed kernels and empty unions resolve to 'f32'. Returns
    ``(effective, entry)``, entry being the JSON-able guard record."""
    if requested not in ("f32", "bf16", "int8", "auto"):
        raise ValueError(f"unknown union storage {requested!r}")
    entry = {"requested": requested, "threshold": BF16_RISK_THRESHOLD}
    if requested == "f32":
        entry.update(effective="f32", risks={"f32": 0.0})
        return "f32", entry
    sv = np.asarray(ens.sv_union, np.float32)
    if kp.kind == "precomputed" or sv.shape[0] == 0:
        entry.update(effective="f32", risks={},
                     note="no feature rows to quantize (precomputed "
                          "kernel or empty union); union stays f32")
        return "f32", entry
    l1 = float(np.abs(ens.coef).sum(axis=0).max())
    risks: dict = {}

    def accepts(storage: str) -> bool:
        risks[storage] = round(l1 * storage_perturbation(sv, kp, storage),
                               6)
        return risks[storage] <= BF16_RISK_THRESHOLD

    if requested == "auto":
        for st in ("int8", "bf16"):
            if accepts(st):
                entry.update(effective=st, risks=risks)
                return st, entry
        entry.update(effective="f32", risks=risks,
                     note="auto storage: int8 and bf16 both exceed the "
                          "perturbation bound; union stays f32")
        return "f32", entry
    if accepts(requested):
        entry.update(effective=requested, risks=risks)
        return requested, entry
    if requested == "int8":
        effective = "bf16" if accepts("bf16") else "f32"
        note = (
            f"union_storage='int8' REFUSED for this model: max-column "
            f"||coef||_1 * p90|dK| = {risks['int8']:.4g} > "
            f"{BF16_RISK_THRESHOLD} — per-row int8 quantization at this "
            f"(coef, kernel, data) risks O(1) decision changes (the "
            f"training bf16 guard's amplification mechanism, "
            f"ops/kernels.py); union stays {effective}")
        entry.update(effective=effective, risks=risks, note=note)
        warnings.warn(note, stacklevel=stacklevel)
        return effective, entry
    note = (
        f"dtype='bfloat16' is likely to perturb decision values for this "
        f"model: max-column ||coef||_1 * p90|dK| = {risks['bf16']:.3f} > "
        f"{BF16_RISK_THRESHOLD} (same amplification mechanism as "
        f"training's bf16 guard, ops/kernels.py). Use dtype='float32' for "
        f"this ensemble.")
    entry.update(effective="bf16", risks=risks, note=note)
    warnings.warn(note, stacklevel=stacklevel)
    return "bf16", entry


# ------------------------------------------------------------ executors

def dense_partial(qb, sv, sv_sq, coef, kp) -> torch.Tensor:
    """K(qb, sv) @ coef for f32 or bf16 union rows, (n, K) float32. The
    queries round through the storage dtype (identity for f32) and the
    rbf norms come from those rounded values on both sides; the dots
    accumulate in float32 (mm_f32)."""
    qc = qb.to(sv.dtype)
    dots = mm_f32(qc, sv.t())
    qf = qc.float()
    return kernel_from_dots(dots, sv_sq, (qf * qf).sum(1), kp) @ coef


def quantize_queries_int8(qb) -> tuple:
    """The per-row symmetric int8 quantization of a query batch on its
    device: ``(q_q int8, t float32)`` with t = max|q| / 127 (1 for a zero
    row) and q_q = clip(round_half_even(q / t), -127, 127), the JAX
    executor's algebra."""
    qf = qb.float()
    amax = qf.abs().amax(dim=1)
    # A tensor divisor: CUDA divides by a Python scalar through its
    # reciprocal, which is not the correctly rounded quotient JAX takes.
    t = amax / torch.full_like(amax, 127.0)
    t = torch.where(t > 0, t, torch.ones_like(t))
    q_q = torch.clamp(torch.round(qf / t[:, None]), -127, 127)
    return q_q.to(torch.int8), t


def int8_partial(qb, sv_q, sv_scale, sv_sq, coef, kp) -> torch.Tensor:
    """K(qb, sv) @ coef for int8 union rows, (n, K) float32: queries
    quantized per row (quantize_queries_int8), the exact int32 dots
    (mm_i8_i32) rescaled as idots * (t (x) s_sv), rbf norms from the
    dequantized values on both sides."""
    q_q, t = quantize_queries_int8(qb)
    idots = mm_i8_i32(q_q, sv_q)
    dots = idots.float() * (t[:, None] * sv_scale[None, :])
    qd = q_q.float() * t[:, None]
    return kernel_from_dots(dots, sv_sq, (qd * qd).sum(1), kp) @ coef


def mesh_decision(mesh: Mesh, qb, shards, b, kp) -> torch.Tensor:
    """The decision over a row-sharded union: each shard's partial
    contraction on its device, summed over the shards in rank order
    (Mesh.psum), minus b. ``shards`` holds per rank (sv, sv_sq, coef)
    or, for int8 rows, (sv_q, sv_scale, sv_sq, coef). Pad rows are zero
    rows with zero coefficient rows (and zero scales), so they add
    exact zeros. The result lies on the first rank's device."""
    parts = []
    for dev, ops in zip(mesh.devices, shards):
        q = qb if qb.device == dev else qb.to(dev)
        parts.append(int8_partial(q, *ops, kp) if len(ops) == 4
                     else dense_partial(q, *ops, kp))
    return mesh.psum(parts)[0] - b


def serve_mesh(num_devices: int, dev: torch.device,
               explicit: bool) -> Mesh:
    """The mesh a union stages on: one shard of `dev`; with num_devices
    > 1, that many logical shards of `dev` when the caller named a
    device, else the first num_devices cards (make_data_mesh)."""
    if num_devices == 1:
        return Mesh([dev])
    if explicit:
        return Mesh([dev] * num_devices)
    return make_data_mesh(num_devices)


def _shard(mesh: Mesh, t: torch.Tensor) -> list:
    """Zero-pad the rows of a CPU tensor to pad_rows(n, P, 8) and cut
    them into P equal shards, shard r on mesh.devices[r]."""
    n = t.shape[0]
    n_pad = pad_rows(n, mesh.size, 8)
    if n_pad != n:
        t = torch.cat([t, t.new_zeros((n_pad - n,) + tuple(t.shape[1:]))])
    n_loc = n_pad // mesh.size
    return [t[r * n_loc:(r + 1) * n_loc].to(dev)
            for r, dev in enumerate(mesh.devices)]


class Pending:
    """One launched bucket: ``wait()`` returns its (bucket, K) float32
    decision rows on the host. On CUDA it blocks on the event recorded
    after the result's copy into pinned memory; on the CPU the rows are
    already there."""

    __slots__ = ("_event", "_rows")

    def __init__(self, rows, event=None):
        self._rows = rows
        self._event = event

    def wait(self) -> np.ndarray:
        if self._event is None:
            return self._rows
        self._event.synchronize()
        return self._rows.numpy().copy()  # the pinned slot is reused


class StagedUnion:
    """The device operands of one SV union with its stacked coefficient
    columns, and the launch of one bucket on them.

    ``stream`` (CUDA only) is the owning server's stream: uploads, the
    decision and the copy back all run on it. Queries are copied into
    one of two pinned (bucket, d) buffers of their bucket, taken in
    turn; a buffer is rewritten only after the event of the batch that
    last used it has completed."""

    def __init__(self, sv_f32, coef, b, kp, storage: str, mesh: Mesh,
                 stream=None):
        self.kp = kp
        self.mesh = mesh
        self.dev = mesh.devices[0]
        self.stream = stream
        self.d = int(sv_f32.shape[1])
        self.k = int(coef.shape[1])
        sv_store, sv_scale, sv_sq = stage_union_host(sv_f32, storage)
        host = [sv_store, torch.from_numpy(sv_sq),
                torch.from_numpy(np.ascontiguousarray(coef, np.float32))]
        if storage == "int8":
            host.insert(1, torch.from_numpy(sv_scale))
        # The int8 GEMM wants the inner dimension a multiple of 8 on
        # CUDA: zero columns (exact for the dots; the query buffers pad
        # with zeros too) are staged here once, not padded per call.
        self.d_store = self.d
        if storage == "int8" and self.dev.type == "cuda" and self.d % 8:
            self.d_store = -(-self.d // 8) * 8
            host[0] = torch.nn.functional.pad(
                host[0], (0, self.d_store - self.d))
        with self._on_stream():
            per_op = [_shard(mesh, t) for t in host]
            self.shards = [tuple(ops[r] for ops in per_op)
                           for r in range(mesh.size)]
            self.b = torch.from_numpy(
                np.ascontiguousarray(b, np.float32)).to(self.dev)
        self._slots: dict = {}  # bucket -> [next, [(q_pin, out_pin, event)] * 2]

    def _on_stream(self):
        if self.stream is None:
            return torch.no_grad()
        return _stream_scope(self.dev, self.stream)

    def _decide(self, q):
        return mesh_decision(self.mesh, q, self.shards, self.b, self.kp)

    def launch(self, qb: np.ndarray) -> Pending:
        """Queue the decision of one (bucket, d) float32 query batch and
        return without waiting for it."""
        bucket = qb.shape[0]
        if self.stream is None:
            with torch.no_grad():
                out = self._decide(torch.from_numpy(qb).to(self.dev))
            return Pending(out.cpu().numpy())
        ring = self._slots.get(bucket)
        if ring is None:
            ring = self._slots[bucket] = [0, [
                (torch.zeros((bucket, self.d_store), pin_memory=True),
                 torch.empty((bucket, self.k), pin_memory=True), None)
                for _ in range(2)]]
        i = ring[0]
        ring[0] ^= 1
        q_pin, out_pin, event = ring[1][i]
        if event is not None:
            event.synchronize()  # its last batch has left the buffers
        q_pin[:, :self.d].copy_(torch.from_numpy(qb))
        with self._on_stream():
            out = self._decide(q_pin.to(self.dev, non_blocking=True))
            out_pin.copy_(out, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        ring[1][i] = (q_pin, out_pin, event)
        return Pending(out_pin, event)


@contextlib.contextmanager
def _stream_scope(dev, stream):
    """Run on `stream` of `dev` with autograd off."""
    with torch.cuda.device(dev), torch.cuda.stream(stream), torch.no_grad():
        yield


def new_stream(dev: torch.device):
    """The stream a server or engine owns: a new CUDA stream on `dev`,
    None on the CPU."""
    return torch.cuda.Stream(device=dev) if dev.type == "cuda" else None


class PredictServer:
    """Persistent multiclass / binary prediction server.

    ``enqueue(q) -> ticket`` queues query rows; ``flush()`` merges what
    is queued, pads it to the smallest bucket that fits, runs ONE
    dispatch per bucket batch and returns ``{ticket: decision rows}``.
    ``decision(q)`` / ``predict(q)`` are the synchronous conveniences.
    All share the operands staged at construction, on `device` (None:
    the CUDA card)."""

    def __init__(self, model: Union[MulticlassSVM, SVMModel],
                 config: ServeConfig = ServeConfig(), device=None):
        config.check_ported()
        self.config = config
        self.device = resolve_device(device)
        if isinstance(model, MulticlassSVM):
            ens = model.ensure_compacted()
            if ens is None:
                raise ValueError(
                    "PredictServer needs submodels sharing one kernel "
                    "(mixed-kernel ensembles have no SV union to share); "
                    "serve the submodels individually")
            self.classes = np.asarray(model.classes)
            self.strategy = model.strategy
        elif isinstance(model, SVMModel):
            ens = compact_models([model])
            self.classes = None
            self.strategy = "binary"
        else:
            raise TypeError(
                f"cannot serve a {type(model).__name__}; expected "
                "MulticlassSVM or SVMModel")
        self.ens: CompactedEnsemble = ens
        self.kp = ens.kernel
        self.d = int(ens.sv_union.shape[1])
        self.k = ens.n_models

        # float64 risk routing, per submodel column.
        self.risks = decision_risk_columns(ens.coef)
        if config.precision == "auto":
            self.f64_cols = np.nonzero(self.risks >= AUTO_F64_RISK)[0]
        elif config.precision == "float64":
            self.f64_cols = np.arange(self.k)
        else:
            self.f64_cols = np.zeros((0,), np.int64)
        self._all_f64 = len(self.f64_cols) == self.k

        s_rows = int(self.ens.sv_union.shape[0])
        ladder, self.bucket_provenance = resolve_buckets(
            config, device_kind_of(self.device))
        self.buckets = effective_buckets(ladder, s_rows)
        self.mesh = serve_mesh(config.num_devices, self.device,
                               device is not None)
        self.stream = new_stream(self.device)
        self._stage()

        # Always-on instruments: bounded-window histograms, one
        # percentile definition shared by offered_load_sweep, `cli serve
        # --server-bench` and /metrics.
        self.metrics = Registry()
        self.request_seconds = self.metrics.histogram(
            "serve.request_seconds")
        # Executors built while serving: none in eager torch (reads 0).
        self.compiles = self.metrics.counter("serve.compiles_total")
        self.stats = {
            "requests": 0, "rows": 0, "dispatches": 0, "padded_rows": 0,
            "buckets": self.buckets,
            "bucket_counts": {b: 0 for b in self.buckets},
            "bucket_seconds": {
                b: self.metrics.histogram(f"serve.bucket_seconds.{b}")
                for b in self.buckets},
            "warm_seconds": {}, "f64_columns": len(self.f64_cols),
            "union_storage": self.union_storage,
            "storage_guard": self.storage_guard,
            "bucket_provenance": self.bucket_provenance,
        }
        # The run log (NULL_OBS unless config.obs / DPSVM_OBS).
        self._obs = run_obs("serve", config, device=self.device,
                            meta={"k": self.k, "d": self.d,
                                  "n_union": int(self.ens.n_union),
                                  "strategy": self.strategy,
                                  "buckets": list(self.buckets),
                                  "f64_columns": len(self.f64_cols),
                                  "union_storage": self.union_storage})
        self._pending: list = []  # (ticket, (n, d) rows)
        self._pending_rows = 0
        self._done: dict = {}
        self._next_ticket = 0
        self._closing = False
        if config.warm_start:
            self.warm()
        # The /metrics endpoint starts last, so a scrape never sees a
        # half-built server; its callback holds the server weakly (the
        # daemon thread must not pin an un-closed server's operands).
        self.exporter = None
        if config.metrics_port is not None:
            ref = weakref.ref(self)

            def _render(_ref=ref):
                srv = _ref()
                if srv is None or srv._closing:
                    return "# EOF\n"
                return srv.render_openmetrics()

            self.exporter = openmetrics.MetricsExporter(
                _render, port=config.metrics_port,
                host=config.metrics_host)

    # ------------------------------------------------------------ staging
    def _stage(self) -> None:
        self.union_storage, self.storage_guard = resolve_union_storage(
            self.ens, self.kp, self.config.effective_union_storage(),
            stacklevel=5)
        self._union = None  # decision is exactly -b, or all host f64
        if self.ens.n_union == 0 or self._all_f64:
            return
        self._union = StagedUnion(self.ens.sv_union, self.ens.coef,
                                  self.ens.b, self.kp, self.union_storage,
                                  self.mesh, self.stream)

    # ------------------------------------------------------------- warmup
    def warm(self) -> dict:
        """Run every bucket once on zero queries (allocations and the
        library's set-up happen before traffic). Returns {bucket:
        seconds}."""
        for bucket in self.buckets:
            t0 = time.perf_counter()
            self._run_bucket(np.zeros((bucket, self.d), np.float32),
                             bucket, warm=True)
            self.stats["warm_seconds"][bucket] = time.perf_counter() - t0
        return dict(self.stats["warm_seconds"])

    # ----------------------------------------------------------- dispatch
    def _bucket_for(self, n: int) -> int:
        for bucket in self.buckets:
            if n <= bucket:
                return bucket
        return self.buckets[-1]

    def _run_bucket(self, qb: np.ndarray, bucket: int,
                    warm: bool = False) -> np.ndarray:
        """One dispatch of a (bucket, d) batch -> (bucket, k) float32
        decision rows (the f64 columns are overwritten by the caller)."""
        if self._union is None:
            return np.broadcast_to(
                -self.ens.b, (qb.shape[0], self.k)).astype(np.float32)
        with span(f"serve/bucket{bucket}"):
            t0 = time.perf_counter()
            out = self._union.launch(qb).wait()
            dt = time.perf_counter() - t0
        if not warm:
            self.stats["bucket_seconds"][bucket].observe(dt)
        return out

    def decision(self, q) -> np.ndarray:
        """(n, k) decision columns of a query batch, synchronously. The
        device columns see the queries as float32; the risk-routed
        float64 columns see the caller's dtype unquantized."""
        q_in = np.asarray(q)
        if q_in.ndim != 2 or q_in.shape[1] != self.d:
            raise ValueError(
                f"queries must be (n, {self.d}); got {q_in.shape}")
        q32 = np.asarray(q_in, np.float32)
        n = q32.shape[0]
        out = np.empty((n, self.k), np.float32)
        top = self.buckets[-1]
        s = 0
        while s < n:
            take = min(n - s, top)
            bucket = self._bucket_for(take)
            qb = q32[s:s + take]
            if take != bucket or not qb.flags.c_contiguous:
                qp = np.zeros((bucket, self.d), np.float32)
                qp[:take] = qb
                qb = qp
            out[s:s + take] = self._run_bucket(qb, bucket)[:take]
            self.stats["dispatches"] += 1
            self.stats["bucket_counts"][bucket] += 1
            self.stats["padded_rows"] += bucket - take
            s += take
        self.stats["rows"] += n
        if len(self.f64_cols):
            self._overwrite_f64(q_in, out)
        return out

    def _overwrite_f64(self, q: np.ndarray, out: np.ndarray) -> None:
        """The risk-routed columns, exactly in float64 on the host
        (solver/reconstruct.py gram_matvec_f64)."""
        q64 = np.asarray(q, np.float64)
        for j in self.f64_cols:
            out[:, j] = (gram_matvec_f64(self.ens.sv_union,
                                         self.ens.coef[:, j], self.kp,
                                         queries=q64)
                         - float(self.ens.b[j])).astype(np.float32)

    # ------------------------------------------------------------- labels
    def labels(self, dec: np.ndarray) -> np.ndarray:
        """Decision columns -> labels: binary sign, OvR argmax, OvO vote
        fold."""
        if self.strategy == "binary":
            return np.where(dec[:, 0] >= 0, 1, -1).astype(np.int32)
        if self.strategy == "ovr":
            return self.classes[np.argmax(dec, axis=1)]
        return self.classes[np.argmax(
            ovo_vote_fold(dec, len(self.classes)), axis=1)]

    def predict(self, q) -> np.ndarray:
        return self.labels(self.decision(q))

    # -------------------------------------------------- micro-batch queue
    def enqueue(self, q) -> int:
        """Queue a request's rows; returns its ticket. Requests merge
        into shared bucket dispatches at the next flush() (forced early
        when max_pending rows are queued); the merged batch keeps the
        widest queued dtype for the float64 columns."""
        q = np.asarray(q)
        if q.ndim != 2 or q.shape[1] != self.d:
            raise ValueError(
                f"queries must be (n, {self.d}); got {q.shape}")
        ticket = self._next_ticket
        self._next_ticket += 1
        self._pending.append((ticket, q))
        self._pending_rows += q.shape[0]
        self.stats["requests"] += 1
        if self._pending_rows >= self.config.max_pending:
            self._done.update(self._flush_pending())
        return ticket

    def _flush_pending(self) -> dict:
        if not self._pending:
            return {}
        tickets = [t for t, _ in self._pending]
        sizes = [r.shape[0] for _, r in self._pending]
        merged = np.concatenate([r for _, r in self._pending])
        self._pending.clear()
        self._pending_rows = 0
        dec = self.decision(merged)
        out, s = {}, 0
        for t, n in zip(tickets, sizes):
            out[t] = dec[s:s + n]
            s += n
        return out

    def flush(self) -> dict:
        """Run everything queued and return {ticket: (n_i, k) decision
        rows} of every completed request, forced flushes included."""
        done = self._done
        self._done = {}
        done.update(self._flush_pending())
        return done

    # ------------------------------------------------------- telemetry
    def snapshot(self) -> dict:
        """JSON-able stats: the counters and each histogram's snapshot."""
        out = {k: v for k, v in self.stats.items()
               if k not in ("bucket_seconds", "bucket_counts", "buckets")}
        out["buckets"] = list(self.buckets)
        out["bucket_counts"] = {str(b): c for b, c
                                in self.stats["bucket_counts"].items()}
        out["bucket_seconds"] = {
            str(b): h.snapshot()
            for b, h in self.stats["bucket_seconds"].items() if len(h)}
        out["request_seconds"] = self.request_seconds.snapshot()
        out["compiles"] = self.compiles.value
        return out

    def render_openmetrics(self) -> str:
        """The /metrics exposition (OpenMetrics 1.0): counters, latency
        summaries (the quantiles snapshot() reports), SLO-attainment
        gauges and the compile counter. Host reads only."""
        om = openmetrics
        st = self.stats
        model_lb = {"model": self.model_id}
        slo_s = float(self.config.slo_ms) / 1e3
        slo_lb = {"slo_ms": f"{self.config.slo_ms:g}"}

        def attainment(hist) -> float:
            w = hist.window_values()
            return float(np.mean(w <= slo_s)) if w.size else 1.0

        fams = [
            om.counter("serve_requests", "requests enqueued",
                       st["requests"], model_lb),
            om.counter("serve_rows", "query rows served", st["rows"],
                       model_lb),
            om.counter("serve_dispatches", "device dispatches",
                       st["dispatches"], model_lb),
            om.counter("serve_padded_rows",
                       "bucket pad rows dispatched", st["padded_rows"],
                       model_lb),
            om.counter("serve_compiles",
                       "bucket executors compiled while serving",
                       self.compiles.value, model_lb),
            om.gauge("serve_pending_rows",
                     "rows queued for the next flush",
                     [(model_lb, self._pending_rows)]),
            om.gauge("serve_f64_columns",
                     "decision columns risk-routed to host float64",
                     [(model_lb, len(self.f64_cols))]),
            om.gauge("serve_sv_union_rows",
                     "resident SV-union rows",
                     [(model_lb, int(self.ens.n_union))]),
            om.gauge("serve_union_bytes",
                     "resident SV-union operand bytes at the staged "
                     "storage (rows + int8 dequant scales)",
                     [({**model_lb,
                        "union_storage": self.union_storage},
                       union_nbytes(self.union_storage,
                                    int(self.ens.sv_union.shape[0]),
                                    self.d))]),
        ]
        if len(self.request_seconds):
            fams.append(om.summary(
                "serve_request_seconds",
                "request latency (enqueue->flush), recent-window "
                "quantiles", self.request_seconds, labels=model_lb))
        fams.append(om.gauge(
            "serve_slo_attainment",
            "fraction of the recent request-latency window at or "
            "under the objective (1 = vacuous when empty)",
            [({**model_lb, **slo_lb},
              round(attainment(self.request_seconds), 6))]))
        disp = [("_total", {"bucket": str(b)}, c)
                for b, c in st["bucket_counts"].items()]
        fams.append(om.metric(
            "serve_bucket_dispatches", "counter",
            "device dispatches per query bucket", disp))
        bucket_att = []
        bucket_samples = []
        for b, h in st["bucket_seconds"].items():
            if not len(h):
                continue
            bucket_samples.extend(om.summary_samples(
                h, labels={"bucket": str(b)}))
            bucket_att.append(({"bucket": str(b), **slo_lb},
                               round(attainment(h), 6)))
        if bucket_samples:
            fams.append(om.metric(
                "serve_bucket_seconds", "summary",
                "per-dispatch device latency, recent-window "
                "quantiles", bucket_samples))
        if bucket_att:
            fams.append(om.gauge(
                "serve_bucket_slo_attainment",
                "fraction of the recent per-bucket dispatch window "
                "at or under the objective", bucket_att))
        return om.render(fams)

    @property
    def model_id(self) -> str:
        """The `model` label value on exported metrics."""
        return f"{self.strategy}-{self.k}"

    def close(self) -> None:
        """Stop the /metrics endpoint (first, so a racing scrape sees a
        full exposition, the ``# EOF`` stub or a refusal); the resident
        operands stay usable."""
        self._closing = True
        if self.exporter is not None:
            self.exporter.close()
        self._obs.finish(**self.snapshot())


def offered_load_sweep(server: PredictServer, request_sizes,
                       n_requests: int, group: int = 8,
                       seed: int = 0) -> dict:
    """Drive the server with a stream of requests and report throughput
    and latency percentiles (per request, and per bucket from the
    server's own dispatch timings). `group` requests arrive together
    and share flush dispatches. The percentiles cover only this sweep's
    observations of the server's shared histograms."""
    rng = np.random.default_rng(seed)
    sizes = rng.choice(np.asarray(request_sizes), n_requests)
    req_base = server.request_seconds.count
    bucket_base = {b: h.count
                   for b, h in server.stats["bucket_seconds"].items()}
    rows = 0
    t_start = time.perf_counter()
    for s in range(0, n_requests, group):
        batch_sizes = sizes[s:s + group]
        t0 = time.perf_counter()
        for n in batch_sizes:
            server.enqueue(rng.random((int(n), server.d),
                                      dtype=np.float32))
        server.flush()
        t1 = time.perf_counter()
        for _ in batch_sizes:
            server.request_seconds.observe(t1 - t0)
        rows += int(batch_sizes.sum())
    wall = time.perf_counter() - t_start
    per_bucket = {}
    for bucket, h in server.stats["bucket_seconds"].items():
        new = h.count - bucket_base[bucket]
        if new:
            per_bucket[str(bucket)] = {
                "dispatches": new, **h.percentiles(last=new)}
    return {
        "requests": int(n_requests), "rows": int(rows), "group": group,
        "wall_seconds": round(wall, 4),
        "rows_per_second": round(rows / max(wall, 1e-9)),
        "requests_per_second": round(n_requests / max(wall, 1e-9)),
        "request_latency": server.request_seconds.percentiles(
            last=server.request_seconds.count - req_base),
        "bucket_latency": per_bucket,
        "dispatches": server.stats["dispatches"],
        "padded_rows": server.stats["padded_rows"],
    }
