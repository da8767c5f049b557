"""Typed training configuration (counterpart of dpsvm_tpu/config.py).

Every field of the JAX package's ``SVMConfig`` is carried, with the same
name, default and validation, so a config written by either package (a
checkpoint carries its config as JSON) reads the same in the other.
Knobs whose engines are not ported yet stay settable, but
``check_ported`` (called by every entry point and by the checkpoint
reader) refuses them with ``NotImplementedError`` naming the ROADMAP
item that ports them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

KERNELS = ("rbf", "linear", "poly", "sigmoid", "precomputed")


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """The JAX package's observability knobs (its dpsvm_tpu/obs run logs,
    metrics and trace spans), carried so configs load. The port has no
    obs layer yet: anything but the default is refused (ROADMAP queue A
    item 11)."""

    enabled: bool = False
    trace_dir: Optional[str] = None
    runlog_dir: Optional[str] = None

    def replace(self, **kw) -> "ObsConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class SVMConfig:
    """Hyper-parameters and engine knobs for SMO training."""

    c: float = 1.0
    gamma: Optional[float] = None
    epsilon: float = 1e-3
    max_iter: int = 150_000
    # Per-pair engines: lines of the LRU cache of dot rows (0 = off).
    cache_lines: int = 0

    kernel: str = "rbf"
    degree: int = 3
    coef0: float = 0.0

    # Per-class C multipliers (LibSVM -w1 / -w-1).
    weight_pos: float = 1.0
    weight_neg: float = 1.0

    selection: str = "mvp"
    engine: str = "xla"
    working_set_size: int = 128
    inner_iters: int = 0
    pair_batch: int = 1

    # Fused block-round engines (solver/block.py): True runs the engine,
    # None (auto) and False the plain one. No H100 gate decides auto yet.
    fused_fold: Optional[bool] = None
    fused_round: Optional[bool] = None
    pipeline_rounds: Optional[bool] = None
    # Mesh block engine (parallel/dist_block.py). local_working_sets:
    # None = auto (off: no H100 measurement decides it yet), 1 = one
    # global working set a round, >= 2 = every shard selects and solves
    # a working set from its own rows, reconciled every sync_rounds local
    # rounds. ring_exchange: the candidate exchange (global runner) and
    # the sync (shard-local runner) through the ring kernels of
    # ops/ring.py; None = auto (off), bit-identical either way.
    local_working_sets: Optional[int] = None
    sync_rounds: int = 1
    ring_exchange: Optional[bool] = None
    # Multiclass fleet batching (solver/fleet.py): submodels trained per
    # fleet of stacked per-pair problems (1 = sequential solves).
    fleet_size: int = 16
    # Hold the (n, n) float32 Gram on the device (engine="xla" or
    # "block"; kernel rows become row gathers). None = auto (engine="xla"
    # only: n >= 8192 and it fits 70% of the card's memory; never on the
    # CPU).
    gram_resident: Optional[bool] = None
    # Store X in bfloat16 only where the per-problem perturbation gate
    # (ops/kernels.py resolve_bf16_gram) accepts; a refusal stays float32
    # and says so in stats["bf16_gram"] and a warning.
    bf16_gram: bool = False
    # The active-set engine (solver/block.py run_chunk_block_active, and
    # the mesh's active runner): cycles of reconcile_rounds rounds on the
    # active_set_size most-violating rows; with ooc, the size of the
    # shrunken tile stream's active view.
    active_set_size: int = 0
    reconcile_rounds: int = 8
    # Out-of-core training (solver/ooc.py): X stays on the host and each
    # round's fold streams over (ooc_tile_rows, d) tiles through two
    # pinned buffers; ooc_cache_lines > 0 keeps an (L, n) cache of dot
    # rows on the device; ooc_shrink streams only the tiles of an active
    # view (None = auto: off, no H100 gate yet; True / False force it).
    ooc: bool = False
    ooc_tile_rows: int = 8192
    ooc_cache_lines: int = 0
    ooc_shrink: Optional[bool] = None

    # Kahan-compensated gradient carry (solver/smo.py kahan_add).
    compensated: bool = False
    # > 0: solve in legs of at most this many pair updates, the gradient
    # recomputed exactly in float64 on the host between legs, and
    # convergence judged on the reconstructed gap (solver/reconstruct.py).
    reconstruct_every: int = 0
    # Matmul precision of the solver's cuBLAS products (resolve_precision
    # and device.precision_ctx): None = auto, "default" / "highest" =
    # full float32, "high" = TF32. The hand-written kernels keep their own
    # precision.
    matmul_precision: Optional[str] = None
    # Run exactly max_iter pair updates; `converged` is still reported at
    # the real epsilon.
    budget_mode: bool = False

    # Retries after a transient device fault (the JAX package's
    # run_with_fault_retry). Carried so configs load; the port retries
    # nothing (ROADMAP queue A item 11).
    retry_faults: int = 2

    tau: float = 1e-12  # eta clamp
    # Check f and alpha for non-finite values at every chunk boundary.
    check_numerics: bool = False
    dtype: str = "float32"  # storage dtype for X ("float32" | "bfloat16")
    # Pair updates per observed chunk (per-pair engines); the block
    # engines run max(1, chunk_iters // inner) rounds a chunk. A solve
    # that nothing observes runs as one chunk.
    chunk_iters: int = 2048
    checkpoint_every: int = 0  # pair updates between checkpoints; 0 = off
    # Rotating checkpoint generations kept (path, path.1, ...).
    checkpoint_keep: int = 1
    verbose: bool = False
    obs: ObsConfig = ObsConfig()

    def c_bounds(self) -> tuple:
        """(c_pos, c_neg): per-class box upper bounds."""
        return (self.c * self.weight_pos, self.c * self.weight_neg)

    def resolve_gamma(self, num_features: int) -> float:
        """Default gamma = 1/d computed in float."""
        if self.gamma is not None:
            return float(self.gamma)
        return 1.0 / float(num_features)

    def __post_init__(self):
        if isinstance(self.obs, dict):  # a config read back from JSON
            object.__setattr__(self, "obs", ObsConfig(**self.obs))
        if self.kernel not in KERNELS:
            raise ValueError(
                f"unknown kernel {self.kernel!r}; expected one of {KERNELS}")
        if self.c <= 0:
            raise ValueError("c must be > 0")
        if self.epsilon <= 0:
            raise ValueError("epsilon must be > 0")
        if self.cache_lines < 0:
            raise ValueError("cache_lines must be >= 0")
        if self.weight_pos <= 0 or self.weight_neg <= 0:
            raise ValueError("class weights must be > 0")
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError("dtype must be 'float32' or 'bfloat16'")
        if self.selection not in ("mvp", "second_order", "nu"):
            raise ValueError(
                "selection must be 'mvp' or 'second_order' (selection='nu' "
                "is internal to the nu trainers)")
        if self.engine not in ("xla", "pallas", "block"):
            raise ValueError("engine must be 'xla', 'pallas' or 'block'")
        if self.working_set_size < 2:
            raise ValueError("working_set_size must be >= 2")
        if self.inner_iters < 0:
            raise ValueError("inner_iters must be >= 0 (0 = 2 * working_set_size)")
        if self.pair_batch not in (1, 2, 4, 8):
            raise ValueError("pair_batch must be 1, 2, 4 or 8")
        if self.active_set_size < 0:
            raise ValueError("active_set_size must be >= 0 (0 = shrinking off)")
        if self.max_iter > 2 ** 31 - 1:
            raise ValueError("max_iter must fit int32")
        self._check_pair_knobs()
        self._check_round_knobs()
        self._check_mesh_knobs()
        self._check_state_knobs()

    def _check_pair_knobs(self) -> None:
        """The JAX package's validation of the per-pair engines' knobs
        (dpsvm_tpu/config.py), same conditions and key phrases."""
        clashes = (
            (self.kernel == "precomputed" and self.engine == "pallas",
             "kernel='precomputed' is not implemented for the fused "
             "pallas per-pair engine; use engine='xla' or 'block'"),
            (self.kernel == "precomputed" and self.cache_lines > 0,
             "kernel='precomputed' has nothing to cache (rows are "
             "gathers, not matvecs); set cache_lines=0"),
            (self.kernel == "precomputed" and self.active_set_size > 0,
             "kernel='precomputed' does not compose with active-set "
             "shrinking (the active view re-indexes rows but the Gram "
             "block gather needs global column ids); set "
             "active_set_size=0"),
            (self.engine == "pallas" and self.selection != "mvp",
             "engine='pallas' supports selection='mvp' only (use "
             "engine='xla' or engine='block')"),
            (self.pair_batch > 1 and self.selection != "mvp",
             "pair_batch > 1 is an mvp-selection feature"),
            (self.pair_batch > 1 and self.engine == "pallas",
             "pair_batch > 1 is not implemented for the fused pallas "
             "per-pair engine (use engine='xla' or 'block')"),
            (self.pair_batch > 4 and self.engine == "block",
             "the block subproblem implements pair_batch up to 4; "
             "pair_batch=8 is the per-pair micro-batch executor only "
             "(engine='xla')"),
            (self.compensated and self.engine == "pallas",
             "compensated gradient carry is implemented for the xla and "
             "block engines; use engine='xla' or 'block'"),
            (bool(self.gram_resident) and self.engine == "pallas",
             "gram_resident is not implemented for the fused pallas "
             "per-pair engine; use engine='xla' or 'block'"),
            (bool(self.gram_resident) and self.kernel == "precomputed",
             "kernel='precomputed' already IS a resident Gram; leave "
             "gram_resident unset"),
        )
        for bad, what in clashes:
            if bad:
                raise ValueError(what)

    def _check_round_knobs(self) -> None:
        """The JAX package's validation of pipeline_rounds / fused_round
        (dpsvm_tpu/config.py), same conditions and key phrases."""
        if self.pipeline_rounds and self.engine != "block":
            raise ValueError("pipeline_rounds is a block-engine knob; use "
                             "engine='block'")
        if self.pipeline_rounds and self.active_set_size:
            raise ValueError("pipeline_rounds does not compose with "
                             "active_set_size — use one or the other")
        if self.pipeline_rounds and self.selection == "nu":
            raise ValueError("pipeline_rounds supports selection in "
                             "{'mvp', 'second_order'}")
        if not self.fused_round:
            return
        clashes = (
            (self.engine != "block",
             "fused_round is a block-engine knob; use engine='block'"),
            (self.kernel == "precomputed",
             "fused_round supports feature kernels only"),
            (bool(self.gram_resident),
             "fused_round does not compose with gram_resident=True"),
            (bool(self.pipeline_rounds),
             "fused_round does not compose with pipeline_rounds=True — "
             "use one or the other"),
            (self.active_set_size > 0,
             "fused_round does not compose with active_set_size — use "
             "one or the other"),
            (self.ooc,
             "fused_round does not compose with ooc — use one or the "
             "other"),
        )
        for bad, what in clashes:
            if bad:
                raise ValueError(what)

    def _check_mesh_knobs(self) -> None:
        """The JAX package's validation of local_working_sets /
        sync_rounds / ring_exchange (dpsvm_tpu/config.py), same conditions
        and key phrases."""
        lws = self.local_working_sets
        if lws is not None and lws < 1:
            raise ValueError(
                "local_working_sets must be None (auto), 1 (global working "
                "set) or >= 2 (shard-parallel working sets)")
        clashes = []
        if lws is not None and lws >= 2:
            clashes += [
                (self.engine != "block",
                 "local_working_sets >= 2 is a mesh block-engine knob; use "
                 "engine='block'"),
                (self.kernel == "precomputed",
                 "local_working_sets >= 2 supports feature kernels only"),
                (self.active_set_size > 0,
                 "local_working_sets >= 2 does not compose with "
                 "active_set_size — use one or the other"),
                (bool(self.pipeline_rounds),
                 "local_working_sets >= 2 does not compose with "
                 "pipeline_rounds=True — use one or the other"),
                (self.budget_mode,
                 "local_working_sets >= 2 does not compose with "
                 "budget_mode: P shards spend the pair budget concurrently, "
                 "so the exact-max_iter contract cannot hold — use the "
                 "global working set there"),
            ]
        if self.ring_exchange:
            clashes += [
                (self.engine != "block",
                 "ring_exchange is a mesh block-engine knob; use "
                 "engine='block'"),
                (self.kernel == "precomputed",
                 "ring_exchange supports feature kernels only"),
                (self.ooc, "ring_exchange does not compose with ooc"),
                (self.active_set_size > 0,
                 "ring_exchange does not compose with active_set_size — use "
                 "one or the other"),
                (bool(self.fused_fold),
                 "ring_exchange does not compose with fused_fold=True — use "
                 "one or the other"),
            ]
        for bad, what in clashes:
            if bad:
                raise ValueError(what)
        if self.sync_rounds < 1:
            raise ValueError("sync_rounds must be >= 1")
        if self.sync_rounds > 1 and (lws is None or lws < 2):
            raise ValueError(
                "sync_rounds > 1 amortizes the shard-local engine's sync "
                "collectives; it needs local_working_sets >= 2")

    def _check_state_knobs(self) -> None:
        """The JAX package's validation of the numerics, state and
        not-ported knobs (dpsvm_tpu/config.py), same conditions and key
        phrases."""
        clashes = (
            (self.fleet_size < 1 or self.fleet_size > 64
             or self.fleet_size & (self.fleet_size - 1),
             "fleet_size must be a power of two in [1, 64]"),
            (self.active_set_size > 0 and self.engine != "block",
             "active_set_size (shrinking) is a block-engine knob"),
            (self.reconcile_rounds < 1, "reconcile_rounds must be >= 1"),
            (self.reconstruct_every < 0,
             "reconstruct_every must be >= 0 (0 = off)"),
            (bool(self.reconstruct_every) and self.budget_mode,
             "budget_mode runs exactly max_iter pairs in one dispatch "
             "sequence; reconstruction legs re-judge convergence and "
             "would break the pinned budget — use one or the other"),
            (bool(self.gram_resident) and self.active_set_size > 0,
             "gram_resident does not compose with active-set shrinking"),
            (self.bf16_gram and self.kernel == "precomputed",
             "bf16_gram supports feature kernels only"),
            (self.bf16_gram and self.dtype == "bfloat16",
             "dtype='bfloat16' already stores X in bfloat16 (ungated, "
             "warning-only); bf16_gram is the perturbation-gated variant "
             "— use one or the other"),
            (self.bf16_gram and self.ooc,
             "bf16_gram does not compose with ooc"),
            (self.ooc_shrink is not None and not self.ooc,
             "ooc_shrink gates the ooc shrunken tile stream; set ooc=True"),
            (self.ooc_tile_rows < 8, "ooc_tile_rows must be >= 8"),
            (self.ooc_cache_lines < 0,
             "ooc_cache_lines must be >= 0 (0 = off)"),
            (self.ooc_cache_lines > 0 and not self.ooc,
             "ooc_cache_lines is the ooc block cache's size; set ooc=True"),
            (0 < self.ooc_cache_lines < self.working_set_size,
             "ooc_cache_lines must be >= working_set_size"),
            (self.matmul_precision not in (None, "default", "high",
                                           "highest"),
             "matmul_precision must be None (auto), 'default', 'high' or "
             "'highest'"),
            (self.retry_faults < 0,
             "retry_faults must be >= 0 (0 = no retry)"),
            (not 1 <= self.checkpoint_keep <= 99,
             "checkpoint_keep must be in [1, 99]"),
            (self.chunk_iters < 1, "chunk_iters must be >= 1"),
        )
        for bad, what in clashes:
            if bad:
                raise ValueError(what)
        if self.ooc:
            ooc_clashes = (
                (self.engine != "block", "ooc (out-of-core streaming) is a "
                 "block-engine path"),
                (self.kernel == "precomputed",
                 "ooc supports feature kernels only"),
                (self.selection == "nu",
                 "ooc supports selection in {'mvp', 'second_order'}"),
                (bool(self.gram_resident),
                 "ooc and gram_resident are opposite regimes"),
                (self.active_set_size > 0 and self.ooc_shrink is False,
                 "active_set_size > 0 with ooc REQUESTS the shrunken tile "
                 "stream"),
                (bool(self.pipeline_rounds),
                 "ooc does not compose with pipeline_rounds"),
                (bool(self.fused_fold),
                 "ooc does not compose with fused_fold=True"),
                (self.local_working_sets is not None,
                 "the ooc round keeps ONE global working set"),
                (bool(self.reconstruct_every),
                 "ooc does not compose with reconstruct_every"),
            )
            for bad, what in ooc_clashes:
                if bad:
                    raise ValueError(what)

    def resolve_precision(self) -> Optional[str]:
        """The matmul precision the solvers apply (the JAX package's
        resolve_precision): None for the platform default; auto (None)
        is "highest" when compensated or reconstruct_every ask for
        accuracy mode. device.precision_ctx maps it to torch."""
        if self.matmul_precision is None:
            return ("highest" if (self.compensated or self.reconstruct_every)
                    else None)
        return (None if self.matmul_precision == "default"
                else self.matmul_precision)

    def check_jax_only(self) -> None:
        """Raise NotImplementedError for a field of the JAX package that
        the port carries only so configs load, set to anything but its
        default; the message names the ROADMAP.md item that ports it."""
        default = SVMConfig()
        jax_only = (
            ("obs", "ROADMAP queue A item 11"),
        )
        for name, item in jax_only:
            if getattr(self, name) != getattr(default, name):
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r} is not ported to "
                    f"dpsvm_tpu_torch yet ({item})")

    def check_ported(self) -> None:
        """Raise NotImplementedError for any knob set to a value whose
        engine the port does not have yet; the message names the
        ROADMAP.md item that ports it."""
        self.check_jax_only()

    def replace(self, **kw) -> "SVMConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Runtime knobs of the serving engines (serve.py PredictServer and
    serving/): every field of the JAX package's ``ServeConfig``, with
    the same name, default and validation.

    buckets: ascending power-of-two query micro-batch sizes; requests
      merge and pad to the smallest that fits, larger batches loop over
      the top one. None = the default ladder (serve.resolve_buckets;
      the port has no device profile to consult).
    union_storage: "f32", "bf16", "int8" or "auto"; None derives it
      from the legacy ``dtype`` ("float32" -> "f32", "bfloat16" ->
      "bf16"). Narrow storage sits behind serve.resolve_union_storage.
    precision: "auto" routes submodel columns whose float32 noise
      estimate reaches predict.AUTO_F64_RISK to the host float64 path;
      "float32" / "float64" force one path for every column.
    num_devices: > 1 row-shards the SV union over a parallel.mesh.Mesh
      and sums the partial decision columns.
    warm_start: run every bucket once on zero queries at construction.
    max_pending: queued rows before enqueue() / submit() force work.
    metrics_port / metrics_host: an OpenMetrics endpoint (obs/export.py;
      None = off, 0 = ephemeral port).
    slo_ms: the latency objective of the SLO-attainment gauges.
    deadline_ms: default per-request deadline of the v2 engine (None =
      none); expired requests are shed with an explicit verdict.
    dispatch_timeout_ms: the v2 engine's dispatch watchdog (None = off).
    journal_path: the registry journal the v2 engine replays at start.
    listen: "HOST:PORT" of the network front door (serving/server.py).
    replicas: engines behind one front door (> 1 needs ``listen``).
    device_floor_us_per_row: an emulated serial device time per padded
      row (a host-bound harness knob; None = off).
    admission_max_rows, admission_retry_ms, conn_read_timeout_ms,
      conn_write_timeout_ms, max_frame_bytes: the front door's admission
      bound, retry hint and per-connection bounds.
    obs: the JAX package's run-log switch, carried so configs read the
      same; anything but the default is refused (check_ported).
    """

    buckets: Optional[tuple] = (16, 64, 256, 1024, 4096)
    dtype: str = "float32"
    union_storage: Optional[str] = None
    precision: str = "auto"
    num_devices: int = 1
    warm_start: bool = True
    max_pending: int = 65536
    metrics_port: Optional[int] = None
    metrics_host: str = "127.0.0.1"
    slo_ms: float = 50.0
    deadline_ms: Optional[float] = None
    dispatch_timeout_ms: Optional[float] = None
    journal_path: Optional[str] = None
    listen: Optional[str] = None
    replicas: int = 1
    device_floor_us_per_row: Optional[float] = None
    admission_max_rows: Optional[int] = None
    admission_retry_ms: float = 50.0
    conn_read_timeout_ms: float = 30000.0
    conn_write_timeout_ms: float = 10000.0
    max_frame_bytes: int = 64 * 1024 * 1024
    obs: ObsConfig = ObsConfig()

    def __post_init__(self):
        if isinstance(self.obs, dict):
            object.__setattr__(self, "obs", ObsConfig(**self.obs))
        if self.buckets is not None:
            if not self.buckets:
                raise ValueError(
                    "buckets must be non-empty (None = the default ladder)")
            bs = tuple(int(b) for b in self.buckets)
            if any(b < 1 or (b & (b - 1)) for b in bs):
                raise ValueError(
                    f"buckets must be powers of two, got {self.buckets!r}")
            if list(bs) != sorted(set(bs)):
                raise ValueError("buckets must be strictly ascending")
            object.__setattr__(self, "buckets", bs)
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError("dtype must be 'float32' or 'bfloat16'")
        if self.union_storage is not None and self.union_storage not in (
                "f32", "bf16", "int8", "auto"):
            raise ValueError(
                "union_storage must be 'f32', 'bf16', 'int8' or 'auto' "
                "(None = derive from the legacy dtype knob)")
        if self.precision not in ("auto", "float32", "float64"):
            raise ValueError(
                "precision must be 'auto', 'float32' or 'float64'")
        if self.num_devices < 1:
            raise ValueError("num_devices must be >= 1")
        if self.buckets is not None \
                and self.max_pending < self.buckets[-1]:
            raise ValueError(
                "max_pending must be at least the largest bucket "
                f"({self.buckets[-1]})")
        if self.buckets is None and self.max_pending < 4096:
            raise ValueError(
                "max_pending must be at least 4096 with buckets=None (the "
                "default ladder's top bucket)")
        if self.metrics_port is not None and not (
                0 <= self.metrics_port <= 65535):
            raise ValueError(
                "metrics_port must be None (no endpoint), 0 (ephemeral) "
                "or a valid TCP port")
        if not self.metrics_host:
            raise ValueError("metrics_host must be a bind address")
        if self.slo_ms <= 0:
            raise ValueError("slo_ms must be > 0")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError("deadline_ms must be > 0 (None = no deadlines)")
        if self.dispatch_timeout_ms is not None \
                and self.dispatch_timeout_ms <= 0:
            raise ValueError(
                "dispatch_timeout_ms must be > 0 (None = no watchdog)")
        if self.journal_path is not None and not self.journal_path:
            raise ValueError(
                "journal_path must be a file path (None = no journal)")
        if self.listen is not None:
            host, sep, port = str(self.listen).rpartition(":")
            if not sep or not host or not port.isdigit() \
                    or not (0 <= int(port) <= 65535):
                raise ValueError(
                    f"listen must be 'HOST:PORT' (port 0 = ephemeral), got "
                    f"{self.listen!r}")
        if self.replicas < 1:
            raise ValueError("replicas must be >= 1")
        if self.replicas > 1 and self.listen is None:
            raise ValueError(
                "replicas > 1 requires listen (the replica fleet scales "
                "the network front door)")
        if self.device_floor_us_per_row is not None \
                and self.device_floor_us_per_row <= 0:
            raise ValueError(
                "device_floor_us_per_row must be > 0 (None = no floor)")
        if self.admission_max_rows is not None:
            if self.admission_max_rows < 1:
                raise ValueError(
                    "admission_max_rows must be >= 1 (None = max_pending)")
            if self.admission_max_rows > self.max_pending:
                raise ValueError(
                    "admission_max_rows must not exceed max_pending "
                    f"({self.max_pending}): admission rejects must trip "
                    "before the blocking in-engine backpressure")
        if self.admission_retry_ms <= 0:
            raise ValueError("admission_retry_ms must be > 0")
        if self.conn_read_timeout_ms <= 0 or self.conn_write_timeout_ms <= 0:
            raise ValueError(
                "conn_read_timeout_ms / conn_write_timeout_ms must be > 0")
        if self.max_frame_bytes < 4096:
            raise ValueError("max_frame_bytes must be >= 4096")

    def listen_addr(self) -> tuple:
        """('host', port) from the validated listen spec."""
        host, _, port = str(self.listen).rpartition(":")
        return host, int(port)

    def effective_union_storage(self) -> str:
        """The REQUESTED union storage: union_storage when set, else the
        legacy dtype's. What stages is decided per model by
        serve.resolve_union_storage."""
        if self.union_storage is not None:
            return self.union_storage
        return "bf16" if self.dtype == "bfloat16" else "f32"

    def check_ported(self) -> None:
        """Raise NotImplementedError for ``obs`` off its default: the port
        has no run logs or trace sessions yet (ROADMAP queue A item 11).
        Called by every serving entry point."""
        if self.obs != ObsConfig():
            raise NotImplementedError(
                f"obs={self.obs!r} is not ported to dpsvm_tpu_torch yet "
                "(ROADMAP queue A item 11)")

    def replace(self, **kw) -> "ServeConfig":
        return dataclasses.replace(self, **kw)
