"""Fact primitives recorded from the eager ops a unit of the hot path
runs (the port's counterpart of dpsvm_tpu/analysis/hlo_facts.py).

The JAX package reads its facts from compiled HLO: static properties of
a lowered program. The port compiles no program, so the facts here are
recorded while a unit RUNS, from three vantage points:

* a ``TorchDispatchMode`` sees every aten op the unit enqueues (views
  and allocations included; each other op is at least one launch on
  the card);
* a ``TorchFunctionMode`` sees the Tensor methods that read to the host
  at the Python level (``.cpu()``, ``.numpy()``, ``.tolist()``,
  ``__array__``, ``.to`` off the device) and the constructors that
  bring host data in (``torch.tensor``, ``as_tensor``, ``asarray``): on
  the CPU ``.cpu()`` changes no device and ``.numpy()`` never reaches
  the dispatcher, so the dispatcher alone would miss them;
* ``sys.monitoring`` hooks on the CODE OBJECTS of the kernel wrappers
  (B1-B8) and of the mesh collectives (``Mesh.all_gather[_many]``,
  ``psum[_many]``, ``pmax``, and ``torch.distributed``'s): a call is
  recorded as one fact, and nothing inside it is recorded op by op. On
  the CPU a wrapper runs its plain version (B1's is a Python loop),
  whose ops the card never runs; hooking the code object counts every
  caller, whatever name it imported the wrapper under.

Fact families (the JAX family each mirrors, key for key where the
meaning carries over):

  collectives  per kind in COLLECTIVE_KINDS: count, sorted per-result
               payload bytes, total bytes (JAX ``collective_facts``).
               A packed ``all_gather_many`` / ``psum_many`` is ONE
               exchange with one payload per list, as XLA's combiner
               makes one op with a tuple result.
  transfers    host_reads (``aten._local_scalar_dense``: ``.item()``,
               ``bool()`` / ``int()`` of a tensor; plus the Python-level
               reads above), host_writes (host data entering the unit),
               implicit_syncs (ops whose output shape depends on device
               data: ``nonzero``, boolean indexing, ``masked_select``,
               ``unique``...; each is a hidden host round trip on the
               card). JAX ``transfer_facts``.
  dots         count, max_result_rank, batched_rank3plus over mm, mv,
               addmm, addmv, bmm, baddbmm, dot (what matmul and einsum
               decompose to), outside the kernel wrappers.
  dtypes       f64_result_ops, f64_present and the bf16 / f64 converts
               (``_to_copy`` or ``copy_`` that change the dtype); int8
               keys only where int8 appears (JAX ``dtype_facts``).
  inplace      donatable (the unit's declared state arguments),
               aliased_outputs (those written in place, or returned as
               they came), missed (the difference): JAX ``donation_facts``' keys for state
               written in place against state allocated anew.
  memory       argument_bytes, output_bytes, temp_bytes (bytes the unit
               allocated that it does not return), alias_bytes (outputs
               that are inputs): byte sums of the recorded tensors, views
               excluded, deterministic on the CPU (JAX ``memory_facts``).
  kernels      calls per wrapper, B1-B8 (JAX ``device_form_facts``).
  ops          aten ops enqueued outside the wrappers and collectives,
               views and allocations excluded: count and by_name.

There is no ``hazards`` family: eager torch has no traced branch. A
Python branch on a device value is a ``_local_scalar_dense``, i.e. a
``transfers.host_reads`` fact.

Every fact is a function of the ops the unit ran, so a unit's facts are
deterministic for fixed inputs, code and torch version. On the card the
same unit gives the same ``kernels``, ``collectives`` and host reads;
``ops``, ``dtypes`` and ``memory`` may differ where the code branches on
the device type (e.g. ``mm_f32``'s bf16 GEMM with a float32 output).
"""

from __future__ import annotations

import sys
import threading
import weakref
from collections import Counter
from typing import Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

#: Collective kinds, the JAX package's names. The port's mesh makes
#: all-gathers and all-reduces (psum, pmax); the other kinds stay 0.
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

#: The eight kernels, by the id the ROADMAP and PERF.md give them.
KERNEL_IDS = ("B1", "B2", "B3", "B4", "B5", "B6", "B7", "B8")

_DOT_OPS = ("mm", "mv", "addmm", "addmv", "bmm", "baddbmm", "dot")
_SYNC_OPS = ("nonzero", "masked_select", "_unique", "_unique2",
             "unique_dim", "unique_consecutive", "repeat_interleave",
             "equal", "allclose")
_ALLOC_OPS = ("empty", "empty_like", "empty_strided")


def kernel_wrappers() -> dict:
    """{kernel id: wrapper function} of the eight kernels."""
    from dpsvm_tpu_torch.ops import fold_select, fused_update, ring, round
    from dpsvm_tpu_torch.ops import subproblem

    return {"B1": subproblem.solve_subproblem,
            "B2": fold_select.fold_select,
            "B3": fold_select.select_rows,
            "B4": round.gather_gram,
            "B5": round.fold_rows_select,
            "B6": fused_update.fused_update_select,
            "B7": ring.ring_gather,
            "B8": ring.ring_fold_window}


def _hooked_kernels() -> dict:
    """{id: wrapper} of every hooked kernel: the eight, and cache_fill
    (ops/cache_fill.py, the per-pair row cache's fill, which replaces a
    branch and no TPU kernel). A call of any of them is one fact and
    nothing inside it is recorded (on the CPU cache_fill's plain version
    reads its flags there); the ``kernels`` family reports the eight, the
    JAX manifest's, and no manifest entry runs cache_fill."""
    from dpsvm_tpu_torch.ops.cache_fill import cache_fill

    return {**kernel_wrappers(), "cache_fill": cache_fill}


def _collectives() -> dict:
    """{function: collective kind} of the hooked collectives."""
    import torch.distributed as dist

    from dpsvm_tpu_torch.parallel.mesh import Mesh

    out = {Mesh.all_gather_many: "all-gather", Mesh.all_gather: "all-gather",
           Mesh.psum_many: "all-reduce", Mesh.psum: "all-reduce",
           Mesh.pmax: "all-reduce"}
    for name, kind in (("all_gather", "all-gather"),
                       ("all_gather_into_tensor", "all-gather"),
                       ("all_reduce", "all-reduce"),
                       ("reduce_scatter", "reduce-scatter"),
                       ("reduce_scatter_tensor", "reduce-scatter"),
                       ("all_to_all", "all-to-all"),
                       ("all_to_all_single", "all-to-all")):
        fn = getattr(dist, name, None)
        if fn is not None and hasattr(fn, "__code__"):
            # The c10d functions are wrapped by a logging decorator; the
            # code object that runs is the innermost one.
            fn = getattr(fn, "__wrapped__", fn)
            out[fn] = kind
    return out


def _tensors(obj):
    """The tensors of a nested tuple / list / dict / NamedTuple."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _key(t: torch.Tensor) -> tuple:
    """A tensor's bytes identity: its storage and its extent in it."""
    try:
        ptr = t.untyped_storage().data_ptr()
    except RuntimeError:  # a tensor without storage
        return (id(t), 0, 0)
    return (ptr, t.storage_offset() * t.element_size(), _nbytes(t))


def _distinct_bytes(tensors) -> tuple:
    """(bytes, keys) over the distinct byte ranges of `tensors`."""
    keys = {}
    for t in tensors:
        keys.setdefault(_key(t), _nbytes(t))
    return sum(keys.values()), set(keys)


def _storage(t: torch.Tensor) -> int:
    try:
        return t.untyped_storage().data_ptr()
    except RuntimeError:
        return -id(t)


def _dt(dtype) -> str:
    return {torch.float32: "f32", torch.float64: "f64",
            torch.bfloat16: "bf16", torch.float16: "f16",
            torch.int8: "int8", torch.int32: "i32",
            torch.int64: "i64"}.get(dtype, str(dtype))


class Recorder:
    """The facts of what runs between ``__enter__`` and ``__exit__`` in
    the entering thread. ``state`` names the unit's carried arguments
    (the ``inplace`` family); ``facts(args, out)`` adds the memory and
    in-place families from the unit's arguments and result."""

    _lock = threading.Lock()
    _active: Optional["Recorder"] = None

    def __init__(self, state=()):
        self.state = list(_tensors(list(state)))
        self.thread = threading.get_ident()
        self.stack: list = []  # hooked calls in flight (code objects)
        self.quiet = 0  # > 0 inside a counted host read / write
        self.kernels = Counter()
        self.coll = {k: [] for k in COLLECTIVE_KINDS}  # payloads a call
        self.host_reads = 0
        self.host_writes = 0
        self.syncs = 0
        self.ops = Counter()
        self.dots = []  # result ranks
        self.converts = Counter()
        self.f64_ops = 0
        self.f64_seen = False
        self.int8_seen = False
        self.alloc_bytes = 0
        self.written: set = set()  # storages written by in-place ops
        self.host_copies: dict = {}  # id -> weakref of host-side tensors
        self._modes = None
        self.paused: list = []

    # -- the modes ---------------------------------------------------------

    def __enter__(self):
        with Recorder._lock:
            if Recorder._active is not None:
                raise RuntimeError("op_facts recorders do not nest")
            Recorder._active = self
        _HOOKS.install()
        self._modes = (_HostMode(self), _OpMode(self))
        for m in self._modes:
            m.__enter__()
        return self

    def __exit__(self, *exc):
        for m in reversed(self._modes):
            m.__exit__(*exc)
        with Recorder._lock:
            Recorder._active = None
        self.stack.clear()
        return False

    def recording(self) -> bool:
        return not self.stack and not self.quiet

    def pause(self) -> None:
        """Take the two modes off their stacks while a hooked call runs
        (nothing inside it is recorded, and B1's plain version on the
        CPU would otherwise pay a Python call a torch op)."""
        from torch.utils import _python_dispatch as pd

        host, ops = self._modes
        self.paused = []
        if pd._get_current_dispatch_mode() is ops:
            self.paused.append(pd._pop_mode())
        if torch._C._len_torch_function_stack():
            top = torch._C._pop_torch_function_stack()
            if top is host:
                self.paused.append(top)
            else:
                torch._C._push_on_torch_function_stack(top)

    def resume(self) -> None:
        from torch.utils import _python_dispatch as pd

        for m in reversed(self.paused):
            if isinstance(m, TorchDispatchMode):
                pd._push_mode(m)
            else:
                torch._C._push_on_torch_function_stack(m)
        self.paused = []

    # -- host reads and writes ---------------------------------------------

    def _mark_host(self, t) -> None:
        if isinstance(t, torch.Tensor):
            self.host_copies[id(t)] = weakref.ref(t)

    def is_host_copy(self, t) -> bool:
        ref = self.host_copies.get(id(t))
        return ref is not None and ref() is t

    def host_kind(self, func, args, kwargs) -> Optional[str]:
        """'read', 'write' or None for a torch-function call."""
        T = torch.Tensor
        src = args[0] if args else None
        if func in (T.cpu, T.numpy, T.tolist, T.__array__):
            return None if self.is_host_copy(src) else "read"
        if func is T.to and isinstance(src, torch.Tensor):
            dev = kwargs.get("device")
            for a in args[1:]:
                if isinstance(a, (str, torch.device)):
                    dev = a
                elif isinstance(a, torch.Tensor):
                    dev = a.device
            if dev is not None and torch.device(dev).type == "cpu" \
                    and src.device.type != "cpu":
                return "read"
            return None
        if func in (torch.tensor, torch.as_tensor, torch.asarray):
            return None if isinstance(src, torch.Tensor) else "write"
        return None

    def on_host(self, kind: str, out) -> None:
        if kind == "read":
            self.host_reads += 1
            for t in _tensors(out):
                self._mark_host(t)
        else:
            self.host_writes += 1

    # -- hooked calls --------------------------------------------------------

    def on_call(self, kind: str, what: str, retval) -> None:
        if kind == "kernel":
            self.kernels[what] += 1
        else:
            self.coll[what].append(_payloads(retval))
        for t in _tensors(retval):
            self.alloc_bytes += _nbytes(t)

    # -- aten ops ------------------------------------------------------------

    def on_op(self, func, args, kwargs, out) -> None:
        name = func._opname
        outs = list(_tensors(out))
        if name == "_local_scalar_dense":
            if not self.is_host_copy(args[0]):
                self.host_reads += 1
            return
        if name in ("lift_fresh", "lift_fresh_copy"):
            # torch.from_numpy (a Python scalar lifts as a 0-d tensor).
            if args and isinstance(args[0], torch.Tensor) \
                    and args[0].dim() > 0:
                self.host_writes += 1
                for t in outs:
                    self._mark_host(t)
            return
        ins = list(_tensors((args, kwargs)))
        for t in ins + outs:
            if t.dtype == torch.float64:
                self.f64_seen = True
            elif t.dtype == torch.int8:
                self.int8_seen = True
        if name in _SYNC_OPS or (name in ("index", "index_put",
                                          "index_put_")
                                 and _bool_index(args)):
            self.syncs += 1
        if func.is_view or name in _ALLOC_OPS:
            if name in _ALLOC_OPS:
                self.alloc_bytes += sum(_nbytes(t) for t in outs)
            return
        self.ops[name] += 1
        if name in _DOT_OPS:
            self.dots.append(outs[0].dim() if outs else 0)
        if any(t.dtype == torch.float64 for t in outs):
            self.f64_ops += 1
        if name == "_to_copy" and ins and outs:
            self._convert(ins[0].dtype, outs[0].dtype)
        elif name == "copy_" and len(ins) >= 2:
            self._convert(ins[1].dtype, ins[0].dtype)
        if func._schema.is_mutable:
            for a, v in zip(func._schema.arguments, args):
                if a.alias_info is not None and a.alias_info.is_write \
                        and isinstance(v, torch.Tensor):
                    self.written.add(_storage(v))
        else:
            self.alloc_bytes += sum(_nbytes(t) for t in outs)

    def _convert(self, frm, to) -> None:
        if frm != to:
            self.converts[(_dt(frm), _dt(to))] += 1

    # -- the facts -----------------------------------------------------------

    def facts(self, args=(), out=None) -> dict:
        """The fact families; `args` and `out` the unit's arguments and
        result (the memory and inplace families)."""
        coll = {}
        for kind in COLLECTIVE_KINDS:
            payloads = sorted(b for call in self.coll[kind] for b in call)
            coll[kind] = {"count": len(self.coll[kind]),
                          "payload_bytes": payloads,
                          "total_bytes": sum(payloads)}
        cv = self.converts
        dtypes = {"f64_result_ops": self.f64_ops,
                  "f64_present": bool(self.f64_seen),
                  "f32_to_bf16_converts": cv[("f32", "bf16")],
                  "bf16_to_f32_converts": cv[("bf16", "f32")],
                  "f32_to_f64_converts": cv[("f32", "f64")]}
        if self.int8_seen:
            dtypes.update({"f32_to_int8_converts": cv[("f32", "int8")],
                           "int8_to_f32_converts": cv[("int8", "f32")],
                           "i32_to_f32_converts": cv[("i32", "f32")],
                           "int8_to_i32_converts": cv[("int8", "i32")]})
        arg_t = list(_tensors(args))
        out_t = list(_tensors(out))
        arg_b, arg_keys = _distinct_bytes(arg_t)
        out_b, out_keys = _distinct_bytes(out_t)
        alias_b = sum(k[2] for k in out_keys & arg_keys)
        kept = {_storage(t) for t in out_t} | self.written
        aliased = sum(1 for t in self.state if _storage(t) in kept)
        return {
            "collectives": coll,
            "transfers": {"host_reads": self.host_reads,
                          "host_writes": self.host_writes,
                          "implicit_syncs": self.syncs},
            "dots": {"count": len(self.dots),
                     "max_result_rank": max(self.dots, default=0),
                     "batched_rank3plus": sum(1 for r in self.dots
                                              if r >= 3)},
            "dtypes": dtypes,
            "inplace": {"donatable": len(self.state),
                        "aliased_outputs": aliased,
                        "missed": len(self.state) - aliased},
            "memory": {"argument_bytes": arg_b, "output_bytes": out_b,
                       "temp_bytes": max(0, self.alloc_bytes
                                         - (out_b - alias_b)),
                       "alias_bytes": alias_b},
            "kernels": {k: self.kernels[k] for k in KERNEL_IDS},
            "ops": {"count": sum(self.ops.values()),
                    "by_name": dict(sorted(self.ops.items()))},
        }


def _bool_index(args) -> bool:
    idx = args[1] if len(args) > 1 else ()
    return any(isinstance(t, torch.Tensor) and t.dtype == torch.bool
               for t in (idx if isinstance(idx, (list, tuple)) else ()))


def _payloads(retval) -> list:
    """Per-result payload bytes of a collective's return value: a packed
    call (per list, per group) gives one payload per list, taken from
    its first group (every group holds the same result); a single
    call's per-group list gives one."""
    if isinstance(retval, list) and retval and isinstance(retval[0], list):
        return [_nbytes(lst[0]) for lst in retval if lst]
    if isinstance(retval, list) and retval:
        return [_nbytes(retval[0])]
    if isinstance(retval, torch.Tensor):
        return [_nbytes(retval)]
    return []


def _frame_payloads(frame) -> list:
    """Payload bytes of a torch.distributed call from its arguments (its
    functions return a work handle or None): the output tensor(s) where
    the call has one, else the in-place tensor."""
    loc = frame.f_locals
    for name in ("output_tensor", "output", "tensor_list", "output_list",
                 "tensor"):
        if name in loc:
            got = [_nbytes(t) for t in _tensors(loc[name])]
            if name in ("tensor_list", "output_list"):
                got = [sum(got)]
            return got
    return []


class _OpMode(TorchDispatchMode):
    """Records every aten op of the entering thread."""

    def __init__(self, rec: Recorder):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.rec.recording():
            self.rec.on_op(func, args, kwargs, out)
        return out


class _HostMode(TorchFunctionMode):
    """Counts the Python-level host reads and writes; nothing inside one
    is recorded op by op (on the card ``.cpu()`` dispatches a copy, on
    the CPU nothing)."""

    def __init__(self, rec: Recorder):
        super().__init__()
        self.rec = rec

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rec = self.rec
        kind = (rec.host_kind(func, args, kwargs) if rec.recording()
                else None)
        if kind is None:
            return func(*args, **kwargs)
        rec.quiet += 1
        try:
            out = func(*args, **kwargs)
        finally:
            rec.quiet -= 1
        rec.on_host(kind, out)
        return out


class _Hooks:
    """sys.monitoring callbacks on the code objects of the kernel
    wrappers and the collectives, installed once per process. A call is
    recorded when it is the outermost hooked call of the active
    recorder's thread; its return value gives the payloads (a
    torch.distributed call's come from its arguments)."""

    def __init__(self):
        self.installed = False
        self.codes: dict = {}  # code -> ("kernel", id) | ("coll", kind)
        self.tool = None

    def install(self) -> None:
        if self.installed:
            return
        mon = sys.monitoring
        for kid, fn in _hooked_kernels().items():
            self.codes[fn.__code__] = ("kernel", kid)
        for fn, kind in _collectives().items():
            self.codes[fn.__code__] = ("coll", kind)
        tool = next((i for i in (4, 3, 5) if mon.get_tool(i) is None), None)
        if tool is None:
            raise RuntimeError("op_facts needs a free sys.monitoring tool "
                               "id (3, 4 or 5)")
        mon.use_tool_id(tool, "dpsvm-op-facts")
        E = mon.events
        mon.register_callback(tool, E.PY_START, self._start)
        mon.register_callback(tool, E.PY_RETURN, self._return)
        mon.register_callback(tool, E.PY_UNWIND, self._unwind)
        for code in self.codes:
            mon.set_local_events(tool, code, E.PY_START | E.PY_RETURN)
        mon.set_events(tool, E.PY_UNWIND)
        self.tool = tool
        self.installed = True

    @staticmethod
    def _rec():
        rec = Recorder._active
        if rec is None or rec.thread != threading.get_ident():
            return None
        return rec

    def _start(self, code, offset):
        rec = self._rec()
        if rec is None:
            return
        what = self.codes.get(code)
        if what is None:
            return
        pay = None
        if not rec.stack and not rec.quiet and what[0] == "coll":
            frame = sys._getframe(1)
            if "distributed" in code.co_filename:
                pay = _frame_payloads(frame)
            elif getattr(frame.f_locals.get("self"), "size", 2) == 1:
                pay = ()  # a one-rank mesh exchanges nothing
        if not rec.stack:
            rec.pause()
        rec.stack.append((code, pay))

    def _return(self, code, offset, retval):
        rec = self._rec()
        if rec is None or not rec.stack or rec.stack[-1][0] is not code:
            return
        _, pay = rec.stack.pop()
        if rec.stack:
            return
        rec.resume()
        if rec.quiet:
            return
        kind, what = self.codes[code]
        if pay == ():
            return
        if pay is not None:
            rec.coll[what].append(pay)
        else:
            rec.on_call(kind, what, retval)

    def _unwind(self, code, offset, exc):
        rec = self._rec()
        if rec is not None and rec.stack and rec.stack[-1][0] is code:
            rec.stack.pop()
            if not rec.stack:
                rec.resume()


_HOOKS = _Hooks()


def record(fn, *args, state=(), **kwargs) -> tuple:
    """Run fn(*args, **kwargs) under a Recorder: (result, facts)."""
    with Recorder(state=state) as rec:
        out = fn(*args, **kwargs)
    return out, rec.facts(args=(args, kwargs), out=out)
