"""threadlint fact extraction: static concurrency facts, pure AST
(counterpart of dpsvm_tpu/analysis/concurrency_facts.py, the port's own
copy).

The serving fabric (wire front door, replica fleet, registry hot swap,
async dispatcher, watchdog, metrics exporter), the kernel build lock and
the run log's write lock make a threaded host layer. This module
extracts structured facts from the SOURCE of the threaded modules and
`threadlint.py` diffs them against committed contracts. Four fact
families:

guarded_by        every threading.Lock/RLock/Condition object, its
                  `with` regions, and which ``self._x`` attributes are
                  written inside vs. outside them; plus which THREAD
                  ENTRY POINTS (thread targets, signal handlers,
                  ``__del__``, metrics-render callbacks) can reach a
                  function that touches each attribute.
lock_order        the acquired-while-holding directed graph across
                  modules (direct `with` nesting plus a one-pass
                  call-graph expansion), its cycles (potential
                  deadlock), and a canonical topological order.
thread_lifecycle  every ``threading.Thread(...)`` creation site: the
                  (normalized) name literal, whether it carries the
                  mandatory ``dpsvm-`` prefix, and whether the thread
                  is provably daemonized or joined somewhere in its
                  module.
seam_coverage     cross-thread handoff points (queue puts, event sets)
                  cross-referenced against the ``testing/faults.py``
                  SEAM names, so a new handoff without a fault seam is
                  flagged.

Everything here is stdlib-only: these facts are properties of the
Python source alone, so the contracts carry no version stamp.

Analysis scope and honesty notes:

* Lock references resolve through ``self``-attributes of the current
  class, constructor-typed attributes/locals (``self.x = Cls()`` /
  ``x = Cls()``), module-level names, and, as a last resort, a
  globally UNIQUE attribute name. Unresolvable `with` items are
  ignored (never guessed).
* Calls resolve the same way; calls with ambiguous names and untyped
  receivers are SKIPPED, so the lock-order graph can miss edges but
  does not invent them: a missed edge costs coverage, an invented one
  would cost false deadlock reports.
* Writes inside ``__init__`` are construction-time (happens-before
  publication) and counted separately, not as unguarded writes.
* The analysed tree is whatever {path: text} mapping the extractor is
  given (:func:`load_sources` builds the port's); the faults module is
  the mapping's ``testing/faults.py``. Given the JAX package's modules
  the extractor gives the JAX package's facts.
"""

from __future__ import annotations

import ast
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]

# The threaded surface of the port. Order is cosmetic (facts are
# sorted); membership is the contract: a new threaded module must be
# added here to be linted. serve.py holds no thread or lock of its own
# but its PredictServer renders metrics on the exporter's thread, as in
# the JAX package's list; ops/_build.py (the kernel build lock) and
# obs/runlog.py (the run log's write lock) are the port's own.
THREADED_MODULES = (
    "dpsvm_tpu_torch/cli.py",
    "dpsvm_tpu_torch/obs/export.py",
    "dpsvm_tpu_torch/obs/runlog.py",
    "dpsvm_tpu_torch/ops/_build.py",
    "dpsvm_tpu_torch/serve.py",
    "dpsvm_tpu_torch/serving/dispatch.py",
    "dpsvm_tpu_torch/serving/engine_core.py",
    "dpsvm_tpu_torch/serving/registry.py",
    "dpsvm_tpu_torch/serving/replicas.py",
    "dpsvm_tpu_torch/serving/scheduler.py",
    "dpsvm_tpu_torch/serving/server.py",
    "dpsvm_tpu_torch/testing/faults.py",
    "dpsvm_tpu_torch/utils/native.py",
)

FAULTS_MODULE = "dpsvm_tpu_torch/testing/faults.py"
_FAULTS_SUFFIX = "testing/faults.py"

_LOCK_CTORS = {"Lock": "Lock", "RLock": "RLock", "Condition": "Condition"}
_EVENT_CTORS = {"Event"}
_QUEUE_CTORS = {"Queue", "SimpleQueue", "LifoQueue", "PriorityQueue"}
_HANDOFF_PUTS = {"put", "put_nowait"}

# Method names shared with stdlib containers/primitives. These never
# resolve through the globally-unique-name fallback (a dict's .get()
# must not be mistaken for ModelRegistry.get — that invents a
# self-deadlock edge); typed receivers still resolve them.
_GENERIC_METHODS = frozenset({
    "get", "put", "put_nowait", "get_nowait", "set", "pop", "popitem",
    "append", "extend", "add", "discard", "remove", "update", "clear",
    "copy", "keys", "values", "items", "setdefault", "join", "split",
    "strip", "acquire", "release", "wait", "notify", "notify_all",
    "start", "read", "write", "send", "recv", "close", "open", "index",
    "count", "sort", "encode", "decode", "format",
})


def _attr_chain(node):
    """('self', '_stats', 'bump') for ``self._stats.bump`` — or None
    for anything that is not a pure Name/Attribute chain."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def _name_literal(node):
    """Normalize a Thread ``name=`` value: string constants verbatim,
    f-strings as the constant parts with ``*`` for formatted fields
    (``f"dpsvm-net-writer-{cid}"`` -> ``dpsvm-net-writer-*``)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        out = []
        for part in node.values:
            if isinstance(part, ast.Constant):
                out.append(str(part.value))
            else:
                out.append("*")
        return "".join(out)
    if isinstance(node, ast.IfExp):
        # name=("dpsvm-net-pump" if n == 1 else f"dpsvm-net-pump-{i}")
        a = _name_literal(node.body)
        b = _name_literal(node.orelse)
        if a is None or b is None:
            return None
        if a == b:
            return a
        common = ""
        for ca, cb in zip(a, b):
            if ca != cb:
                break
            common += ca
        return common + "*"
    return None


def _walk_no_defs(node):
    """ast.walk that does not descend into nested function/lambda
    bodies (those run on their own schedule, under their own held-lock
    state)."""
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            stack.append(child)


class _Module:
    def __init__(self, key: str, tree: ast.Module):
        self.key = key
        self.stem = Path(key).stem
        self.tree = tree
        self.classes: dict = {}          # class name -> ClassDef
        self.aliases: dict = {}          # local alias -> module key
        self.module_locks: dict = {}     # name -> kind
        self.event_names: set = set()    # attr tails / locals = Event()
        self.queue_names: set = set()
        self.joined_tails: set = set()   # receiver tails with .join(
        self.fns: list = []              # _Fn scans


class _Fn:
    def __init__(self, module: _Module, cls, qual: str):
        self.module = module
        self.cls = cls                   # class name or None
        self.qual = qual                 # "Cls.meth" / "fn" / nested
        self.id = f"{module.key}::{qual}"
        self.is_init = qual.endswith("__init__")
        self.writes = []                 # (attr_id, held tuple, is_init)
        self.reads = set()               # attr ids (self attrs)
        self.raw_name_reads = set()
        self.global_decls = set()
        self.calls = []                  # (chain, held tuple)
        self.acquires = set()            # lock ids acquired directly
        self.nested_edges = set()        # (held, acquired)
        self.thread_sites = []
        self.signal_handlers = []
        self.render_fns = []             # chains passed to MetricsExporter
        self.handoffs = []               # (tail, method)
        self.local_types = {}            # var -> class name
        self.nested_defs = {}            # name -> fn id


class _Extractor:
    def __init__(self, sources: dict):
        self.sources = sources
        self.modules: dict = {}
        self.lock_registry: dict = {}    # lock id -> {kind, module}
        self.locks_by_tail: dict = {}    # attr name -> set(lock ids)
        self.class_index: dict = {}      # class name -> module key
        self.methods: dict = {}          # (cls, name) -> fn id
        self.fn_index: dict = {}         # fn id -> _Fn
        self.fns_by_name: dict = {}      # bare name -> [fn id]
        self.attr_types: dict = {}       # (cls, attr) -> class name
        self.attr_types_by_tail: dict = {}  # attr -> set(class name)
        self.seams: list = []

    # ------------------------------------------------------- pass A
    def declare(self):
        for key in sorted(self.sources):
            tree = ast.parse(self.sources[key], filename=key)
            mod = _Module(key, tree)
            self.modules[key] = mod
            for node in tree.body:
                if isinstance(node, ast.ClassDef):
                    mod.classes[node.name] = node
                    self.class_index.setdefault(node.name, key)
                elif isinstance(node, (ast.Import, ast.ImportFrom)):
                    self._declare_import(mod, node)
                elif isinstance(node, ast.Assign):
                    self._declare_module_assign(mod, node)
            # constructor-typed attrs + lock/event/queue decls live in
            # method bodies; a flat walk is enough for declarations.
            for cls in mod.classes.values():
                for sub in ast.walk(cls):
                    if isinstance(sub, ast.Assign):
                        self._declare_self_assign(mod, cls.name, sub)
            for sub in ast.walk(tree):
                if isinstance(sub, ast.Call):
                    chain = _attr_chain(sub.func)
                    if chain and chain[-1] == "join":
                        if len(chain) >= 2:
                            mod.joined_tails.add(chain[-2])
        faults = [k for k in self.modules if k.endswith(_FAULTS_SUFFIX)]
        if faults:
            self.seams = self._parse_seams(self.modules[faults[0]])

    def _declare_import(self, mod: _Module, node):
        if isinstance(node, ast.Import):
            for a in node.names:
                path = a.name.replace(".", "/") + ".py"
                if path in self.sources and (a.asname
                                             or "." not in a.name):
                    mod.aliases[a.asname or a.name] = path
        else:
            base = (node.module or "").replace(".", "/")
            for a in node.names:
                path = f"{base}/{a.name}.py" if base else f"{a.name}.py"
                if path in self.sources:
                    mod.aliases[a.asname or a.name] = path

    def _ctor_name(self, value):
        if not isinstance(value, ast.Call):
            return None
        chain = _attr_chain(value.func)
        return chain[-1] if chain else None

    def _declare_module_assign(self, mod: _Module, node: ast.Assign):
        ctor = self._ctor_name(node.value)
        if ctor is None:
            return
        for tgt in node.targets:
            if not isinstance(tgt, ast.Name):
                continue
            if ctor in _LOCK_CTORS:
                lock_id = f"{mod.stem}.{tgt.id}"
                mod.module_locks[tgt.id] = _LOCK_CTORS[ctor]
                self.lock_registry[lock_id] = {
                    "kind": _LOCK_CTORS[ctor], "module": mod.key}
                self.locks_by_tail.setdefault(tgt.id, set()).add(lock_id)
            elif ctor in _EVENT_CTORS:
                mod.event_names.add(tgt.id)
            elif ctor in _QUEUE_CTORS:
                mod.queue_names.add(tgt.id)

    def _declare_self_assign(self, mod: _Module, cls: str,
                             node: ast.Assign):
        ctor = self._ctor_name(node.value)
        if ctor is None:
            return
        for tgt in node.targets:
            chain = _attr_chain(tgt)
            if chain is None or len(chain) != 2 or chain[0] != "self":
                continue
            attr = chain[1]
            if ctor in _LOCK_CTORS:
                lock_id = f"{cls}.{attr}"
                self.lock_registry[lock_id] = {
                    "kind": _LOCK_CTORS[ctor], "module": mod.key}
                self.locks_by_tail.setdefault(attr, set()).add(lock_id)
            elif ctor in _EVENT_CTORS:
                mod.event_names.add(attr)
            elif ctor in _QUEUE_CTORS:
                mod.queue_names.add(attr)
            elif ctor in self.class_index:
                self.attr_types[(cls, attr)] = ctor
                self.attr_types_by_tail.setdefault(attr, set()).add(ctor)

    def _parse_seams(self, mod: _Module) -> list:
        for node in mod.tree.body:
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name) and tgt.id == "SEAMS":
                        consts = [n.value for n in ast.walk(node.value)
                                  if isinstance(n, ast.Constant)
                                  and isinstance(n.value, str)]
                        return sorted(set(consts))
        return []

    # ------------------------------------------------------- pass B
    def scan(self):
        for key in sorted(self.modules):
            mod = self.modules[key]
            for node in mod.tree.body:
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    self._scan_function(mod, None, node.name, node)
                elif isinstance(node, ast.ClassDef):
                    for sub in node.body:
                        if isinstance(sub, (ast.FunctionDef,
                                            ast.AsyncFunctionDef)):
                            self._scan_function(
                                mod, node.name,
                                f"{node.name}.{sub.name}", sub)

    def _register(self, fn: _Fn):
        self.fn_index[fn.id] = fn
        fn.module.fns.append(fn)
        bare = fn.qual.rsplit(".", 1)[-1]
        self.fns_by_name.setdefault(bare, []).append(fn.id)
        if fn.cls is not None and fn.qual == f"{fn.cls}.{bare}":
            self.methods[(fn.cls, bare)] = fn.id

    def _scan_function(self, mod: _Module, cls, qual, node) -> _Fn:
        fn = _Fn(mod, cls, qual)
        self._register(fn)
        self._visit_stmts(fn, node.body, held=(), loop_iters={})
        return fn

    # -- statement walker (tracks the held-lock stack) --------------
    def _visit_stmts(self, fn: _Fn, stmts, held, loop_iters):
        for st in stmts:
            self._visit_stmt(fn, st, held, loop_iters)

    def _visit_stmt(self, fn: _Fn, st, held, loop_iters):
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            nested_qual = f"{fn.qual}.<locals>.{st.name}"
            nested = self._scan_function(fn.module, fn.cls, nested_qual,
                                         st)
            fn.nested_defs[st.name] = nested.id
            return
        if isinstance(st, ast.Global):
            fn.global_decls.update(st.names)
            return
        if isinstance(st, (ast.With, ast.AsyncWith)):
            acquired = []
            for item in st.items:
                self._scan_expr(fn, item.context_expr, held)
                chain = _attr_chain(item.context_expr)
                lock = self._resolve_lock(fn, chain) if chain else None
                if lock is not None:
                    self._note_acquire(fn, lock, held)
                    acquired.append(lock)
            self._visit_stmts(fn, st.body, held + tuple(acquired),
                              loop_iters)
            return
        if isinstance(st, (ast.If, ast.While)):
            self._scan_expr(fn, st.test, held)
            self._visit_stmts(fn, st.body, held, loop_iters)
            self._visit_stmts(fn, st.orelse, held, loop_iters)
            return
        if isinstance(st, (ast.For, ast.AsyncFor)):
            self._scan_expr(fn, st.iter, held)
            iters = dict(loop_iters)
            it_chain = _attr_chain(st.iter)
            if isinstance(st.target, ast.Name) and it_chain:
                iters[st.target.id] = it_chain[-1]
            self._visit_stmts(fn, st.body, held, iters)
            self._visit_stmts(fn, st.orelse, held, loop_iters)
            return
        if isinstance(st, ast.Try):
            self._visit_stmts(fn, st.body, held, loop_iters)
            for h in st.handlers:
                self._visit_stmts(fn, h.body, held, loop_iters)
            self._visit_stmts(fn, st.orelse, held, loop_iters)
            self._visit_stmts(fn, st.finalbody, held, loop_iters)
            return
        # leaf statement: writes + expression scan
        if isinstance(st, ast.Assign):
            n_sites = len(fn.thread_sites)
            for tgt in st.targets:
                self._note_write_target(fn, tgt, held)
            self._note_typing(fn, st, held)
            self._scan_expr(fn, st.value, held)
            if len(fn.thread_sites) > n_sites:
                tail = None
                if len(st.targets) == 1:
                    chain = _attr_chain(st.targets[0])
                    if chain:
                        tail = chain[-1]
                for site in fn.thread_sites[n_sites:]:
                    site["stored"] = tail
            return
        if isinstance(st, ast.AugAssign):
            self._note_write_target(fn, st.target, held)
            self._scan_expr(fn, st.value, held)
            return
        if isinstance(st, ast.AnnAssign):
            self._note_write_target(fn, st.target, held)
            if st.value is not None:
                self._scan_expr(fn, st.value, held)
            return
        self._scan_expr(fn, st, held, loop_iters)

    def _note_acquire(self, fn: _Fn, lock: str, held):
        fn.acquires.add(lock)
        kind = self.lock_registry.get(lock, {}).get("kind")
        for h in held:
            if h == lock and kind == "RLock":
                continue  # reentrant re-acquire is the point of RLock
            fn.nested_edges.add((h, lock))

    # -- write / read / call collection ------------------------------
    def _attr_id_of_target(self, fn: _Fn, node):
        # self.X  /  self.X[...]  /  global NAME  /  NAME[...]
        if isinstance(node, ast.Subscript):
            node = node.value
        chain = _attr_chain(node)
        if chain is None:
            return None
        if len(chain) == 2 and chain[0] == "self" and fn.cls:
            return f"{fn.cls}.{chain[1]}"
        if len(chain) == 1 and chain[0] in fn.global_decls:
            return f"{fn.module.stem}.{chain[0]}"
        return None

    def _note_write_target(self, fn: _Fn, tgt, held):
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._note_write_target(fn, el, held)
            return
        attr_id = self._attr_id_of_target(fn, tgt)
        if attr_id is not None:
            fn.writes.append((attr_id, tuple(sorted(set(held))),
                              fn.is_init))

    def _note_typing(self, fn: _Fn, st: ast.Assign, held):
        values = [st.value]
        if isinstance(st.value, ast.IfExp):
            # stop = stop_event if stop_event is not None else Event()
            values = [st.value.body, st.value.orelse]
        ctors = [c for c in map(self._ctor_name, values)
                 if c is not None]
        for ctor in ctors:
            for tgt in st.targets:
                if isinstance(tgt, ast.Name):
                    if ctor in self.class_index:
                        fn.local_types[tgt.id] = ctor
                    if ctor in _EVENT_CTORS:
                        fn.module.event_names.add(tgt.id)
                    if ctor in _QUEUE_CTORS:
                        fn.module.queue_names.add(tgt.id)

    def _scan_expr(self, fn: _Fn, node, held, loop_iters=None):
        loop_iters = loop_iters or {}
        for sub in _walk_no_defs(node):
            if isinstance(sub, ast.Call):
                self._note_call(fn, sub, held, loop_iters)
            elif isinstance(sub, ast.Attribute) and isinstance(
                    sub.ctx, ast.Load):
                chain = _attr_chain(sub)
                if chain and len(chain) == 2 and chain[0] == "self" \
                        and fn.cls:
                    fn.reads.add(f"{fn.cls}.{chain[1]}")
            elif isinstance(sub, ast.Name) and isinstance(
                    sub.ctx, ast.Load):
                fn.raw_name_reads.add(sub.id)

    def _note_call(self, fn: _Fn, call: ast.Call, held, loop_iters):
        chain = _attr_chain(call.func)
        if chain is None:
            return
        tail = chain[-1]
        # threading.Thread(...) creation sites
        if tail == "Thread" and (len(chain) == 1
                                 or chain[-2] == "threading"):
            self._note_thread_site(fn, call)
            return
        # signal.signal(SIG, handler)
        if chain == ("signal", "signal") and len(call.args) >= 2:
            hchain = _attr_chain(call.args[1])
            if hchain:
                fn.signal_handlers.append(hchain)
            return
        # MetricsExporter(render_fn, ...): the render callback runs on
        # the exporter's daemon HTTP thread — a thread entry point.
        if tail == "MetricsExporter":
            rarg = call.args[0] if call.args else None
            for kw in call.keywords:
                if kw.arg == "render_fn":
                    rarg = kw.value
            rchain = _attr_chain(rarg) if rarg is not None else None
            if rchain:
                fn.render_fns.append(rchain)
            return
        # cross-thread handoffs
        if tail in _HANDOFF_PUTS and len(chain) >= 2:
            fn.handoffs.append((chain[-2], tail))
        elif tail == "set" and len(chain) >= 2 \
                and chain[-2] in fn.module.event_names:
            fn.handoffs.append((chain[-2], "set"))
        # lock.acquire() outside `with` (no region tracking — the lock
        # still participates in the order graph)
        if tail == "acquire" and len(chain) >= 2:
            lock = self._resolve_lock(fn, chain[:-1])
            if lock is not None:
                self._note_acquire(fn, lock, held)
        # thread joins via loop vars: `for th in self._threads: th.join()`
        if tail == "join" and len(chain) == 2 \
                and chain[0] in loop_iters:
            fn.module.joined_tails.add(loop_iters[chain[0]])
        fn.calls.append((chain, tuple(sorted(set(held)))))

    def _note_thread_site(self, fn: _Fn, call: ast.Call):
        site = {"name": None, "daemon": False, "target": None,
                "stored": None}
        for kw in call.keywords:
            if kw.arg == "name":
                site["name"] = _name_literal(kw.value)
            elif kw.arg == "daemon":
                if isinstance(kw.value, ast.Constant):
                    site["daemon"] = bool(kw.value.value)
            elif kw.arg == "target":
                tchain = _attr_chain(kw.value)
                site["target"] = tchain
        fn.thread_sites.append(site)

    # -- resolution ---------------------------------------------------
    def _resolve_lock(self, fn: _Fn, chain):
        if not chain:
            return None
        tail = chain[-1]
        if len(chain) >= 2 and chain[0] == "self" and fn.cls:
            if len(chain) == 2:
                lock_id = f"{fn.cls}.{tail}"
                if lock_id in self.lock_registry:
                    return lock_id
            else:
                owner = self._type_of_tail(fn, chain[-2])
                if owner:
                    lock_id = f"{owner}.{tail}"
                    if lock_id in self.lock_registry:
                        return lock_id
        if len(chain) == 1:
            if tail in fn.module.module_locks:
                return f"{fn.module.stem}.{tail}"
        if len(chain) >= 2 and chain[0] != "self":
            owner = self._type_of_tail(fn, chain[-2])
            if owner:
                lock_id = f"{owner}.{tail}"
                if lock_id in self.lock_registry:
                    return lock_id
        # globally-unique attribute name, last resort
        cands = self.locks_by_tail.get(tail, set())
        if len(cands) == 1:
            return next(iter(cands))
        return None

    def _type_of_tail(self, fn: _Fn, name):
        if name in fn.local_types:
            return fn.local_types[name]
        if fn.cls and (fn.cls, name) in self.attr_types:
            return self.attr_types[(fn.cls, name)]
        cands = self.attr_types_by_tail.get(name, set())
        if len(cands) == 1:
            return next(iter(cands))
        return None

    def _resolve_call(self, fn: _Fn, chain):
        tail = chain[-1]
        recv = chain[:-1]
        if not recv:
            if tail in fn.nested_defs:
                return fn.nested_defs[tail]
            same = f"{fn.module.key}::{tail}"
            if same in self.fn_index:
                return same
            if tail in self.class_index:  # Cls(...) -> Cls.__init__
                return self.methods.get((tail, "__init__"))
            return None
        if recv == ("self",) and fn.cls:
            hit = self.methods.get((fn.cls, tail))
            if hit:
                return hit
        if len(recv) == 1 and recv[0] in fn.module.aliases:
            target = f"{fn.module.aliases[recv[0]]}::{tail}"
            if target in self.fn_index:
                return target
        owner = self._type_of_tail(fn, recv[-1]) if recv[-1] != "self" \
            else fn.cls
        if owner:
            hit = self.methods.get((owner, tail))
            if hit:
                return hit
        if tail in _GENERIC_METHODS:
            return None  # container-method name: typed receivers only
        cands = self.fns_by_name.get(tail, [])
        if len(cands) == 1:
            return cands[0]
        return None  # ambiguous: skip, never guess

    # -- global analysis ---------------------------------------------
    def resolve_calls(self):
        for fn in self.fn_index.values():
            fn.resolved_calls = []
            fn.union_callees = set()
            for chain, held in fn.calls:
                callee = self._resolve_call(fn, chain)
                if callee is not None:
                    fn.resolved_calls.append((callee, held))
                    continue
                # Reachability (and ONLY reachability) tolerates a
                # small ambiguous fan-out: `obj.render_openmetrics()`
                # through an untyped receiver reaches every definer.
                # Lock-order edges never use these — a missed edge
                # costs coverage, an invented one costs a false
                # deadlock report.
                tail = chain[-1]
                if len(chain) >= 2 and tail not in _GENERIC_METHODS:
                    cands = self.fns_by_name.get(tail, [])
                    if 1 < len(cands) <= 4:
                        fn.union_callees.update(cands)

    def may_acquire(self) -> dict:
        acq = {fid: set(fn.acquires)
               for fid, fn in self.fn_index.items()}
        changed = True
        while changed:
            changed = False
            for fid, fn in self.fn_index.items():
                for callee, _held in fn.resolved_calls:
                    extra = acq.get(callee, set()) - acq[fid]
                    if extra:
                        acq[fid].update(extra)
                        changed = True
        return acq

    def lock_edges(self, acq: dict) -> set:
        edges = set()
        for fn in self.fn_index.values():
            edges.update(fn.nested_edges)
            for callee, held in fn.resolved_calls:
                for h in held:
                    kind = self.lock_registry.get(h, {}).get("kind")
                    for lock in acq.get(callee, ()):
                        if lock == h and kind == "RLock":
                            continue
                        edges.add((h, lock))
        return edges

    def thread_roots(self) -> dict:
        """root label -> set of root fn ids."""
        roots: dict = {}

        def add(label, fid):
            if fid is not None and fid in self.fn_index:
                roots.setdefault(label, set()).add(fid)

        for fn in self.fn_index.values():
            for site in fn.thread_sites:
                target = site["target"]
                fid = self._resolve_call(fn, target) if target else None
                name = site["name"] or (target[-1] if target else "?")
                add(f"thread:{name}", fid)
            for hchain in fn.signal_handlers:
                add(f"signal:{hchain[-1]}",
                    self._resolve_call(fn, hchain))
            for rchain in fn.render_fns:
                add(f"metrics-render:{fn.module.stem}",
                    self._resolve_call(fn, rchain))
            if fn.qual.endswith("__del__") and fn.cls:
                add(f"del:{fn.cls}", fn.id)
        return roots

    def inherited_held(self) -> dict:
        """Called-with-held inference: a function whose EVERY known
        (resolved) call site runs with lock L held counts as executing
        under L — the ``_form_locked`` / ``_drop_ref`` /
        ``_journal_snapshot_locked`` idiom, where the public method
        takes the lock and delegates. Standard optimistic meet: start
        callees at the full lock set, narrow by intersection over
        call sites (each site contributing its literal held set plus
        its caller's own inherited set) until fixpoint. Functions with
        no known callers (public API, thread targets) inherit
        nothing."""
        all_locks = frozenset(self.lock_registry)
        callers: dict = {}
        for fid, fn in self.fn_index.items():
            for callee, held in fn.resolved_calls:
                callers.setdefault(callee, []).append((fid, held))
        inherited = {fid: (all_locks if fid in callers else frozenset())
                     for fid in self.fn_index}
        changed = True
        while changed:
            changed = False
            for fid, sites in callers.items():
                new = None
                for caller, held in sites:
                    eff = frozenset(held) | inherited[caller]
                    new = eff if new is None else (new & eff)
                if new != inherited[fid]:
                    inherited[fid] = new
                    changed = True
        return inherited

    def reachable(self, root_fids) -> set:
        seen = set(root_fids)
        stack = list(root_fids)
        while stack:
            fid = stack.pop()
            fn = self.fn_index[fid]
            nxt = {c for c, _h in fn.resolved_calls}
            nxt.update(fn.union_callees)
            for callee in nxt:
                if callee not in seen:
                    seen.add(callee)
                    stack.append(callee)
        return seen


# ------------------------------------------------------------------
# graph helpers
# ------------------------------------------------------------------
def find_cycles(edges) -> list:
    """Strongly-connected components of size > 1, plus self-loops, as
    deterministic ' -> '-joined strings."""
    graph: dict = {}
    nodes = set()
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
        nodes.add(a)
        nodes.add(b)
    index = {}
    low = {}
    on_stack = set()
    stack = []
    sccs = []
    counter = [0]

    def strongconnect(v):
        work = [(v, iter(sorted(graph.get(v, ()))))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(graph.get(w, ())))))
                    advanced = True
                    break
                elif w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                sccs.append(scc)

    for v in sorted(nodes):
        if v not in index:
            strongconnect(v)

    cycles = []
    for scc in sccs:
        if len(scc) > 1:
            cyc = sorted(scc)
            cycles.append(" -> ".join(cyc + [cyc[0]]))
    for a, b in edges:
        if a == b:
            cycles.append(f"{a} -> {a}")
    return sorted(set(cycles))


def topological_order(edges) -> list:
    """Deterministic Kahn order (lexicographic tie-break). Nodes on
    cycles are omitted — the order is only meaningful when the graph
    is acyclic, which the ORDER contract enforces."""
    nodes = set()
    succ: dict = {}
    indeg: dict = {}
    for a, b in edges:
        nodes.add(a)
        nodes.add(b)
        if b not in succ.setdefault(a, set()):
            succ[a].add(b)
            indeg[b] = indeg.get(b, 0) + 1
    ready = sorted(n for n in nodes if indeg.get(n, 0) == 0)
    order = []
    while ready:
        n = ready.pop(0)
        order.append(n)
        for m in sorted(succ.get(n, ())):
            indeg[m] -= 1
            if indeg[m] == 0:
                ready.append(m)
        ready.sort()
    return order


# ------------------------------------------------------------------
# public entry
# ------------------------------------------------------------------
def load_sources(root=None, overrides=None) -> dict:
    root = Path(root) if root is not None else REPO_ROOT
    sources = {}
    for key in sorted(set(THREADED_MODULES)):
        if overrides and key in overrides:
            sources[key] = overrides[key]
        else:
            sources[key] = (root / key).read_text()
    return sources


def extract_concurrency_facts(root=None, sources=None) -> dict:
    """The four fact families over the threaded modules. ``sources`` is
    the {path: text} mapping to analyse (tests inject deliberate
    mutations through ``load_sources(overrides=...)`` without touching
    the tree, or hand over another package's modules); None reads the
    port's THREADED_MODULES under `root`."""
    ex = _Extractor(load_sources(root) if sources is None
                    else dict(sources))
    ex.declare()
    ex.scan()
    ex.resolve_calls()
    acq = ex.may_acquire()
    edges = ex.lock_edges(acq)
    roots = ex.thread_roots()

    # ---- guarded_by ----
    root_reach = {label: ex.reachable(fids)
                  for label, fids in roots.items()}
    touched_by: dict = {}
    for fn in ex.fn_index.values():
        touched = set(fn.reads)
        touched.update(a for a, _h, _i in fn.writes)
        # global reads resolve late: a bare-name read of something any
        # function in this module global-writes counts as a touch.
        mod_globals = {a.split(".", 1)[1]
                       for f2 in fn.module.fns
                       for a, _h, _i in f2.writes
                       if a.startswith(f"{fn.module.stem}.")}
        touched.update(f"{fn.module.stem}.{n}"
                       for n in fn.raw_name_reads & mod_globals)
        touched_by[fn.id] = touched

    inherited = ex.inherited_held()
    attr_facts: dict = {}
    for fn in ex.fn_index.values():
        for attr_id, held, is_init in fn.writes:
            eff = frozenset(held) | inherited.get(fn.id, frozenset())
            f = attr_facts.setdefault(attr_id, {
                "locks": set(), "writes_guarded": 0,
                "writes_unguarded": 0, "writes_init": 0,
                "thread_roots": set()})
            if is_init:
                f["writes_init"] += 1
            elif eff:
                f["writes_guarded"] += 1
                f["locks"].update(eff)
            else:
                f["writes_unguarded"] += 1
    for label in sorted(root_reach):
        fids = root_reach[label]
        for fid in fids:
            for attr_id in touched_by.get(fid, ()):
                if attr_id in attr_facts:
                    attr_facts[attr_id]["thread_roots"].add(label)
    guarded_by = {
        "locks": {lid: dict(sorted(meta.items()))
                  for lid, meta in sorted(ex.lock_registry.items())},
        "attrs": {
            a: {"locks": sorted(f["locks"]),
                "writes_guarded": f["writes_guarded"],
                "writes_unguarded": f["writes_unguarded"],
                "writes_init": f["writes_init"],
                "thread_roots": sorted(f["thread_roots"])}
            for a, f in sorted(attr_facts.items())
            if f["writes_guarded"] or f["writes_unguarded"]},
    }

    # ---- lock_order ----
    edge_strs = sorted(f"{a} -> {b}" for a, b in edges)
    lock_order = {
        "edges": edge_strs,
        "cycles": find_cycles(edges),
        "order": topological_order(edges),
    }

    # ---- thread_lifecycle ----
    threads: dict = {}
    for fid in sorted(ex.fn_index):
        fn = ex.fn_index[fid]
        for i, site in enumerate(fn.thread_sites):
            sid = fid if len(fn.thread_sites) == 1 else f"{fid}#{i + 1}"
            name = site["name"]
            threads[sid] = {
                "name": name,
                "named_ok": bool(name) and name.startswith("dpsvm-"),
                "daemon": site["daemon"],
                "joined": bool(site["stored"]
                               and site["stored"]
                               in fn.module.joined_tails),
                "target": ".".join(site["target"] or ("?",)),
            }
    thread_lifecycle = {"threads": threads}

    # ---- seam_coverage ----
    handoffs = sorted({
        f"{fn.module.key}::{fn.qual}::{tail}.{meth}"
        for fn in ex.fn_index.values()
        for tail, meth in fn.handoffs})
    seam_coverage = {"seams": ex.seams, "handoffs": handoffs}

    return {
        "guarded_by": guarded_by,
        "lock_order": lock_order,
        "thread_lifecycle": thread_lifecycle,
        "seam_coverage": seam_coverage,
    }
