"""threadlint — concurrency-correctness static analysis of the port.

A copy of lightgbm_tpu/diagnostics/threadlint.py over the port's
package machinery (diagnostics/lint.py, torchlint); the four rules are
the JAX package's, with the blocking calls of torch in place of JAX's.

The reference C++ core gets its thread-safety story from OpenMP
structured parallelism; our serving tier replaced that with free-form
``threading`` — batcher flusher workers, registry writer locks, catalog
LRU scans, router health sweeps, telemetry sinks.  This linter rides
lint.py's package-wide AST call graph (``Package``) and marks the
CONCURRENT REGION the way ``FuncInfo.hot`` marks the per-tree
region: a *thread root* is every

- ``threading.Thread(target=...)`` construction site (a site inside a
  loop, or a ``ThreadPoolExecutor.submit`` fan-out, is a PLURAL root:
  many threads run the same entry point),
- HTTP handler class (``*RequestHandler`` / ``ThreadingHTTPServer``
  subclasses — one thread per connection, always plural),
- ``signal.signal`` handler (interleaves with everything else), and
- ``Condition`` waiter loop,

and everything reachable from a root through same-package calls is in
the concurrent region.  Four rules fire inside it:

- ``unguarded-shared-state`` — an instance attribute assigned
  (``self.x = ...`` / ``+=``) outside ``__init__`` from at least two
  distinct thread roots (or one plural root) where some write site
  holds no lock.  A write counts as guarded when it is lexically inside
  ``with <lock>:`` or carries a ``# guarded by <lock>`` annotation on
  its line or the line above (the documented convention for guards the
  lexical scan cannot see — a GIL-atomic flag, a caller-held lock).
- ``lock-order-cycle`` — the static lock-acquisition graph (which
  locks can be acquired while another is held, through calls) contains
  a cycle: two threads taking the edges in different orders deadlock.
  ``acquire(blocking=False)`` inserts no edge (a try-lock cannot
  deadlock).
- ``blocking-under-lock`` — socket/file I/O,
  ``torch.cuda.synchronize`` / a stream's or event's ``synchronize()``,
  ``Future.result()``, ``time.sleep``,
  ``subprocess``, or a timeout-less ``Condition.wait`` on a DIFFERENT
  lock, reachable with a known lock held: the hidden p99-stall and
  swap-starvation class (every waiter inherits the holder's stall).
- ``condition-misuse`` — ``Condition.wait`` whose nearest enclosing
  loop is not a ``while`` predicate loop (wakeups are spurious), or
  ``notify``/``notify_all`` without the condition held.

Suppressions use lint.py's reasoned grammar —
``# torchlint: allow(rule) — reason`` on the finding line or the line
above — and the shared reviewed allowlist
(scripts/lint_torch_allowlist.txt, ``path::rule::qualname — reason``).  The
runtime half is diagnostics/locksan.py: an instrumented-lock shim that
checks the SAME order-cycle property on the acquisitions the fleet
actually performs under load.

Known limits (by design, to stay a milliseconds-cheap stdlib gate):
writes through containers (``self.q.append``) and through foreign
objects (``other.registry.flag = ...``) are not tracked; a ``with`` on
an expression the tables cannot resolve counts as *some* guard for
shared-state purposes but never feeds the order graph or the
blocking rule.  Like lint.py, resolution is static and same-package.

Stdlib-only; scripts/run_torch_lint.py loads it by path beside lint.py.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

try:
    from . import lint as _lint
except ImportError:           # loaded by path (scripts/run_torch_lint.py)
    import importlib.util
    import sys
    _lint = sys.modules.get("torchlint")
    if _lint is None:
        _spec = importlib.util.spec_from_file_location(
            "torchlint",
            os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "lint.py"))
        _lint = importlib.util.module_from_spec(_spec)
        sys.modules["torchlint"] = _lint
        _spec.loader.exec_module(_lint)

Finding = _lint.Finding
FuncInfo = _lint.FuncInfo
ModuleInfo = _lint.ModuleInfo
Package = _lint.Package
load_allowlist = _lint.load_allowlist
stale_allowlist_entries = _lint.stale_allowlist_entries
_attr_chain = _lint._attr_chain
_callable_ref = _lint._callable_ref
_suppressions_for = _lint._suppressions_for

RULES = ("unguarded-shared-state", "lock-order-cycle",
         "blocking-under-lock", "condition-misuse")

# the `# guarded by <lock>` annotation convention (docs/Readme.md):
# names the guard the lexical scan cannot see
_GUARDED_RE = re.compile(r"#\s*guarded\s+by\s+(\S+)")

# lock-ish constructors: stdlib threading and the locksan factories
_LOCK_CTORS = {"Lock": "lock", "RLock": "lock", "Semaphore": "lock",
               "BoundedSemaphore": "lock", "Condition": "condition",
               "lock": "lock", "rlock": "lock", "condition": "condition"}
_LOCK_CTOR_BASES = {"threading", "locksan"}

_HANDLER_BASE_RE = re.compile(
    r"(RequestHandler|HTTPServer|ThreadingMixIn)$")

# methods whose names are too generic for the unique-method fallback
# (routinely invoked on stdlib/foreign objects; a package class
# happening to define one must not vacuum up every such call)
_FALLBACK_DENY = {
    "get", "put", "pop", "append", "items", "keys", "values", "update",
    "close", "read", "write", "start", "stop", "run", "join", "send",
    "recv", "flush", "acquire", "release", "wait", "notify",
    "notify_all", "result", "set", "clear", "copy", "add", "remove",
    # str/bytes/os.path methods: `s.split(",")` must not resolve to a
    # package method that happens to share the name (Tree.split)
    "split", "rsplit", "strip", "lstrip", "rstrip", "replace",
    "partition", "rpartition", "format", "encode", "decode", "lower",
    "upper", "startswith", "endswith", "splitlines", "count", "index",
    "find", "search", "match", "group", "sort", "insert", "extend",
}

_SOCKET_OPS = {"connect", "create_connection", "accept", "recv",
               "recv_into", "sendall", "makefile", "getaddrinfo"}


# ---------------------------------------------------------------------------
# per-module tables: classes, locks, conditions
# ---------------------------------------------------------------------------


class _ClassScan(ast.NodeVisitor):
    """Class qualnames, lock/condition attrs (``self.x = Lock()``
    anywhere in the class body), module-level locks, handler classes."""

    def __init__(self, mi: ModuleInfo):
        self.mi = mi
        self.stack: List[str] = []
        self.classes: Set[str] = set()
        # (classqual) -> {attr: "lock"|"condition"}
        self.class_locks: Dict[str, Dict[str, str]] = {}
        self.module_locks: Dict[str, str] = {}
        self.handler_classes: Set[str] = set()

    def _ctor_kind(self, value: ast.AST) -> Optional[str]:
        if not isinstance(value, ast.Call):
            return None
        chain = _attr_chain(value.func)
        if not chain or chain[-1] not in _LOCK_CTORS:
            return None
        if len(chain) > 1 and chain[0] not in _LOCK_CTOR_BASES:
            return None
        return _LOCK_CTORS[chain[-1]]

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        qual = ".".join(self.stack + [node.name])
        self.classes.add(qual)
        for base in node.bases:
            chain = _attr_chain(base)
            name = chain[-1] if chain else None
            if name and (_HANDLER_BASE_RE.search(name)
                         or name in self.handler_classes
                         or any(h.endswith("." + name) or h == name
                                for h in self.handler_classes)):
                self.handler_classes.add(qual)
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    def _visit_func(self, node) -> None:
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_Assign(self, node: ast.Assign) -> None:
        kind = self._ctor_kind(node.value)
        if kind is not None:
            for t in node.targets:
                if isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self":
                    cls = self._enclosing_class()
                    if cls is not None:
                        self.class_locks.setdefault(cls, {})[t.attr] = kind
                elif isinstance(t, ast.Name) and not self.stack:
                    self.module_locks[t.id] = kind
        self.generic_visit(node)

    def _enclosing_class(self) -> Optional[str]:
        # longest prefix of the current stack that names a known class
        for cut in range(len(self.stack), 0, -1):
            cand = ".".join(self.stack[:cut])
            if cand in self.classes:
                return cand
        return None


class _Tables:
    """Package-wide lock/condition/class tables + method index."""

    def __init__(self, pkg: Package):
        self.pkg = pkg
        self.scans: Dict[str, _ClassScan] = {}
        for mi in pkg.modules.values():
            sc = _ClassScan(mi)
            sc.visit(mi.tree)
            # second pass so handler subclasses declared before their
            # base (or of a same-module handler) are picked up
            sc.visit(mi.tree)
            self.scans[mi.name] = sc
        # unique package-wide method name -> FuncInfo (fallback
        # resolution for instance calls across modules)
        by_name: Dict[str, List[FuncInfo]] = {}
        for mi in pkg.modules.values():
            for fi in set(mi.funcs.values()):
                if "." in fi.qualname:
                    name = fi.qualname.rsplit(".", 1)[1]
                    if not name.startswith("__"):
                        by_name.setdefault(name, []).append(fi)
        self.unique_methods = {
            n: fs[0] for n, fs in by_name.items()
            if len(fs) == 1 and n not in _FALLBACK_DENY}

    def enclosing_class(self, mi: ModuleInfo, qual: str) -> Optional[str]:
        parts = qual.split(".")
        classes = self.scans[mi.name].classes
        for cut in range(len(parts) - 1, 0, -1):
            cand = ".".join(parts[:cut])
            if cand in classes:
                return cand
        return None

    def lock_id(self, mi: ModuleInfo, cls: Optional[str],
                expr: ast.AST) -> Tuple[Optional[str], bool]:
        """(lock id, is-guard) for a with-item / acquire receiver.
        A known lock/condition yields its id; an unresolvable bare
        Name/Attribute still counts as *a* guard (True) without an id."""
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self" and cls is not None:
            kinds = self.scans[mi.name].class_locks.get(cls, {})
            if expr.attr in kinds:
                return f"{mi.name}:{cls}.{expr.attr}", True
        if isinstance(expr, ast.Name):
            if expr.id in self.scans[mi.name].module_locks:
                return f"{mi.name}:{expr.id}", True
        if isinstance(expr, (ast.Name, ast.Attribute)):
            return None, True          # some context manager: a guard,
        return None, False             # but not a known lock

    def condition_attr(self, mi: ModuleInfo, cls: Optional[str],
                       expr: ast.AST) -> Optional[str]:
        """Lock id when ``expr`` names a known Condition attr."""
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self" and cls is not None:
            kinds = self.scans[mi.name].class_locks.get(cls, {})
            if kinds.get(expr.attr) == "condition":
                return f"{mi.name}:{cls}.{expr.attr}"
        if isinstance(expr, ast.Name) \
                and self.scans[mi.name].module_locks.get(expr.id) \
                == "condition":
            return f"{mi.name}:{expr.id}"
        return None

    def resolve_call(self, mi: ModuleInfo, qual: str,
                     func: ast.AST) -> Optional[FuncInfo]:
        """lint.py resolution plus the unique-method fallback: an
        attribute call whose method name is defined exactly once in the
        package resolves to it (cross-module instance calls —
        ``self.server._catalog.submit`` — are invisible to the exact
        resolver)."""
        target = self.pkg.resolve_callee(mi, qual, func)
        if target is not None:
            return target
        if isinstance(func, ast.Name):
            # class instantiation runs __init__ (Booster(model_file=...)
            # reads the model file — blocking the ctor does counts)
            fi = mi.funcs.get(f"{func.id}.__init__")
            if fi is not None:
                return fi
            if func.id in mi.imports:
                mod, nm = mi.imports[func.id]
                tmi = self.pkg.modules.get(mod)
                if tmi is not None:
                    return tmi.funcs.get(f"{nm}.__init__")
        if isinstance(func, ast.Attribute):
            return self.unique_methods.get(func.attr)
        return None


# ---------------------------------------------------------------------------
# thread roots + reachability
# ---------------------------------------------------------------------------


def _resolve_ref(tables: _Tables, mi: ModuleInfo, qual: str,
                 expr: ast.AST) -> Iterable[FuncInfo]:
    """FuncInfos a Thread target / submitted callable may name: a bare
    name or partial (lint.py's _fn_refs), a bound ``self.method``, or a
    lambda whose body hands package callables onward
    (``pool.map(lambda a: call_in_context(ctx, self._chunk, ...))``)."""
    for fn, _bound in tables.pkg._fn_refs(mi, expr):
        if fn is not None:
            yield fn
    if isinstance(expr, ast.Attribute) \
            and isinstance(expr.value, ast.Name) \
            and expr.value.id == "self":
        parts = qual.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            cand = ".".join(parts[:cut] + [expr.attr])
            if cand in mi.funcs:
                yield mi.funcs[cand]
                return
    if isinstance(expr, ast.Lambda):
        for node in ast.walk(expr.body):
            if isinstance(node, ast.Call):
                target = tables.resolve_call(mi, qual, node.func)
                if target is not None:
                    yield target
                for arg in node.args:
                    if isinstance(arg, (ast.Name, ast.Attribute)):
                        yield from _resolve_ref(tables, mi, qual, arg)


def _collect_roots(tables: _Tables
                   ) -> List[Tuple[str, bool, FuncInfo]]:
    """(root key, plural, entry FuncInfo) for every thread root."""
    pkg = tables.pkg
    roots: List[Tuple[str, bool, FuncInfo]] = []

    def walk(node: ast.AST, fi: FuncInfo, mi: ModuleInfo,
             in_loop: bool) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                continue               # nested defs analyzed separately
            loop = in_loop or isinstance(
                child, (ast.For, ast.While, ast.ListComp, ast.SetComp,
                        ast.GeneratorExp, ast.DictComp))
            if isinstance(child, ast.Call):
                chain = _attr_chain(child.func)
                if chain and chain[-1] == "Thread" \
                        and (len(chain) == 1 or chain[0] == "threading"):
                    for kw in child.keywords:
                        if kw.arg == "target":
                            for fn in _resolve_ref(tables, mi,
                                                   fi.qualname, kw.value):
                                roots.append((
                                    f"thread:{mi.name}.{fi.qualname}"
                                    f"@{child.lineno}", loop, fn))
                elif isinstance(child.func, ast.Attribute) \
                        and child.func.attr in ("submit", "map") \
                        and child.args:
                    for fn in _resolve_ref(tables, mi, fi.qualname,
                                           child.args[0]):
                        roots.append((
                            f"pool:{mi.name}.{fi.qualname}"
                            f"@{child.lineno}", True, fn))
                elif chain and chain[-1] == "signal" \
                        and chain[0] == "signal" and len(child.args) >= 2:
                    for fn in _resolve_ref(tables, mi, fi.qualname,
                                           child.args[1]):
                        roots.append((
                            f"signal:{mi.name}.{fi.qualname}"
                            f"@{child.lineno}", False, fn))
            walk(child, fi, mi, loop)

    for mi in pkg.modules.values():
        sc = tables.scans[mi.name]
        for fi in set(mi.funcs.values()):
            walk(fi.node, fi, mi, in_loop=False)
            # Condition waiter loops are entry points of the concurrent
            # region in their own right (a waiter parks mid-function)
            cls = tables.enclosing_class(mi, fi.qualname)
            for node in ast.walk(fi.node):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "wait" \
                        and tables.condition_attr(
                            mi, cls, node.func.value) is not None:
                    roots.append((f"waiter:{mi.name}.{fi.qualname}",
                                  False, fi))
                    break
        # every method of an HTTP handler class serves on its own
        # connection thread — all of them are plural roots
        for cls in sorted(sc.handler_classes):
            for fi in set(mi.funcs.values()):
                if fi.qualname.startswith(cls + ".") \
                        and "." not in fi.qualname[len(cls) + 1:]:
                    roots.append((f"handler:{mi.name}.{cls}", True, fi))
    return roots


def _call_graphs(tables: _Tables,
                 funcs: Dict[int, Tuple[ModuleInfo, FuncInfo]]
                 ) -> Tuple[Dict[int, List[FuncInfo]],
                            Dict[int, List[FuncInfo]]]:
    """One AST pass per function: (strict call targets, those plus
    callables handed onward — pool submits, callbacks).  The strict
    graph feeds the lock-effect fixpoint; the wide one feeds thread
    reachability."""
    pkg = tables.pkg
    strict: Dict[int, List[FuncInfo]] = {}
    wide: Dict[int, List[FuncInfo]] = {}
    for i, (mi, fi) in funcs.items():
        outs: List[FuncInfo] = []
        extra: List[FuncInfo] = []
        for node in ast.walk(fi.node):
            if not isinstance(node, ast.Call):
                continue
            target = tables.resolve_call(mi, fi.qualname, node.func)
            if target is not None:
                outs.append(target)
            for arg in node.args:
                extra.extend(_resolve_ref(tables, mi, fi.qualname, arg))
            ref = _callable_ref(node)
            if ref is not None:
                fn = pkg.resolve(mi.name, ref[0])
                if fn is not None:
                    extra.append(fn)
        strict[i] = outs
        wide[i] = outs + extra
    return strict, wide


def _reachability(wide: Dict[int, List[FuncInfo]],
                  roots: List[Tuple[str, bool, FuncInfo]]
                  ) -> Tuple[Dict[int, Set[str]], Set[str]]:
    """id(FuncInfo) -> set of root keys reaching it; plural root keys."""
    reach: Dict[int, Set[str]] = {}
    plural: Set[str] = set()
    for key, is_plural, entry in roots:
        if is_plural:
            plural.add(key)
        stack = [entry]
        while stack:
            fi = stack.pop()
            seen = reach.setdefault(id(fi), set())
            if key in seen:
                continue
            seen.add(key)
            stack.extend(wide.get(id(fi), ()))
    return reach, plural


# ---------------------------------------------------------------------------
# lock effects: transitive acquires, transitive blocking
# ---------------------------------------------------------------------------


def _blocking_kind(mi: ModuleInfo, node: ast.Call) -> Optional[str]:
    """Name of the blocking operation this call performs, or None.
    Timeout-less Condition.wait is handled separately (it needs held-
    lock context)."""
    if isinstance(node.func, ast.Name):
        if node.func.id == "open":
            return "file I/O (open)"
        if node.func.id == "sleep" \
                and mi.imports.get("sleep", ("", ""))[0] == "time":
            return "time.sleep"
        return None
    chain = _attr_chain(node.func)
    if not chain:
        return None
    if chain == ("time", "sleep"):
        return "time.sleep"
    if chain[-1] == "synchronize" and (chain[0] == "torch"
                                       or len(chain) > 1):
        return "synchronize() (waits for the device)"
    if chain[-1] == "result":
        return "Future.result"
    if chain[-1] in _SOCKET_OPS:
        return f"socket I/O (.{chain[-1]})"
    if chain[0] == "subprocess":
        return f"subprocess.{chain[-1]}"
    if chain[-1] == "urlopen":
        return "urllib urlopen"
    if chain[-1] == "join" and not node.args and not node.keywords:
        return "thread join"
    return None


class _FuncEffects:
    """Per-function lexical walk results."""

    def __init__(self) -> None:
        self.acquires: Set[str] = set()          # direct known locks
        self.blocking: List[Tuple[int, str]] = []  # direct, any context
        # (held-lock, acquired-lock, line) lexical nesting edges
        self.edges: List[Tuple[str, str, int]] = []
        # (line, kind, held-lock) blocking ops under a KNOWN lock
        self.blocked_under: List[Tuple[int, str, str]] = []
        # (line, callee FuncInfo, held-locks tuple) calls under a lock
        self.calls_under: List[Tuple[int, FuncInfo, Tuple[str, ...]]] = []
        # write sites: (attr, line, guarded)
        self.writes: List[Tuple[str, int, bool]] = []
        # condition misuse: (line, message)
        self.cond_misuse: List[Tuple[int, str]] = []


def _scan_function(tables: _Tables, mi: ModuleInfo,
                   fi: FuncInfo) -> _FuncEffects:
    cls = tables.enclosing_class(mi, fi.qualname)
    eff = _FuncEffects()

    def guarded_by_annotation(lineno: int) -> bool:
        for ln in (lineno, lineno - 1):
            if 1 <= ln <= len(mi.lines) \
                    and _GUARDED_RE.search(mi.lines[ln - 1]):
                return True
        return False

    def handle_call(node: ast.Call, held: Tuple[str, ...],
                    any_guard: bool, loops: Tuple[str, ...]) -> None:
        # --- acquisition events (with-less .acquire) ---
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr == "acquire":
            nonblocking = any(
                kw.arg == "blocking" and isinstance(kw.value, ast.Constant)
                and kw.value.value is False for kw in node.keywords) \
                or (node.args and isinstance(node.args[0], ast.Constant)
                    and node.args[0].value is False)
            lock, _ = tables.lock_id(mi, cls, node.func.value)
            if lock is not None and not nonblocking:
                eff.acquires.add(lock)
                for h in held:
                    if h != lock:
                        eff.edges.append((h, lock, node.lineno))
            return
        # --- condition rules ---
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("wait", "notify", "notify_all"):
            cond = tables.condition_attr(mi, cls, node.func.value)
            if cond is not None:
                if node.func.attr == "wait":
                    if not loops or loops[-1] != "while":
                        eff.cond_misuse.append((
                            node.lineno,
                            "Condition.wait not inside a while-predicate "
                            "loop: wakeups are spurious and the predicate "
                            "must be re-checked before proceeding"))
                    timeout_less = not node.args and not node.keywords
                    others = [h for h in held if h != cond]
                    if timeout_less and others:
                        eff.blocked_under.append((
                            node.lineno,
                            "timeout-less Condition.wait", others[-1]))
                else:
                    if cond not in held:
                        eff.cond_misuse.append((
                            node.lineno,
                            f"{node.func.attr}() without holding the "
                            "condition: a waiter checking its predicate "
                            "concurrently can miss the wakeup"))
                return
        # --- blocking ops ---
        kind = _blocking_kind(mi, node)
        if kind is not None:
            eff.blocking.append((node.lineno, kind))
            if held:
                eff.blocked_under.append((node.lineno, kind, held[-1]))
            return
        # --- calls: order edges + blocking through callees ---
        target = tables.resolve_call(mi, fi.qualname, node.func)
        if target is not None and held:
            eff.calls_under.append((node.lineno, target, held))

    def walk(node: ast.AST, held: Tuple[str, ...], any_guard: bool,
             loops: Tuple[str, ...]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                continue
            c_held, c_guard, c_loops = held, any_guard, loops
            if isinstance(child, ast.With):
                for item in child.items:
                    lock, is_guard = tables.lock_id(
                        mi, cls, item.context_expr)
                    if lock is not None:
                        eff.acquires.add(lock)
                        for h in c_held:
                            if h != lock:
                                eff.edges.append((h, lock, child.lineno))
                        c_held = c_held + (lock,)
                        c_guard = True
                    elif is_guard:
                        c_guard = True
            elif isinstance(child, ast.While):
                c_loops = loops + ("while",)
            elif isinstance(child, ast.For):
                c_loops = loops + ("for",)
            elif isinstance(child, ast.Call):
                handle_call(child, c_held, c_guard, c_loops)
            elif isinstance(child, (ast.Assign, ast.AugAssign)):
                targets = (child.targets if isinstance(child, ast.Assign)
                           else [child.target])
                for t in targets:
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == "self":
                        g = (bool(c_held) or c_guard
                             or guarded_by_annotation(child.lineno))
                        eff.writes.append((t.attr, child.lineno, g))
            walk(child, c_held, c_guard, c_loops)

    walk(fi.node, (), False, ())
    return eff


# ---------------------------------------------------------------------------
# rule evaluation over the whole package
# ---------------------------------------------------------------------------


def _transitive(strict: Dict[int, List[FuncInfo]],
                effects: Dict[int, _FuncEffects],
                funcs: Dict[int, Tuple[ModuleInfo, FuncInfo]]
                ) -> Tuple[Dict[int, Set[str]], Dict[int, Optional[str]]]:
    """(transitive lock-acquire sets, transitive blocking kind) per
    function — fixpoint over the call graph."""
    acq: Dict[int, Set[str]] = {i: set(e.acquires)
                                for i, e in effects.items()}
    blk: Dict[int, Optional[str]] = {
        i: (e.blocking[0][1] if e.blocking else None)
        for i, e in effects.items()}
    callees: Dict[int, List[int]] = {
        i: [id(t) for t in outs if id(t) in effects]
        for i, outs in strict.items()}
    changed = True
    while changed:
        changed = False
        for i, outs in callees.items():
            for j in outs:
                if not acq[j] <= acq[i]:
                    acq[i] |= acq[j]
                    changed = True
                if blk[i] is None and blk[j] is not None:
                    qual = funcs[j][1].qualname
                    blk[i] = f"{blk[j]} via {qual}"
                    changed = True
    return acq, blk


def _run_rules(pkg: Package) -> List[Finding]:
    tables = _Tables(pkg)
    funcs: Dict[int, Tuple[ModuleInfo, FuncInfo]] = {}
    effects: Dict[int, _FuncEffects] = {}
    for mi in pkg.modules.values():
        for fi in set(mi.funcs.values()):
            if id(fi) not in effects:
                funcs[id(fi)] = (mi, fi)
                effects[id(fi)] = _scan_function(tables, mi, fi)
    strict, wide = _call_graphs(tables, funcs)
    roots = _collect_roots(tables)
    reach, plural = _reachability(wide, roots)
    acq, blk = _transitive(strict, effects, funcs)

    findings: List[Finding] = []

    # ---- unguarded-shared-state --------------------------------------
    # group write sites per (module, class, attr)
    writes: Dict[Tuple[str, str, str],
                 List[Tuple[ModuleInfo, FuncInfo, int, bool]]] = {}
    for i, (mi, fi) in funcs.items():
        name = fi.qualname.rsplit(".", 1)[-1]
        if name in ("__init__", "__new__", "__post_init__"):
            continue
        cls = tables.enclosing_class(mi, fi.qualname)
        if cls is None:
            continue
        # handler instances are per-connection (one thread each):
        # attributes on the handler itself are thread-local state
        if cls in tables.scans[mi.name].handler_classes:
            continue
        for attr, line, guarded in effects[i].writes:
            writes.setdefault((mi.name, cls, attr), []).append(
                (mi, fi, line, guarded))
    for (mod, cls, attr), sites in sorted(writes.items()):
        site_roots: Set[str] = set()
        for _mi, fi, _line, _g in sites:
            site_roots |= reach.get(id(fi), set())
        shared = (len(site_roots) >= 2
                  or bool(site_roots & plural))
        if not shared:
            continue
        for mi, fi, line, guarded in sites:
            if guarded or not reach.get(id(fi)):
                continue
            ex = sorted(site_roots)[0]
            findings.append(Finding(
                mi.path, line, "unguarded-shared-state",
                f"'self.{attr}' is written from {len(site_roots)} thread "
                f"root(s) (e.g. {ex}) with no lock held at this write; "
                "take the class lock, or annotate '# guarded by <lock>' "
                "naming the guard the scan cannot see",
                fi.qualname))

    # ---- lock-order-cycle --------------------------------------------
    # graph: lexical nesting edges + (held -> callee's transitive
    # acquires) at every call made with a lock held
    edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}
    for i, (mi, fi) in funcs.items():
        for a, b, line in effects[i].edges:
            edges.setdefault((a, b), (mi.path, line, fi.qualname))
        for line, target, held in effects[i].calls_under:
            for b in acq.get(id(target), ()):
                for a in held:
                    if a != b:
                        edges.setdefault((a, b),
                                         (mi.path, line, fi.qualname))
    graph: Dict[str, Set[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)

    def path_between(src: str, dst: str) -> Optional[List[str]]:
        seen = {src}
        trail = [[src]]
        while trail:
            cur = trail.pop()
            if cur[-1] == dst:
                return cur
            for nxt in sorted(graph.get(cur[-1], ())):
                if nxt not in seen:
                    seen.add(nxt)
                    trail.append(cur + [nxt])
        return None

    reported: Set[frozenset] = set()
    for (a, b) in sorted(edges):
        back = path_between(b, a)
        if back is None:
            continue
        cyc = frozenset(back)
        if cyc in reported:
            continue
        reported.add(cyc)
        path, line, qual = edges[(a, b)]
        loop = " -> ".join([a, b] + back[1:])
        findings.append(Finding(
            path, line, "lock-order-cycle",
            f"lock acquisition order cycle: {loop}; threads taking "
            "these locks in different orders can deadlock — pick one "
            "global order (document it where the locks are created)",
            qual))

    # ---- blocking-under-lock -----------------------------------------
    for i, (mi, fi) in funcs.items():
        if not reach.get(i):
            continue               # outside the concurrent region
        for line, kind, lock in effects[i].blocked_under:
            findings.append(Finding(
                mi.path, line, "blocking-under-lock",
                f"{kind} while holding {lock}: every thread queued on "
                "that lock inherits this stall (p99/liveness hazard); "
                "move the slow work outside the critical section",
                fi.qualname))
        for line, target, held in effects[i].calls_under:
            tb = blk.get(id(target))
            if tb is None:
                continue
            findings.append(Finding(
                mi.path, line, "blocking-under-lock",
                f"call into {target.qualname} (does {tb}) while holding "
                f"{held[-1]}: every thread queued on that lock inherits "
                "the stall; move the slow work outside the critical "
                "section", fi.qualname))

    # ---- condition-misuse --------------------------------------------
    for i, (mi, fi) in funcs.items():
        if not reach.get(i):
            continue
        for line, msg in effects[i].cond_misuse:
            findings.append(Finding(
                mi.path, line, "condition-misuse", msg, fi.qualname))

    return findings


# ---------------------------------------------------------------------------
# entry points (lint.py's lint_run/lint_paths contract)
# ---------------------------------------------------------------------------


def lint_run(paths: Sequence[str], root: str,
             allowlist: Optional[Dict[Tuple[str, str, str], str]] = None,
             used_allowlist: Optional[Set[Tuple[str, str, str]]] = None,
             check_stale: bool = True
             ) -> Tuple[List[Finding], List[str]]:
    """Run the threadlint rules over `paths`; returns (unsuppressed
    findings, stale allowlist entries).  Suppressions use the shared
    ``# torchlint: allow(rule) — reason`` grammar; reason-less
    suppressions surface as ``suppression`` findings, exactly like
    lint.py.  The stale audit only judges threadlint-rule entries
    (lint.py audits its own) and, like lint.py, is only valid on
    whole-package runs."""
    pkg = Package(root)
    for p in paths:
        if os.path.isdir(p):
            pkg.add_tree(p)
        else:
            pkg.add_file(p)
    allowlist = allowlist or {}
    used: Set[Tuple[str, str, str]] = (used_allowlist
                                      if used_allowlist is not None
                                      else set())
    raw = _run_rules(pkg)

    seen: Set[Tuple[str, int, str, str]] = set()
    findings: List[Finding] = []
    for f in sorted(raw, key=lambda f: (f.path, f.line, f.rule)):
        key = (f.path, f.line, f.rule, f.message)
        if key in seen:
            continue
        seen.add(key)
        mi = next(m for m in pkg.modules.values() if m.path == f.path)
        sup = _suppressions_for(mi.lines, f.line)
        if sup is not None and f.rule in sup[0]:
            if not sup[1]:
                findings.append(Finding(
                    f.path, f.line, "suppression",
                    f"torchlint: allow({f.rule}) has no reason; "
                    "suppressions must say why (\"# torchlint: "
                    "allow(rule) — reason\")", f.qualname))
            continue
        wl = allowlist.get((f.path, f.rule, f.qualname))
        if wl is not None:
            used.add((f.path, f.rule, f.qualname))
            if wl:
                continue
            findings.append(Finding(
                f.path, f.line, "suppression",
                "allowlist entry has no reason", f.qualname))
            continue
        findings.append(f)
    stale: List[str] = []
    if check_stale:
        mine = {k: v for k, v in allowlist.items() if k[1] in RULES}
        linted = {m.path for m in pkg.modules.values()}
        stale = stale_allowlist_entries(mine, used, linted, root)
    return findings, stale


def lint_paths(paths: Sequence[str], root: str,
               allowlist: Optional[Dict[Tuple[str, str, str], str]] = None,
               used_allowlist: Optional[Set[Tuple[str, str, str]]] = None
               ) -> List[Finding]:
    findings, _stale = lint_run(paths, root, allowlist,
                                used_allowlist=used_allowlist,
                                check_stale=False)
    return findings
