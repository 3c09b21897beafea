"""torchlint: AST static checks for the port's PyTorch hazards.

The port of lightgbm_tpu/diagnostics/lint.py.  The package machinery
(`Finding`, `FuncInfo`, `ModuleInfo`, the module indexer, `Package` and
its same-package call resolution, the reasoned suppressions, the
reviewed allowlist and its stale-entry audit, `lint_paths`/`lint_run`)
is a copy, standard library only.  The JAX rules key on traced JAX
regions, which the port does not have, so the rule set is the port's
own: each rule names a hazard that costs a torch program on the card.

Rules
-----
- ``host-sync``: a device-to-host read inside the per-tree loops.
  ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``torch.cuda.synchronize()``; ``float()``/``int()``/``bool()`` of a
  tensor; a tensor as the test of ``if``/``while``/``assert`` (an
  implicit ``__bool__``, the same read).  Each stalls the host until the
  device has drained its queue, the static side of
  ``diagnostics/sanitize.HotPathSanitizer`` (which catches the reads
  the scan cannot see at run time).  The scan covers the functions
  reachable, through same-package calls, from the learners' per-tree
  entry points in ``HOT_ROOTS``.  Tensors are found by a local
  dataflow: names assigned from ``torch.*`` calls, from methods of
  tensors, from arithmetic and indexing over tensors, and attributes
  the package assigns only from ``torch.*`` calls.
- ``nondeterminism``: run-to-run differences.  A float
  ``index_add_``/``scatter_add_``/``index_put_(accumulate=True)``
  (float atomics on CUDA add in a different order each run: ROADMAP.md
  §C fault 5), unless the values are known integers; a
  ``torch.rand``/``randn``/``randint``/``randperm``/``normal``/
  ``bernoulli``/``multinomial`` draw with no explicit ``generator=``
  (the global generator's state is shared by every caller); a
  ``time.*`` clock reading fed into a tensor.  Package-wide.
- ``divergent-collective``: an ``if`` whose test reads the rank
  (``rank``, ``.rank``, ``get_rank()``, ``rank_rows``) where one branch
  performs a collective and the other does not: the ranks that skip it
  leave the others waiting in it forever.  Collectives are
  ``torch.distributed`` calls, the collectives of the mesh layer
  (methods of ``sharded/mesh.py``'s ``Mesh`` and ``HistExchange``, and
  ``distributed.py``'s functions, that call ``torch.distributed``), and
  any same-package function that reaches one.  Package-wide.
- ``collective-mismatch``: a literal axis name given to a mesh method
  (``psum``, ``pmax``, ``psum_scatter``, ``all_gather``, ``size``,
  ``index``, ``group_size``) that is not in ``sharded/mesh.py``'s
  ``AXES``.  It stands down when the linted tree defines no ``AXES``.

The JAX rules the port has nothing for:

- ``retrace-hazard``: torch runs eagerly; there is no traced program to
  retrace.  A kernel built after warm-up is the analogue, counted at run
  time by ``HotPathSanitizer`` (``sanitize/compiles_total``).
- ``dtype-drift``: there is no x64 switch that silently narrows
  float64; every tensor carries its dtype, and the float64 in the port
  is host arithmetic on purpose (the f64 shrink of host trees).
- ``scatter-divisibility``: ``Mesh.psum_scatter`` calls
  ``check_scatter_divisible`` itself before the collective, so no call
  site can reach a shape error inside it.
- ``replication-leak``: no traced predicate carries a shard-local value;
  the control flow that ranks could take apart is the rank test that
  ``divergent-collective`` reads, and ``DivergenceSanitizer`` checks
  the grown trees at run time.

Suppressions
------------
Inline, on the finding line or the line above, with a REQUIRED reason::

    host = torch.cat(payload).tolist()  # torchlint: allow(host-sync) — why

or a reviewed allowlist entry (``path::rule::qualname — reason``) in
``scripts/lint_torch_allowlist.txt``.  A suppression without a reason is
a finding itself; an allowlist entry that no longer matches a finding is
stale and fails the run.

Run: ``python scripts/run_torch_lint.py`` (nonzero exit on findings);
tests/test_torch_lint_clean.py runs it.
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

RULES = ("host-sync", "nondeterminism", "divergent-collective",
         "collective-mismatch")

# The learners' per-tree entry points: (module suffix, qualname).  A
# module matches when its dotted name ends with the suffix, so the same
# roots apply to the package however it is rooted.
HOT_ROOTS = (
    ("learner.rounds", "RoundsTreeLearner.train_device"),
    ("learner.rounds", "RoundsTreeLearner.train"),
    ("learner.fused", "FusedTreeLearner.train"),
    ("learner.fused", "build_tree"),
    ("learner.serial", "SerialTreeLearner.train"),
    ("boosting.gbdt", "GBDT._train_device_tree"),
    ("boosting.gbdt", "GBDT._train_class_tree"),
)

# modules whose torch.distributed-calling functions are the collectives
# of the mesh layer
COLLECTIVE_MODULES = ("sharded.mesh", "distributed")

_SUPPRESS_RE = re.compile(
    r"#\s*torchlint:\s*allow\(\s*([a-z-]+(?:\s*,\s*[a-z-]+)*)\s*\)"
    r"\s*(?:[-—–:]+\s*)?(.*)")

# tensor methods that read the device into host memory
_READ_METHODS = {"item", "tolist", "cpu", "numpy"}
# the two that numpy arrays share (a host array's .item() is no read)
_SHARED_WITH_NUMPY = {"item", "tolist"}
# torch.* calls that return host values
_TORCH_HOST_CALLS = {"device", "dtype", "get_num_threads", "is_tensor",
                     "is_floating_point", "finfo", "iinfo", "Size",
                     "is_available", "device_count", "get_device_name",
                     "manual_seed", "Generator", "get_default_dtype",
                     "set_num_threads", "no_grad", "inference_mode"}
# tensor methods that return host values without reading the data
_HOST_METHODS = {"numel", "dim", "size", "stride", "data_ptr",
                 "is_contiguous", "element_size", "nelement", "get_device",
                 "is_floating_point", "is_complex", "storage_offset",
                 "type", "__len__"}
# torch.* attributes that are not tensors
_HOST_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "itemsize",
               "element_size", "layout", "requires_grad"}
_INT_DTYPES = {"int8", "int16", "int32", "int64", "uint8", "long", "int",
               "short", "bool"}
_ACCUM_METHODS = {"index_add_", "scatter_add_", "index_add", "scatter_add"}
_RANDOM_CALLS = {"rand", "randn", "randint", "randperm", "normal",
                 "bernoulli", "multinomial", "rand_like", "randn_like",
                 "randint_like", "poisson"}
# torch.distributed calls that are collectives (every rank of the group
# must enter them)
_DIST_COLLECTIVES = {"all_reduce", "all_gather", "all_gather_into_tensor",
                     "all_gather_object", "reduce_scatter",
                     "reduce_scatter_tensor", "broadcast",
                     "broadcast_object_list", "barrier", "reduce",
                     "gather", "scatter", "all_to_all",
                     "all_to_all_single", "send", "recv", "new_group"}
# mesh methods taking axis names: method -> position of the axis argument
_AXIS_ARG = {"psum": 1, "pmax": 1, "psum_scatter": 1, "all_gather": 1,
             "size": 0, "index": 0, "group_size": 0}


@dataclass
class Finding:
    path: str            # repo-relative
    line: int
    rule: str
    message: str
    qualname: str        # enclosing function ('<module>' at top level)

    def render(self) -> str:
        return (f"{self.path}:{self.line}: {self.rule}: {self.message} "
                f"[in {self.qualname}]")


@dataclass(eq=False)          # identity hash: one node, one entry
class FuncInfo:
    module: str
    qualname: str
    node: ast.AST                      # FunctionDef / AsyncFunctionDef
    params: Tuple[str, ...]
    hot: bool = False                  # reachable from a per-tree root


@dataclass
class ModuleInfo:
    name: str
    path: str                          # repo-relative
    tree: ast.Module
    lines: List[str]
    funcs: Dict[str, FuncInfo] = field(default_factory=dict)
    # local name -> (module, name) for from-imports; name -> module for
    # module imports/aliases
    imports: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    mod_aliases: Dict[str, str] = field(default_factory=dict)
    # attribute names assigned from torch.* calls anywhere in the module
    # (`self.score = torch.zeros(...)`), and those assigned host values
    # (`self.label = np.asarray(...)`): a name in both is ambiguous and
    # leaves the package-wide registry
    tensor_attrs: Set[str] = field(default_factory=set)
    host_attrs: Set[str] = field(default_factory=set)


def _attr_chain(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """('torch','cuda','synchronize') for torch.cuda.synchronize; None
    otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def _tensor_chain(chain: Optional[Tuple[str, ...]]) -> bool:
    """True when a call through this chain returns a tensor:
    torch.* constructors and ops, torch.nn.functional.*."""
    if not chain or chain[0] != "torch" or len(chain) < 2:
        return False
    if chain[1] in ("cuda", "distributed", "backends", "utils", "profiler",
                    "testing", "autograd", "jit", "library"):
        return False
    return chain[-1] not in _TORCH_HOST_CALLS


def _module_name_for(path: str, root: str) -> str:
    rel = os.path.relpath(path, root)
    mod = rel[:-3].replace(os.sep, ".")
    if mod.endswith(".__init__"):
        mod = mod[: -len(".__init__")]
    return mod


def _resolve_relative(module: str, node: ast.ImportFrom) -> Optional[str]:
    if node.level == 0:
        return node.module
    parts = module.split(".")
    if node.level > len(parts):
        return None
    base = parts[: len(parts) - node.level]
    if node.module:
        base = base + node.module.split(".")
    return ".".join(base) if base else None


def _module_matches(module: str, suffix: str) -> bool:
    return module == suffix or module.endswith("." + suffix)


class _ModuleIndexer(ast.NodeVisitor):
    """Pass 1: function defs, imports, local aliases, attribute kinds."""

    def __init__(self, mi: ModuleInfo):
        self.mi = mi
        self.stack: List[str] = []
        # local aliases: name -> (funcname, partial-bound names | None)
        self.aliases: Dict[str, Tuple[str, Optional[Set[str]]]] = {}

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            self.mi.mod_aliases[a.asname or a.name.split(".")[0]] = a.name

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        src = _resolve_relative(self.mi.name, node)
        if src is None:
            return
        for a in node.names:
            if a.name == "*":
                continue
            self.mi.imports[a.asname or a.name] = (src, a.name)

    def _visit_func(self, node) -> None:
        qual = ".".join(self.stack + [node.name])
        params = tuple(
            a.arg for a in (node.args.posonlyargs + node.args.args
                            + node.args.kwonlyargs))
        fi = FuncInfo(self.mi.name, qual, node, params)
        self.mi.funcs[qual] = fi
        # bare-name index for intra-module resolution (top level shadows
        # nested helpers of the same name)
        self.mi.funcs.setdefault(node.name, fi)
        if self.mi.funcs[node.name].qualname != qual and "." not in qual:
            self.mi.funcs[node.name] = fi
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    def visit_Assign(self, node: ast.Assign) -> None:
        if len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            ref = _callable_ref(node.value)
            if ref is not None:
                self.aliases[node.targets[0].id] = ref
        if isinstance(node.value, ast.Call):
            chain = _attr_chain(node.value.func)
            kind = ("tensor" if _tensor_chain(chain) else
                    "host" if chain and chain[0] in ("np", "numpy")
                    else None)
            for t in node.targets:
                if isinstance(t, ast.Attribute) and kind == "tensor":
                    self.mi.tensor_attrs.add(t.attr)
                elif isinstance(t, ast.Attribute) and kind == "host":
                    self.mi.host_attrs.add(t.attr)
        self.generic_visit(node)


def _callable_ref(expr: ast.AST) -> Optional[Tuple[str, Optional[Set[str]]]]:
    """(function-name, bound names) when `expr` is a bare function
    reference or functools.partial(fn, ...); bound names is None when a
    ``**kw`` splat hides them."""
    if isinstance(expr, ast.Name):
        return (expr.id, set())
    if isinstance(expr, ast.Call):
        chain = _attr_chain(expr.func)
        if chain and chain[-1] == "partial" and expr.args:
            inner = expr.args[0]
            if isinstance(inner, ast.Name):
                bound: Optional[Set[str]] = set()
                for kw in expr.keywords:
                    if kw.arg is None:
                        bound = None
                        break
                    bound.add(kw.arg)
                return (inner.id, bound)
    return None


class Package:
    """Parsed package and its same-package call graph."""

    def __init__(self, root: str):
        self.root = root
        self.modules: Dict[str, ModuleInfo] = {}
        # module -> {local name: (function name, partial-bound names)}
        self._alias_maps: Dict[str, Dict[str, Tuple]] = {}
        self._coll_memo: Dict[int, bool] = {}

    # -- loading --------------------------------------------------------
    def add_file(self, path: str) -> None:
        with open(path) as fh:
            src = fh.read()
        mod = _module_name_for(path, self.root)
        mi = ModuleInfo(mod, os.path.relpath(path, self.root),
                        ast.parse(src, filename=path), src.splitlines())
        ix = _ModuleIndexer(mi)
        ix.visit(mi.tree)
        self.modules[mod] = mi
        self._alias_maps[mod] = ix.aliases

    def add_tree(self, pkg_dir: str) -> None:
        for dirpath, _dirs, files in os.walk(pkg_dir):
            for f in sorted(files):
                if f.endswith(".py"):
                    self.add_file(os.path.join(dirpath, f))

    def tensor_attrs(self) -> Set[str]:
        """Package-wide attribute names assigned ONLY from torch.* calls
        (an attribute some class also assigns a numpy value is
        ambiguous across objects and left out)."""
        if not hasattr(self, "_tensor_attrs"):
            dev: Set[str] = set()
            host: Set[str] = set()
            for mi in self.modules.values():
                dev |= mi.tensor_attrs
                host |= mi.host_attrs
            self._tensor_attrs = dev - host
        return self._tensor_attrs

    def mesh_axes(self) -> Set[str]:
        """The string literals of `AXES = (...)` in the mesh module;
        empty when the linted tree has none."""
        if not hasattr(self, "_mesh_axes"):
            axes: Set[str] = set()
            for mi in self.modules.values():
                if not _module_matches(mi.name, "sharded.mesh"):
                    continue
                for node in mi.tree.body:
                    if (isinstance(node, ast.Assign)
                            and any(isinstance(t, ast.Name)
                                    and t.id == "AXES"
                                    for t in node.targets)):
                        axes |= {n.value for n in ast.walk(node.value)
                                 if isinstance(n, ast.Constant)
                                 and isinstance(n.value, str)}
            self._mesh_axes = axes
        return self._mesh_axes

    # -- resolution -----------------------------------------------------
    def resolve(self, module: str, name: str) -> Optional[FuncInfo]:
        mi = self.modules.get(module)
        if mi is None:
            return None
        if name in mi.funcs:
            return mi.funcs[name]
        if name in mi.imports:
            src_mod, src_name = mi.imports[name]
            if src_mod != module:
                return self.resolve(src_mod, src_name)
        alias = self._alias_maps.get(module, {}).get(name)
        if alias is not None and alias[0] != name:
            return self.resolve(module, alias[0])
        return None

    def resolve_callee(self, mi: ModuleInfo, qual: str,
                       func: ast.AST) -> Optional[FuncInfo]:
        """Resolve a Call callee to a package FuncInfo: bare name,
        self.method, or imported-module attribute."""
        if isinstance(func, ast.Name):
            return self.resolve(mi.name, func.id)
        chain = _attr_chain(func)
        if not chain or len(chain) != 2:
            return None
        base, attr = chain
        if base == "self":
            parts = qual.split(".")
            for cut in range(len(parts) - 1, 0, -1):
                cand = ".".join(parts[:cut] + [attr])
                if cand in mi.funcs:
                    return mi.funcs[cand]
            return None
        if base in mi.mod_aliases:
            return self.resolve(mi.mod_aliases[base], attr)
        if base in mi.imports:          # `from .ops import histogram as H`
            src_mod, src_name = mi.imports[base]
            return self.resolve(f"{src_mod}.{src_name}", attr)
        return None

    def _fn_refs(self, mi: ModuleInfo, expr: ast.AST
                 ) -> Iterable[Tuple[Optional[FuncInfo], Optional[Set[str]]]]:
        """FuncInfos referenced by a callable argument: a name,
        functools.partial(name, ...), or a [list] of names."""
        if isinstance(expr, (ast.Tuple, ast.List)):
            for e in expr.elts:
                yield from self._fn_refs(mi, e)
            return
        ref = _callable_ref(expr)
        if ref is not None:
            name, bound = ref
            amap = self._alias_maps.get(mi.name, {})
            hops: Set[str] = set()
            while name in amap and name not in hops:
                hops.add(name)
                aname, abound = amap[name]
                bound = (None if bound is None or abound is None
                         else bound | abound)
                name = aname
            yield self.resolve(mi.name, name), bound

    # -- the per-tree region ---------------------------------------------
    def mark_hot(self, roots: Sequence[Tuple[str, str]] = HOT_ROOTS) -> None:
        """Mark the roots and every function they reach through
        same-package calls (and functools.partial references)."""
        work: List[FuncInfo] = []
        for mi in self.modules.values():
            for suffix, qual in roots:
                fi = mi.funcs.get(qual)
                if fi is not None and _module_matches(mi.name, suffix) \
                        and not fi.hot:
                    fi.hot = True
                    work.append(fi)
        while work:
            fi = work.pop()
            mi = self.modules[fi.module]
            for node in ast.walk(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                targets = [self.resolve_callee(mi, fi.qualname, node.func)]
                ref = _callable_ref(node)
                if ref is not None and ref[0] != getattr(node.func, "id",
                                                         None):
                    targets.append(self.resolve(mi.name, ref[0]))
                for t in targets:
                    if t is not None and not t.hot:
                        t.hot = True
                        work.append(t)

    # -- collectives ------------------------------------------------------
    def collective_methods(self) -> Set[str]:
        """Names of the mesh layer's functions and methods that reach a
        torch.distributed collective (the names an unresolvable
        `self.mesh.psum(...)` or `exchange.amax(...)` call is matched
        by)."""
        if not hasattr(self, "_coll_methods"):
            names: Set[str] = set()
            for mi in self.modules.values():
                if not any(_module_matches(mi.name, m)
                           for m in COLLECTIVE_MODULES):
                    continue
                for fi in set(mi.funcs.values()):
                    if self.func_has_collective(fi):
                        names.add(fi.qualname.rsplit(".", 1)[-1])
            names.discard("__init__")
            self._coll_methods = names
        return self._coll_methods

    def call_is_collective(self, mi: ModuleInfo, qual: str,
                           node: ast.Call, methods: bool = True) -> bool:
        chain = _attr_chain(node.func)
        if chain and chain[-1] in _DIST_COLLECTIVES and (
                "dist" in chain[:-1] or "distributed" in chain[:-1]):
            return True
        target = self.resolve_callee(mi, qual, node.func)
        if target is not None:
            return self.func_has_collective(target)
        if methods and isinstance(node.func, ast.Attribute):
            return node.func.attr in self.collective_methods()
        return False

    def func_has_collective(self, fi: Optional[FuncInfo],
                            _seen: Optional[Set[int]] = None) -> bool:
        """Does `fi` perform a collective, directly or through
        same-package calls?"""
        if fi is None:
            return False
        memo = self._coll_memo
        if id(fi) in memo:
            return memo[id(fi)]
        seen = _seen if _seen is not None else set()
        if id(fi) in seen:
            return False                       # cycle: no new evidence
        seen.add(id(fi))
        mi = self.modules[fi.module]
        result = False
        for node in ast.walk(fi.node):
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            if chain and chain[-1] in _DIST_COLLECTIVES and (
                    "dist" in chain[:-1] or "distributed" in chain[:-1]):
                result = True
                break
            target = self.resolve_callee(mi, fi.qualname, node.func)
            if target is not None and target is not fi \
                    and self.func_has_collective(target, seen):
                result = True
                break
        if _seen is None or result:
            memo[id(fi)] = result
        return result


# ---------------------------------------------------------------------------
# rule checks
# ---------------------------------------------------------------------------


def _is_int_dtype(expr: Optional[ast.AST]) -> bool:
    chain = _attr_chain(expr) if expr is not None else None
    return bool(chain) and chain[-1] in _INT_DTYPES


def _reads_rank(expr: ast.AST) -> bool:
    for n in ast.walk(expr):
        if isinstance(n, ast.Name) and n.id in ("rank", "local_rank",
                                                "rank_rows"):
            return True
        if isinstance(n, ast.Attribute) and n.attr in ("rank",
                                                       "rank_rows"):
            return True
        if isinstance(n, ast.Call):
            chain = _attr_chain(n.func)
            if chain and chain[-1] == "get_rank":
                return True
    return False


class _Flow:
    """Per-function value kinds (names only, a straight-line
    approximation: a later assignment overrides an earlier one)."""

    def __init__(self, pkg: Package, mi: ModuleInfo):
        self.pkg = pkg
        self.mi = mi
        self.tensors: Set[str] = set()
        self.hosts: Set[str] = set()
        self.ints: Set[str] = set()        # integer tensors
        self.clocks: Set[str] = set()      # values read off time.*

    def is_tensor(self, expr: ast.AST) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id in self.tensors
        if isinstance(expr, ast.Call):
            chain = _attr_chain(expr.func)
            if chain and chain[0] == "torch":
                return _tensor_chain(chain)
            if isinstance(expr.func, ast.Attribute):
                if expr.func.attr in _READ_METHODS | _HOST_METHODS:
                    return False
                return self.is_tensor(expr.func.value)
            return False
        if isinstance(expr, ast.BinOp):
            return self.is_tensor(expr.left) or self.is_tensor(expr.right)
        if isinstance(expr, ast.UnaryOp):
            return self.is_tensor(expr.operand)
        if isinstance(expr, ast.Compare):
            # identity and containment tests return host bools
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in expr.ops):
                return False
            return self.is_tensor(expr.left) or any(
                self.is_tensor(c) for c in expr.comparators)
        if isinstance(expr, ast.BoolOp):
            return any(self.is_tensor(v) for v in expr.values)
        if isinstance(expr, ast.Subscript):
            return self.is_tensor(expr.value)
        if isinstance(expr, ast.Attribute):
            if expr.attr in _HOST_ATTRS:
                return False
            if expr.attr in ("T", "mT", "real", "data"):
                return self.is_tensor(expr.value)
            b, levels = expr.value, 1
            while isinstance(b, ast.Attribute):
                b, levels = b.value, levels + 1
            if isinstance(b, ast.Name) and b.id == "self":
                if levels == 1:
                    return expr.attr in (self.mi.tensor_attrs
                                         - self.mi.host_attrs)
                return expr.attr in self.pkg.tensor_attrs()
            return False
        if isinstance(expr, ast.IfExp):
            return self.is_tensor(expr.body) or self.is_tensor(expr.orelse)
        return False

    def is_host(self, expr: ast.AST) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id in self.hosts
        if isinstance(expr, ast.Call):
            chain = _attr_chain(expr.func)
            return bool(chain) and chain[0] in ("np", "numpy")
        if isinstance(expr, ast.Subscript):
            return self.is_host(expr.value)
        if isinstance(expr, ast.Attribute):
            b = expr
            while isinstance(b, ast.Attribute):
                b = b.value
            return (isinstance(b, ast.Name) and b.id == "self"
                    and isinstance(expr.value, ast.Name)
                    and expr.attr in (self.mi.host_attrs
                                      - self.mi.tensor_attrs))
        return False

    def is_int_tensor(self, expr: ast.AST) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id in self.ints
        if isinstance(expr, ast.Call):
            if any(kw.arg == "dtype" and _is_int_dtype(kw.value)
                   for kw in expr.keywords):
                return True
            if isinstance(expr.func, ast.Attribute):
                attr = expr.func.attr
                if attr in ("long", "int", "short", "byte", "bool"):
                    return True
                if attr == "to" and expr.args and _is_int_dtype(
                        expr.args[0]):
                    return True
                if attr in ("argsort", "argmax", "argmin", "nonzero",
                            "count_nonzero"):
                    return True
            chain = _attr_chain(expr.func)
            if chain and chain[-1] in ("ones_like", "zeros_like",
                                       "full_like", "where", "clamp",
                                       "view", "reshape", "expand",
                                       "contiguous", "clone", "flatten",
                                       "unsqueeze", "squeeze"):
                src = (expr.args[0] if chain[0] == "torch" and expr.args
                       else expr.func.value
                       if isinstance(expr.func, ast.Attribute) else None)
                if chain[-1] == "where" and len(expr.args) == 3:
                    return (self.is_int_tensor(expr.args[1])
                            and self.is_int_tensor(expr.args[2]))
                return src is not None and self.is_int_tensor(src)
            return False
        if isinstance(expr, ast.Subscript):
            return self.is_int_tensor(expr.value)
        if isinstance(expr, ast.BinOp) and not isinstance(expr.op,
                                                          ast.Div):
            return (self.is_int_tensor(expr.left)
                    and (self.is_int_tensor(expr.right)
                         or isinstance(expr.right, ast.Constant)
                         and isinstance(expr.right.value, int)))
        return False

    def is_clock(self, expr: ast.AST) -> bool:
        for n in ast.walk(expr):
            if isinstance(n, ast.Name) and n.id in self.clocks:
                return True
            if isinstance(n, ast.Call):
                chain = _attr_chain(n.func)
                if chain and chain[0] == "time" and len(chain) == 2:
                    return True
        return False

    def note_assign(self, targets: List[ast.AST], value: ast.AST) -> None:
        kinds = (self.is_tensor(value), self.is_host(value),
                 self.is_int_tensor(value), self.is_clock(value))
        names: List[str] = []
        for t in targets:
            if isinstance(t, ast.Name):
                names.append(t.id)
            elif isinstance(t, (ast.Tuple, ast.List)):
                # unpacking a torch call's tuple (values, indices = ...)
                for e in t.elts:
                    if isinstance(e, ast.Name):
                        names.append(e.id)
        for name in names:
            for on, s in zip(kinds, (self.tensors, self.hosts, self.ints,
                                     self.clocks)):
                if on:
                    s.add(name)
                else:
                    s.discard(name)


class _Checker(ast.NodeVisitor):
    """Rule checks over one function body (or a module's top level)."""

    def __init__(self, pkg: Package, mi: ModuleInfo, fi: Optional[FuncInfo],
                 findings: List[Finding]):
        self.pkg = pkg
        self.mi = mi
        self.fi = fi
        self.hot = fi is not None and fi.hot
        self.qual = fi.qualname if fi is not None else "<module>"
        self.flow = _Flow(pkg, mi)
        self.findings = findings

    def _emit(self, node: ast.AST, rule: str, msg: str) -> None:
        self.findings.append(Finding(self.mi.path, node.lineno, rule, msg,
                                     self.qual))

    # -- nested scopes are their own FuncInfos ---------------------------
    def visit_FunctionDef(self, node) -> None:
        if self.fi is not None and node is self.fi.node:
            self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        return

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self.visit(node.body)

    # -- dataflow ---------------------------------------------------------
    def visit_Assign(self, node: ast.Assign) -> None:
        self.generic_visit(node)
        self.flow.note_assign(node.targets, node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self.generic_visit(node)
        if node.value is not None:
            self.flow.note_assign([node.target], node.value)

    def visit_For(self, node: ast.For) -> None:
        # a loop over a tensor iterates its rows through the host
        if self.hot and self.flow.is_tensor(node.iter):
            self._emit(node, "host-sync",
                       "iterating a tensor reads it row by row")
        self.generic_visit(node)

    # -- host-sync: implicit __bool__ -------------------------------------
    def _test(self, node: ast.AST, test: ast.AST, what: str) -> None:
        if self.hot and self.flow.is_tensor(test):
            self._emit(node, "host-sync",
                       f"a tensor as the test of {what} reads it "
                       "(implicit __bool__)")

    def visit_If(self, node: ast.If) -> None:
        self._test(node, node.test, "if")
        self._divergent(node)
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self._test(node, node.test, "while")
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        self._test(node, node.test, "assert")
        self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp) -> None:
        self._test(node, node.test, "a conditional expression")
        self.generic_visit(node)

    # -- calls --------------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        self.generic_visit(node)
        func = node.func
        chain = _attr_chain(func)
        if self.hot:
            self._host_sync_call(node, func, chain)
        self._nondeterminism(node, func, chain)
        self._axis_names(node, func)

    def _host_sync_call(self, node: ast.Call, func: ast.AST,
                        chain: Optional[Tuple[str, ...]]) -> None:
        if isinstance(func, ast.Attribute) and func.attr in _READ_METHODS \
                and not node.args:
            recv = func.value
            if isinstance(recv, ast.Call) and isinstance(
                    recv.func, ast.Attribute) and recv.func.attr == "cpu":
                return                  # .cpu() made the read already
            if func.attr in _SHARED_WITH_NUMPY and (
                    self.flow.is_host(recv) or not self.flow.is_tensor(recv)
                    and not _maybe_tensor(recv)):
                return
            self._emit(node, "host-sync",
                       f".{func.attr}() reads a tensor into host memory")
            return
        if chain and chain[-1] == "synchronize" and "cuda" in chain:
            self._emit(node, "host-sync",
                       "torch.cuda.synchronize() waits for the device")
            return
        if isinstance(func, ast.Name) and func.id in ("float", "int",
                                                      "bool") \
                and len(node.args) == 1 and self.flow.is_tensor(node.args[0]):
            self._emit(node, "host-sync",
                       f"{func.id}() of a tensor reads it into host memory")

    def _nondeterminism(self, node: ast.Call, func: ast.AST,
                        chain: Optional[Tuple[str, ...]]) -> None:
        if isinstance(func, ast.Attribute):
            attr = func.attr
            accumulate = attr in _ACCUM_METHODS or (
                attr in ("index_put_", "index_put") and any(
                    kw.arg == "accumulate" and not (
                        isinstance(kw.value, ast.Constant)
                        and kw.value.value is False)
                    for kw in node.keywords))
            if accumulate:
                vals = (node.args[-1] if attr.startswith(("index_add",
                                                          "scatter_add"))
                        and node.args else
                        node.args[1] if len(node.args) > 1 else None)
                if not (self.flow.is_int_tensor(func.value)
                        or vals is not None and self.flow.is_int_tensor(
                            vals)):
                    self._emit(node, "nondeterminism",
                               f"{attr} of float values adds with atomics "
                               "on CUDA: the sum's order, and its bits, "
                               "differ from run to run")
        if chain and chain[0] == "torch" and chain[-1] in _RANDOM_CALLS \
                and len(chain) == 2 \
                and not any(kw.arg == "generator" for kw in node.keywords):
            self._emit(node, "nondeterminism",
                       f"torch.{chain[-1]} draws from the global generator "
                       "(pass generator=)")
        feeds_tensor = (_tensor_chain(chain) or isinstance(
            func, ast.Attribute) and self.flow.is_tensor(func.value))
        if feeds_tensor and any(
                self.flow.is_clock(a)
                for a in [*node.args, *(kw.value for kw in node.keywords)]):
            self._emit(node, "nondeterminism",
                       "a clock reading (time.*) feeds a tensor")

    def _axis_names(self, node: ast.Call, func: ast.AST) -> None:
        if not isinstance(func, ast.Attribute) or func.attr not in _AXIS_ARG:
            return
        axes = self.pkg.mesh_axes()
        recv = _attr_chain(func.value)
        if not axes or not recv or not any("mesh" in p.lower()
                                           for p in recv):
            return
        pos = _AXIS_ARG[func.attr]
        arg = node.args[pos] if pos < len(node.args) else next(
            (kw.value for kw in node.keywords
             if kw.arg in ("axes", "axis")), None)
        if arg is None:
            return
        bad = sorted({n.value for n in ast.walk(arg)
                      if isinstance(n, ast.Constant)
                      and isinstance(n.value, str)} - axes)
        if bad:
            self._emit(node, "collective-mismatch",
                       f"mesh axis {bad[0]!r} is not one of "
                       f"{sorted(axes)} (sharded/mesh.py AXES)")

    # -- divergent-collective ---------------------------------------------
    def _branch_collective(self, stmts: Sequence[ast.stmt]) -> bool:
        for stmt in stmts:
            for n in ast.walk(stmt):
                if isinstance(n, ast.Call) and self.pkg.call_is_collective(
                        self.mi, self.qual, n):
                    return True
        return False

    def _divergent(self, node: ast.If) -> None:
        if not _reads_rank(node.test):
            return
        body = self._branch_collective(node.body)
        other = self._branch_collective(node.orelse)
        if body != other:
            self._emit(node, "divergent-collective",
                       "a branch on the rank performs a collective that "
                       "the other branch skips: the ranks that skip it "
                       "leave the others waiting in it")


def _maybe_tensor(expr: ast.AST) -> bool:
    """Receivers of .item()/.tolist() that are tensors by construction:
    the result of a torch.* call or of a tensor method chain."""
    if isinstance(expr, ast.Call):
        chain = _attr_chain(expr.func)
        if chain and chain[0] == "torch":
            return _tensor_chain(chain)
        if isinstance(expr.func, ast.Attribute) \
                and expr.func.attr not in _READ_METHODS | _HOST_METHODS:
            return _maybe_tensor(expr.func.value)
    if isinstance(expr, ast.Subscript):
        return _maybe_tensor(expr.value)
    return False


# ---------------------------------------------------------------------------
# suppression handling
# ---------------------------------------------------------------------------


def _suppressions_for(lines: Sequence[str], lineno: int
                      ) -> Optional[Tuple[Set[str], str]]:
    """(rules, reason) from a torchlint comment on `lineno` or the line
    above (1-indexed); None when no suppression applies."""
    for ln in (lineno, lineno - 1):
        if 1 <= ln <= len(lines):
            m = _SUPPRESS_RE.search(lines[ln - 1])
            if m:
                rules = {r.strip() for r in m.group(1).split(",")}
                return rules, m.group(2).strip()
    return None


def load_allowlist(path: str) -> Dict[Tuple[str, str, str], str]:
    """path::rule::qualname -> reason entries from the reviewed file."""
    out: Dict[Tuple[str, str, str], str] = {}
    if not os.path.exists(path):
        return out
    with open(path) as fh:
        for raw in fh:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            body, _, reason = line.partition("—")
            if not reason:
                body, _, reason = line.partition(" - ")
            parts = [p.strip() for p in body.strip().split("::")]
            if len(parts) == 3:
                out[(parts[0], parts[1], parts[2])] = reason.strip()
    return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def lint_paths(paths: Sequence[str], root: str,
               allowlist: Optional[Dict[Tuple[str, str, str], str]] = None,
               used_allowlist: Optional[Set[Tuple[str, str, str]]] = None,
               roots: Sequence[Tuple[str, str]] = HOT_ROOTS
               ) -> List[Finding]:
    """Run every rule over `paths` (files or directories).  Returns
    unsuppressed findings; suppressions without a reason are findings
    themselves (`suppression` rule).  `used_allowlist`, when given, is
    filled with the allowlist keys that matched a finding."""
    findings, _stale = lint_run(paths, root, allowlist,
                                used_allowlist=used_allowlist,
                                check_stale=False, roots=roots)
    return findings


def stale_allowlist_entries(
        allowlist: Dict[Tuple[str, str, str], str],
        used: Set[Tuple[str, str, str]],
        linted_paths: Set[str], root: str) -> List[str]:
    """Allowlist entries that no longer earn their keep: the file was
    linted and the key matched no finding (the fix landed, or the
    function was renamed), or the file no longer exists.  Only valid on
    a run over the whole package: whether an entry still produces its
    finding can depend on other files (the per-tree reachability)."""
    out: List[str] = []
    for (path, rule, qual), _reason in sorted(allowlist.items()):
        if (path, rule, qual) in used:
            continue
        if path in linted_paths:
            out.append(f"{path}::{rule}::{qual} — no longer produces a "
                       "finding; remove the entry")
        elif not os.path.exists(os.path.join(root, path)):
            out.append(f"{path}::{rule}::{qual} — file no longer exists; "
                       "remove the entry")
    return out


def lint_run(paths: Sequence[str], root: str,
             allowlist: Optional[Dict[Tuple[str, str, str], str]] = None,
             used_allowlist: Optional[Set[Tuple[str, str, str]]] = None,
             check_stale: bool = True,
             roots: Sequence[Tuple[str, str]] = HOT_ROOTS
             ) -> Tuple[List[Finding], List[str]]:
    """lint_paths plus the stale-allowlist audit: returns
    (findings, stale-entry descriptions)."""
    pkg = Package(root)
    for p in paths:
        if os.path.isdir(p):
            pkg.add_tree(p)
        else:
            pkg.add_file(p)
    pkg.mark_hot(roots)
    allowlist = allowlist or {}
    used: Set[Tuple[str, str, str]] = (used_allowlist
                                       if used_allowlist is not None
                                       else set())

    raw: List[Finding] = []
    for mi in pkg.modules.values():
        for fi in {id(f.node): f for f in mi.funcs.values()}.values():
            _Checker(pkg, mi, fi, raw).visit(fi.node)
        top = _Checker(pkg, mi, None, raw)
        for stmt in mi.tree.body:
            if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                top.visit(stmt)

    seen: Set[Tuple[str, int, str, str]] = set()
    findings: List[Finding] = []
    by_path = {m.path: m for m in pkg.modules.values()}
    for f in sorted(raw, key=lambda f: (f.path, f.line, f.rule)):
        key = (f.path, f.line, f.rule, f.message)
        if key in seen:
            continue
        seen.add(key)
        sup = _suppressions_for(by_path[f.path].lines, f.line)
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
        linted = {m.path for m in pkg.modules.values()}
        stale = stale_allowlist_entries(allowlist, used, linted, root)
    return findings, stale
