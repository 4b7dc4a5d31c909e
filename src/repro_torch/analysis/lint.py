"""Plane 3: the port's AST lint over ``src/repro_torch``.

Rules (catalog in :mod:`repro_torch.analysis.findings`):

  * LC101 — a host sync inside the tick: ``if`` / ``while`` / ``assert`` /
    a conditional expression on a tensor, ``bool()`` / ``int()`` /
    ``float()`` of a tensor, ``.item()`` / ``.tolist()`` / ``.cpu()`` /
    ``.numpy()`` on a tensor, ``torch.nonzero`` / ``torch.masked_select`` /
    one-argument ``torch.where``, and indexing a tensor with a boolean mask;
  * LC102 — numpy applied to a tensor inside the tick;
  * LC103 — a kernel ``ops.py`` entry without a ``_ref`` twin or a
    ``tests/test_torch_*.py`` reference;
  * LC104 — a config object mutated after construction.

"The tick" is computed, not guessed. PyTorch has no ``jit`` / ``scan``
markers, so the roots are the port's own tick functions: the ``step``
closure built by any ``make_step``, the ``tick`` method of any ``*Draws``
class (the tick's random values, which a captured tick would make too), and
the methods of any ``*Plane`` class (the node-plane strategy ``step`` calls
through its ``plane`` argument). From the roots the set propagates through
the project's call graph: bare names resolved lexically, ``module.func``
through imports, ``self.m`` to the enclosing class and ``plane.m`` to the
``*Plane`` classes. Host-side code (``summarize``, ``init``, benchmark
scripts) stays out.

Taint for LC101/LC102 is a forward pass per function: parameters annotated
as tensors, fields of the state structs (``SimState``, ``Draws``,
``NodeView``, ``ArrivalBatch``, ``Metrics``) and results of ``torch.*``
calls and of methods on tensors are tensors; ``.shape`` / ``.dtype`` /
``.device`` / ``.is_cuda``, ``.numel()`` / ``.dim()`` / ``len()`` and
identity tests against ``None`` are static. Config values stay static, so
``if cfg.memory.enabled:`` is clean, and numpy on host data (the pre-drawn
mmpp burst states) is not LC102. The pass under-approximates on purpose: a
lint false negative is cheap, a false positive on the clean tree is not.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.findings import Finding

__all__ = ["ProjectIndex", "lint_paths", "run_lint"]

_TENSOR_ANN = {"Tensor"}
_STRUCT_ANN = {"SimState", "Draws", "NodeView", "ArrivalBatch", "Metrics"}
# attribute reads that are static (host metadata) even on a tensor
_DETAINT_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "layout", "_fields"}
# methods that return host metadata without reading the data
_DETAINT_METHODS = {"numel", "dim", "size", "is_contiguous", "data_ptr", "element_size",
                    "is_floating_point", "_replace"}
# torch calls that return host values, not tensors
_STATIC_TORCH = {"device", "finfo", "iinfo", "Size", "is_tensor", "get_default_dtype",
                 "Generator", "Stream", "Event"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_SYNC_TORCH = {"nonzero", "masked_select", "argwhere"}
_MASK_CALLS = {"isfinite", "isnan", "isinf", "logical_and", "logical_or", "logical_not",
               "logical_xor", "bool", "eq", "ne", "lt", "le", "gt", "ge"}
_CONFIG_NAME_RE = re.compile(r"(^cfg$|^config$|_cfg$|_config$)")


def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _ann_tails(ann: Optional[ast.AST]) -> Set[str]:
    """Trailing identifiers of an annotation ('torch.Tensor | None' -> {'Tensor', 'None'})."""
    if ann is None:
        return set()
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            return _ann_tails(ast.parse(ann.value, mode="eval").body)
        except SyntaxError:
            return set()
    if isinstance(ann, ast.Constant) and ann.value is None:
        return {"None"}
    if isinstance(ann, ast.Subscript):  # Optional[X] / Tuple[X, ...]
        return _ann_tails(ann.slice)
    if isinstance(ann, ast.Tuple):
        return set().union(*(_ann_tails(e) for e in ann.elts))
    if isinstance(ann, ast.BinOp):  # X | None
        return _ann_tails(ann.left) | _ann_tails(ann.right)
    d = _dotted(ann)
    return {d.split(".")[-1]} if d else set()


def _walk_excl_nested(fn: ast.AST) -> Iterator[ast.AST]:
    """Walk a function body, not descending into nested function defs."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


@dataclasses.dataclass
class _FuncInfo:
    module: str  # module key (file path as string)
    name: str
    qualname: str  # dotted path through classes AND functions
    node: ast.AST
    parent_qual: Optional[str]  # nearest enclosing *function* qualname
    cls: Optional[str]  # qualname of the class it is a method of


@dataclasses.dataclass
class _ModuleInfo:
    path: Path
    tree: ast.Module
    import_mod: Dict[str, str]  # alias -> dotted module
    import_obj: Dict[str, Tuple[str, str]]  # alias -> (module, name)
    by_qual: Dict[str, _FuncInfo]
    children: Dict[Optional[str], Dict[str, str]]  # lexical scopes (methods excluded)
    classes: Dict[str, Dict[str, str]]  # class qualname -> {method: qualname}
    numpy_aliases: Set[str]

    def module_level(self) -> Dict[str, _FuncInfo]:
        return {fi.name: fi for fi in self.by_qual.values()
                if fi.parent_qual is None and fi.cls is None}


def _index_module(path: Path, tree: ast.Module) -> _ModuleInfo:
    import_mod: Dict[str, str] = {}
    import_obj: Dict[str, Tuple[str, str]] = {}
    numpy_aliases: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                alias = a.asname or a.name.split(".")[0]
                import_mod[alias] = a.name if a.asname else a.name.split(".")[0]
                if a.name == "numpy":
                    numpy_aliases.add(alias)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                alias = a.asname or a.name
                import_obj[alias] = (node.module, a.name)
                import_mod[alias] = f"{node.module}.{a.name}"
                if node.module == "numpy":
                    numpy_aliases.add(alias)

    by_qual: Dict[str, _FuncInfo] = {}
    children: Dict[Optional[str], Dict[str, str]] = {}
    classes: Dict[str, Dict[str, str]] = {}

    def visit(node: ast.AST, prefix: List[str], func_parent: Optional[str],
              cls: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = ".".join(prefix + [child.name])
                by_qual[qual] = _FuncInfo(str(path), child.name, qual, child, func_parent, cls)
                if cls is None:
                    children.setdefault(func_parent, {})[child.name] = qual
                else:
                    classes[cls][child.name] = qual
                visit(child, prefix + [child.name], qual, None)
            elif isinstance(child, ast.ClassDef):
                cq = ".".join(prefix + [child.name])
                classes[cq] = {}
                visit(child, prefix + [child.name], func_parent, cq)
            else:
                visit(child, prefix, func_parent, cls)

    visit(tree, [], None, None)
    return _ModuleInfo(path, tree, import_mod, import_obj, by_qual, children, classes,
                       numpy_aliases)


Target = Tuple[str, str]  # (module key, qualname)


class ProjectIndex:
    """Parsed modules + the propagated tick set."""

    def __init__(self, files: Sequence[Path], package_root: Optional[Path]):
        self.modules: Dict[str, _ModuleInfo] = {}
        for f in files:
            self.modules[str(f)] = _index_module(f, ast.parse(f.read_text()))
        self._mod_by_dotted: Dict[str, str] = {}
        if package_root is not None:
            for key, mi in self.modules.items():
                try:
                    rel = mi.path.resolve().relative_to(package_root.resolve())
                except ValueError:
                    continue
                dotted = ".".join(rel.with_suffix("").parts).removesuffix(".__init__")
                self._mod_by_dotted[dotted] = key
        # the node-plane strategies: methods of every *Plane class
        self._plane_methods: Dict[str, List[Target]] = {}
        for key, mi in self.modules.items():
            for cq, methods in mi.classes.items():
                if cq.split(".")[-1].endswith("Plane"):
                    for m, q in methods.items():
                        self._plane_methods.setdefault(m, []).append((key, q))
        self.traced: Set[Target] = set()
        self._propagate()

    def _resolve_bare(self, mi: _ModuleInfo, name: str, from_qual: Optional[str]) -> List[Target]:
        cur = from_qual
        while cur is not None:
            scope = mi.children.get(cur, {})
            if name in scope:
                return [(str(mi.path), scope[name])]
            fi = mi.by_qual.get(cur)
            cur = fi.parent_qual if fi is not None else None
        scope = mi.children.get(None, {})
        if name in scope:
            return [(str(mi.path), scope[name])]
        if name in mi.import_obj:
            mod, orig = mi.import_obj[name]
            key = self._mod_by_dotted.get(mod)
            if key is not None:
                tgt = self.modules[key].module_level().get(orig)
                if tgt is not None:
                    return [(key, tgt.qualname)]
        return []

    def _resolve_call(self, mi: _ModuleInfo, func: ast.AST, fi: _FuncInfo) -> List[Target]:
        if isinstance(func, ast.Name):
            return self._resolve_bare(mi, func.id, fi.qualname)
        if isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name):
            recv = func.value.id
            if recv == "self":
                cls = fi.cls
                if cls is None and fi.parent_qual is not None:  # a closure in a method
                    cls = mi.by_qual[fi.parent_qual].cls
                q = mi.classes.get(cls, {}).get(func.attr) if cls else None
                return [(str(mi.path), q)] if q else []
            if recv == "plane":
                return list(self._plane_methods.get(func.attr, []))
            if recv in mi.import_mod:
                key = self._mod_by_dotted.get(mi.import_mod[recv])
                if key is not None:
                    tgt = self.modules[key].module_level().get(func.attr)
                    if tgt is not None:
                        return [(key, tgt.qualname)]
        return []

    def _roots(self) -> Iterator[Target]:
        for key, mi in self.modules.items():
            for qual, fi in mi.by_qual.items():
                parent = mi.by_qual.get(fi.parent_qual) if fi.parent_qual else None
                if fi.name == "step" and parent is not None and parent.name == "make_step":
                    yield key, qual
                elif fi.cls and fi.name == "tick" and fi.cls.split(".")[-1].endswith("Draws"):
                    yield key, qual
            for methods in (m for c, m in mi.classes.items() if c.split(".")[-1].endswith("Plane")):
                for q in methods.values():
                    yield key, q

    def _propagate(self) -> None:
        work: List[Target] = list(self._roots())
        while work:
            item = work.pop()
            if item in self.traced:
                continue
            key, qual = item
            mi = self.modules.get(key)
            if mi is None or qual not in mi.by_qual:
                continue
            self.traced.add(item)
            fi = mi.by_qual[qual]
            for q, sub in mi.by_qual.items():  # nested defs run inside the tick
                if sub.parent_qual == qual:
                    work.append((key, q))
            for node in _walk_excl_nested(fi.node):
                if isinstance(node, ast.Call):
                    work.extend(self._resolve_call(mi, node.func, fi))
                    # functions handed on as values (callbacks) run too
                    for a in node.args:
                        if isinstance(a, ast.Name):
                            work.extend(self._resolve_bare(mi, a.id, fi.qualname))

    def is_traced(self, module_key: str, qualname: str) -> bool:
        return (module_key, qualname) in self.traced


# ---------------------------------------------------------------------------
# LC101 / LC102: tick function bodies
# ---------------------------------------------------------------------------


class _TaintPass:
    """Forward taint pass over one tick function body."""

    def __init__(self, fn: ast.AST, numpy_aliases: Set[str]):
        self.tensors: Set[str] = set()
        self.structs: Set[str] = set()
        self.masks: Set[str] = set()
        self.np = numpy_aliases
        args = fn.args
        for p in list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs):
            tails = _ann_tails(p.annotation)
            if tails & _TENSOR_ANN:
                self.tensors.add(p.arg)
            elif tails & _STRUCT_ANN:
                self.structs.add(p.arg)

    def tensor(self, node: ast.AST) -> bool:
        """Whether ``node`` evaluates to a tensor (on the device, in the tick)."""
        if isinstance(node, ast.Name):
            return node.id in self.tensors
        if isinstance(node, ast.Attribute):
            if node.attr in _DETAINT_ATTRS:
                return False
            if isinstance(node.value, ast.Name) and node.value.id in self.structs:
                return True
            return self.tensor(node.value)
        if isinstance(node, ast.Subscript):
            return self.tensor(node.value)
        if isinstance(node, ast.Call):
            d = _dotted(node.func) or ""
            parts = d.split(".")
            if parts[0] == "torch":
                return not (len(parts) > 1 and (parts[1] in _STATIC_TORCH or parts[1] == "cuda"))
            if parts[0] in self.np or d in ("len", "isinstance", "range", "enumerate", "zip",
                                            "bool", "int", "float", "str", "tuple"):
                return False
            if isinstance(node.func, ast.Attribute):
                if node.func.attr in _DETAINT_METHODS:
                    return node.func.attr == "_replace" and self.struct(node.func.value)
                if self.tensor(node.func.value):
                    return True
            return any(self.tensor(a) for a in node.args) or any(
                self.tensor(k.value) for k in node.keywords
            )
        if isinstance(node, ast.BinOp):
            return self.tensor(node.left) or self.tensor(node.right)
        if isinstance(node, ast.BoolOp):
            return any(self.tensor(v) for v in node.values)
        if isinstance(node, ast.UnaryOp):
            return self.tensor(node.operand)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False
            return self.tensor(node.left) or any(self.tensor(c) for c in node.comparators)
        if isinstance(node, ast.IfExp):
            return self.tensor(node.body) or self.tensor(node.orelse)
        if isinstance(node, ast.Starred):
            return self.tensor(node.value)
        return False

    def struct(self, node: ast.AST) -> bool:
        return isinstance(node, ast.Name) and node.id in self.structs

    def mask(self, node: ast.AST) -> bool:
        """Whether ``node`` is a boolean tensor (a comparison of tensors, or
        a combination of such)."""
        if isinstance(node, ast.Name):
            return node.id in self.masks
        if isinstance(node, ast.Compare):
            return self.tensor(node)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
            return self.mask(node.operand)
        if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self.mask(node.left) or self.mask(node.right)
        if isinstance(node, ast.Call):
            d = (_dotted(node.func) or "").split(".")
            return d[-1] in _MASK_CALLS and self.tensor(node)
        return False

    def assign(self, targets: Iterable[ast.AST], value: ast.AST) -> None:
        is_tensor, is_mask = self.tensor(value), self.mask(value)
        is_struct = (self.struct(value)
                     or isinstance(value, ast.Call) and isinstance(value.func, ast.Attribute)
                     and value.func.attr == "_replace" and self.struct(value.func.value))
        for t in targets:
            if isinstance(t, ast.Name):
                for s, on in ((self.tensors, is_tensor), (self.masks, is_mask),
                              (self.structs, is_struct)):
                    (s.add if on else s.discard)(t.id)
            elif isinstance(t, (ast.Tuple, ast.List)):
                # a tuple of results: tensors when the call made tensors
                for e in t.elts:
                    if isinstance(e, ast.Name):
                        (self.tensors.add if is_tensor else self.tensors.discard)(e.id)
                        self.masks.discard(e.id)


def _check_tick_body(fi: _FuncInfo, mi: _ModuleInfo, rel: str) -> List[Finding]:
    out: List[Finding] = []
    taint = _TaintPass(fi.node, mi.numpy_aliases)
    where = f"tick function `{fi.qualname}`"

    def flag(rule: str, node: ast.AST, what: str) -> None:
        out.append(Finding(rule=rule, message=f"{what} in {where}", file=rel, line=node.lineno))

    def check_expr(node: ast.AST) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                d = _dotted(sub.func) or ""
                parts = d.split(".")
                if d in ("bool", "int", "float") and sub.args and taint.tensor(sub.args[0]):
                    flag("LC101", sub, f"`{d}()` of a tensor reads it on the host")
                elif (isinstance(sub.func, ast.Attribute) and sub.func.attr in _SYNC_METHODS
                      and taint.tensor(sub.func.value)):
                    flag("LC101", sub, f"`.{sub.func.attr}()` of a tensor reads it on the host")
                elif parts[0] == "torch" and parts[-1] in _SYNC_TORCH:
                    flag("LC101", sub, f"`{d}` waits for the device to size its output")
                elif d == "torch.where" and len(sub.args) == 1 and not sub.keywords:
                    flag("LC101", sub, "one-argument `torch.where` is `nonzero`: a host sync")
                elif (isinstance(sub.func, ast.Attribute) and sub.func.attr in _SYNC_TORCH
                      and taint.tensor(sub.func.value)):
                    flag("LC101", sub, f"`.{sub.func.attr}()` waits for the device")
                elif parts[0] in mi.numpy_aliases and (
                    any(taint.tensor(a) for a in sub.args)
                    or any(taint.tensor(k.value) for k in sub.keywords)
                ):
                    flag("LC102", sub, f"`{d}` applied to a tensor")
            elif isinstance(sub, ast.Subscript) and taint.tensor(sub.value):
                idx = sub.slice.elts if isinstance(sub.slice, ast.Tuple) else [sub.slice]
                if any(taint.mask(i) for i in idx):
                    flag("LC101", sub, "boolean-mask indexing sizes its result on the host")
            elif isinstance(sub, ast.IfExp) and taint.tensor(sub.test):
                flag("LC101", sub, "conditional expression on a tensor")

    def walk(body: Iterable[ast.AST]) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue  # nested defs are linted as their own functions
            if isinstance(stmt, (ast.If, ast.While)) and taint.tensor(stmt.test):
                kw = "while" if isinstance(stmt, ast.While) else "if"
                flag("LC101", stmt, f"Python `{kw}` on a tensor reads it on the host")
            if isinstance(stmt, ast.Assert) and taint.tensor(stmt.test):
                flag("LC101", stmt, "`assert` on a tensor reads it on the host")
            for field in ("test", "value", "iter", "exc", "msg"):
                sub = getattr(stmt, field, None)
                if isinstance(sub, ast.AST):
                    check_expr(sub)
            for t in getattr(stmt, "targets", []) + [getattr(stmt, "target", None)]:
                if isinstance(t, ast.Subscript):
                    check_expr(t)
            if isinstance(stmt, (ast.Assign, ast.AnnAssign)) and stmt.value is not None:
                tgts = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
                taint.assign(tgts, stmt.value)
            elif isinstance(stmt, ast.AugAssign) and taint.tensor(stmt.value):
                taint.assign([stmt.target], stmt.value)
            for field in ("body", "orelse", "finalbody", "handlers"):
                walk(getattr(stmt, field, []) or [])
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    check_expr(item.context_expr)

    walk(fi.node.body)
    return out


# ---------------------------------------------------------------------------
# LC103: kernel package discipline
# ---------------------------------------------------------------------------


def _kernel_source(ops_path: Path) -> Optional[Path]:
    """``csrc/<pkg>.cu`` beside the package or in one of its parents."""
    pkg = ops_path.parent
    for d in (pkg, *pkg.parents[:3]):
        cu = d / "csrc" / f"{pkg.name}.cu"
        if cu.exists():
            return cu
    return None


def _module_all(tree: ast.Module) -> Optional[List[str]]:
    for node in tree.body:
        if (isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "__all__"
                                                 for t in node.targets)
                and isinstance(node.value, (ast.List, ast.Tuple))):
            return [e.value for e in node.value.elts if isinstance(e, ast.Constant)]
    return None


def _check_kernel_pkg(mi: _ModuleInfo, tests_blob: Optional[str], rel: str) -> List[Finding]:
    out: List[Finding] = []
    pkg = mi.path.parent
    module_level = mi.module_level()
    ref_names: Set[str] = set(module_level) | set(mi.import_obj)
    ref_path = pkg / "ref.py"
    if ref_path.exists():
        ref_names |= {n.name for n in ast.walk(ast.parse(ref_path.read_text()))
                      if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    exported = _module_all(mi.tree)
    for name, fi in module_level.items():
        if name.startswith("_") or name.endswith("_ref"):
            continue
        if exported is not None and name not in exported:
            continue  # a helper (the plan launcher), not an entry
        if f"{name}_ref" not in ref_names:
            out.append(Finding(
                rule="LC103",
                message=f"kernel entry `{name}` has no `{name}_ref` twin in {pkg.name}/ "
                        "(ops.py or ref.py)",
                file=rel, line=fi.node.lineno,
            ))
        if tests_blob is not None and not re.search(rf"\b{re.escape(name)}\b", tests_blob):
            out.append(Finding(
                rule="LC103",
                message=f"kernel entry `{name}` is never referenced by a tests/test_torch_*.py "
                        "file — parity coverage missing",
                file=rel, line=fi.node.lineno,
            ))
    return out


# ---------------------------------------------------------------------------
# LC104: config mutation
# ---------------------------------------------------------------------------


def _check_config_mutation(mi: _ModuleInfo, rel: str) -> List[Finding]:
    out: List[Finding] = []
    ann: Dict[str, Set[str]] = {}
    for node in ast.walk(mi.tree):
        if isinstance(node, ast.arg) and node.annotation is not None:
            ann[node.arg] = _ann_tails(node.annotation)
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            ann[node.target.id] = _ann_tails(node.annotation)

    def config_like(name: str) -> bool:
        if name == "self":
            return False
        if any(t.endswith("Config") for t in ann.get(name, ())):
            return True
        return bool(_CONFIG_NAME_RE.search(name))

    for node in ast.walk(mi.tree):
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                        and config_like(t.value.id)):
                    out.append(Finding(
                        rule="LC104",
                        message=f"attribute store `{t.value.id}.{t.attr} = ...` mutates a "
                                "config after construction",
                        file=rel, line=node.lineno,
                    ))
        elif isinstance(node, ast.Call) and _dotted(node.func) in ("object.__setattr__", "setattr"):
            base = node.args[0] if node.args else None
            if isinstance(base, ast.Name) and config_like(base.id):
                out.append(Finding(
                    rule="LC104",
                    message=f"{_dotted(node.func)} on frozen config `{base.id}` bypasses "
                            "immutability",
                    file=rel, line=node.lineno,
                ))
    return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _tests_blob(tests_root: Optional[Path]) -> Optional[str]:
    if tests_root is None or not tests_root.is_dir():
        return None
    return "\n".join(p.read_text() for p in sorted(tests_root.glob("test_torch_*.py")))


def lint_paths(
    files: Sequence[Path],
    package_root: Optional[Path] = None,
    tests_root: Optional[Path] = None,
    repo_root: Optional[Path] = None,
) -> List[Finding]:
    """Lint an explicit file set (tree mode passes all of ``src/repro_torch``)."""
    files = [Path(f) for f in files]
    index = ProjectIndex(files, package_root)
    blob = _tests_blob(tests_root)
    out: List[Finding] = []
    for key, mi in index.modules.items():
        rel = str(mi.path)
        if repo_root is not None:
            try:
                rel = str(mi.path.resolve().relative_to(repo_root.resolve()))
            except ValueError:
                pass
        for qual, fi in mi.by_qual.items():
            if index.is_traced(key, qual):
                out.extend(_check_tick_body(fi, mi, rel))
        if mi.path.name == "ops.py" and _kernel_source(mi.path) is not None:
            out.extend(_check_kernel_pkg(mi, blob, rel))
        out.extend(_check_config_mutation(mi, rel))
    out.sort(key=lambda f: (f.file or "", f.line or 0, f.rule))
    return out


def run_lint(
    pkg_root: Path, tests_root: Optional[Path] = None, repo_root: Optional[Path] = None
) -> List[Finding]:
    """Whole-package lint: every ``*.py`` under ``pkg_root`` (``src/repro_torch``)."""
    return lint_paths(
        sorted(pkg_root.rglob("*.py")),
        package_root=pkg_root.parent,
        tests_root=tests_root,
        repo_root=repo_root or pkg_root.parent.parent,
    )
