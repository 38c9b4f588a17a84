"""Cross-file call graph over the linted project.

The engine's whole-program layer: every ``def`` in every parsed file becomes
a node; edges are added only where a call target can be resolved *statically
and conservatively*:

  - bare-name calls to same-module functions and lexically enclosing nested
    defs;
  - dotted calls resolved through the file's import table
    (``from x import y``, ``import x.y as z``, relative imports) by
    dotted-suffix matching against the indexed modules — so the graph works
    both for the installed package and for test fixture trees rooted
    anywhere;
  - ``self.meth()`` / ``cls.meth()`` dispatched to the enclosing class, its
    project ancestors, and its project descendants;
  - ``self.attr.meth()`` and ``var.meth()`` where the attribute/variable's
    class is inferred from an annotated parameter, an ``self.attr =
    ClassName(...)`` assignment, or a local ``var = ClassName(...)``
    construction.

Anything dynamic — arbitrary ``obj.meth()``, callables passed as values,
getattr — produces NO edge. Reachability built on this graph therefore
under-approximates, never explodes: a missing edge costs a finding, a wrong
edge would cost a false positive, and the rules' contract is no false
positives.

Nested ``def``s are their own nodes, linked to the enclosing function by a
NESTED edge (lexical containment) distinct from CALL edges (explicit
invocation). Rule families choose per entry-point category whether
reachability flows through NESTED edges: serving/predict/train follow them
(the dispatch pattern returns ``finalize`` closures that run on the serving
path), the async-loop category does not (the executor-delegate pattern —
``def _work(): ...; await loop.run_in_executor(None, _work)`` — is exactly
a nested def that must NOT inherit the event-loop context).

No torch / numpy imports here: the linter must start fast and never touch an
accelerator runtime.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterable, Iterator

__all__ = [
    "FunctionNode",
    "ClassInfo",
    "ProjectGraph",
    "build_project",
    "module_parts",
]


def module_parts(path: str) -> tuple[str, ...]:
    """Normalize a file path to dotted-module-ish parts for suffix matching.

    ``/src/predictionio_tpu_torch/ops/topk.py`` ->
    ``("src", "predictionio_tpu_torch", "ops", "topk")``;
    ``pkg/__init__.py`` -> ``("pkg",)``.
    """
    norm = path.replace("\\", "/")
    if norm.endswith(".py"):
        norm = norm[:-3]
    parts = tuple(p for p in norm.split("/") if p and p != ".")
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return parts


@dataclasses.dataclass
class FunctionNode:
    """One ``def`` (top-level, method, or nested) in the project."""

    key: str  # "<path>::<qualname>" — stable node id
    path: str  # the display/abs path the file was analyzed under
    parts: tuple[str, ...]  # module parts of that path
    qualname: str  # "fn", "Cls.meth", "fn.<locals>.inner"
    name: str
    lineno: int
    is_async: bool
    node: ast.FunctionDef | ast.AsyncFunctionDef
    class_name: str | None = None  # immediately enclosing class, if a method
    parent: str | None = None  # enclosing function's key, if nested

    @property
    def dotted(self) -> tuple[str, ...]:
        """Suffix-matchable tuple for import resolution. Nested functions
        are not importable and return ``()`` (never matched)."""
        if self.parent is not None:
            return ()
        if self.class_name is not None:
            return self.parts + (self.class_name, self.name)
        return self.parts + (self.name,)


@dataclasses.dataclass
class ClassInfo:
    name: str
    path: str
    parts: tuple[str, ...]
    bases: tuple[tuple[str, ...], ...]  # import-expanded dotted base names
    methods: dict[str, str] = dataclasses.field(default_factory=dict)
    # attribute name -> candidate class keys ("<path>::<name>")
    attr_types: dict[str, tuple[str, ...]] = dataclasses.field(
        default_factory=dict
    )

    @property
    def key(self) -> str:
        return f"{self.path}::{self.name}"

    @property
    def dotted(self) -> tuple[str, ...]:
        return self.parts + (self.name,)


_FN_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _dotted_chain(node: ast.AST) -> tuple[str, ...] | None:
    """``a.b.c`` -> ("a","b","c"); None when the chain bottoms out in a
    call, subscript, or other non-name expression."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def _annotation_chains(ann: ast.AST | None) -> list[tuple[str, ...]]:
    """Every plausible class reference inside an annotation expression:
    handles ``X``, ``mod.X``, ``X | None``, ``Optional[X]``, and string
    annotations (parsed)."""
    if ann is None:
        return []
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return []
    out: list[tuple[str, ...]] = []
    for node in ast.walk(ann):
        if isinstance(node, ast.Attribute):
            chain = _dotted_chain(node)
            if chain:
                out.append(chain)
        elif isinstance(node, ast.Name):
            out.append((node.id,))
    # drop chains that are prefixes of longer collected chains (walking an
    # Attribute also yields its inner Name)
    longest = [
        c
        for c in out
        if not any(o != c and o[: len(c)] == c for o in out)
    ]
    return longest


class _FileIndex:
    """Per-file state gathered in pass 1."""

    def __init__(self, path: str, tree: ast.Module):
        self.path = path
        self.tree = tree
        self.parts = module_parts(path)
        self.is_pkg = path.replace("\\", "/").endswith("/__init__.py")
        self.imports: dict[str, tuple[str, ...]] = {}
        self.top_defs: dict[str, str] = {}  # module-level fn name -> key
        self.classes: list[ClassInfo] = []

    def expand(self, chain: tuple[str, ...]) -> tuple[str, ...]:
        """Rewrite a dotted chain's head through the import table."""
        if chain and chain[0] in self.imports:
            return self.imports[chain[0]] + chain[1:]
        return chain


class ProjectGraph:
    """All functions + resolved CALL / NESTED edges across a set of files."""

    def __init__(self) -> None:
        self.functions: dict[str, FunctionNode] = {}
        self.calls: dict[str, set[str]] = {}
        # per-call-site resolution: caller key -> [(ast.Call, callee key)]
        # — rules that report AT the call site (async-blocking-call) need
        # the node, not just the edge
        self.call_sites: dict[str, list[tuple[ast.Call, str]]] = {}
        self.nested: dict[str, set[str]] = {}
        self.classes: dict[str, ClassInfo] = {}
        self._files: dict[str, _FileIndex] = {}
        # bare function name -> importable nodes (top-level fns + methods)
        self._fn_by_name: dict[str, list[FunctionNode]] = {}
        self._class_by_name: dict[str, list[ClassInfo]] = {}
        self._subclasses: dict[str, set[str]] = {}  # class key -> subclasses
        # function key -> keys of functions defined in the same file at
        # module level (bare-name resolution scope)
        self._callers_cache: dict[str, set[str]] | None = None

    # ------------------------------------------------------------ queries
    def has_file(self, path: str) -> bool:
        return path in self._files

    def file_trees(self) -> Iterator[tuple[str, ast.Module]]:
        for path, fi in self._files.items():
            yield path, fi.tree

    def file_imports(self, path: str) -> dict[str, tuple[str, ...]]:
        """The file's import table (alias -> dotted target)."""
        fi = self._files.get(path)
        return fi.imports if fi is not None else {}

    def expand_chain(
        self, path: str, chain: tuple[str, ...]
    ) -> tuple[str, ...]:
        """Rewrite a dotted chain's head through the file's imports."""
        fi = self._files.get(path)
        return fi.expand(chain) if fi is not None else chain

    def functions_in(self, path: str) -> Iterator[FunctionNode]:
        for fn in self.functions.values():
            if fn.path == path:
                yield fn

    def callees(self, key: str) -> set[str]:
        return self.calls.get(key, set())

    def callers(self) -> dict[str, set[str]]:
        """Reverse CALL edges, computed once."""
        if self._callers_cache is None:
            rev: dict[str, set[str]] = {}
            for src, dsts in self.calls.items():
                for dst in dsts:
                    rev.setdefault(dst, set()).add(src)
            self._callers_cache = rev
        return self._callers_cache

    def class_of(self, fn: FunctionNode) -> ClassInfo | None:
        if fn.class_name is None:
            return None
        return self.classes.get(f"{fn.path}::{fn.class_name}")

    # ----------------------------------------------------------- building
    def _index_file(self, path: str, tree: ast.Module) -> None:
        fi = _FileIndex(path, tree)
        self._files[path] = fi
        self._collect_imports(fi)
        self._collect_defs(fi, tree.body, qual=(), cls=None, parent=None)

    def _collect_imports(self, fi: _FileIndex) -> None:
        for node in ast.walk(fi.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    target = tuple(alias.name.split("."))
                    if alias.asname:
                        fi.imports[alias.asname] = target
                    else:
                        fi.imports[target[0]] = target[:1]
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    # relative: strip the module name plus (level-1)
                    # packages; a package __init__ IS its package, so its
                    # parts have nothing extra to strip at level 1
                    drop = node.level - (1 if fi.is_pkg else 0)
                    base = fi.parts[: len(fi.parts) - drop]
                else:
                    base = ()
                if node.module:
                    base = base + tuple(node.module.split("."))
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    fi.imports[alias.asname or alias.name] = base + (
                        alias.name,
                    )

    def _collect_defs(
        self,
        fi: _FileIndex,
        body: Iterable[ast.stmt],
        qual: tuple[str, ...],
        cls: ClassInfo | None,
        parent: str | None,
    ) -> None:
        for stmt in body:
            if isinstance(stmt, _FN_DEFS):
                qn = ".".join(qual + (stmt.name,))
                key = f"{fi.path}::{qn}"
                fn = FunctionNode(
                    key=key,
                    path=fi.path,
                    parts=fi.parts,
                    qualname=qn,
                    name=stmt.name,
                    lineno=stmt.lineno,
                    is_async=isinstance(stmt, ast.AsyncFunctionDef),
                    node=stmt,
                    class_name=cls.name if cls is not None else None,
                    parent=parent,
                )
                self.functions[key] = fn
                if parent is None and cls is None:
                    fi.top_defs[stmt.name] = key
                if fn.dotted:
                    self._fn_by_name.setdefault(stmt.name, []).append(fn)
                if parent is not None:
                    self.nested.setdefault(parent, set()).add(key)
                if cls is not None:
                    cls.methods.setdefault(stmt.name, key)
                # nested defs inside this function
                self._collect_defs(
                    fi,
                    stmt.body,
                    qual + (stmt.name, "<locals>"),
                    cls=None,
                    parent=key,
                )
            elif isinstance(stmt, ast.ClassDef):
                bases = []
                for b in stmt.bases:
                    chain = _dotted_chain(b)
                    if chain:
                        bases.append(fi.expand(chain))
                info = ClassInfo(
                    name=stmt.name,
                    path=fi.path,
                    parts=fi.parts,
                    bases=tuple(bases),
                )
                fi.classes.append(info)
                self.classes[info.key] = info
                self._class_by_name.setdefault(stmt.name, []).append(info)
                self._collect_defs(
                    fi,
                    stmt.body,
                    qual + (stmt.name,),
                    cls=info,
                    parent=parent,
                )
            elif isinstance(
                stmt, (ast.If, ast.Try, ast.With, ast.For, ast.While)
            ):
                # defs behind guards (TYPE_CHECKING, try/except) still count
                for sub in ast.iter_child_nodes(stmt):
                    if isinstance(sub, ast.stmt):
                        self._collect_defs(fi, [sub], qual, cls, parent)

    # --------------------------------------------------------- resolution
    def _resolve_dotted_fn(self, chain: tuple[str, ...]) -> list[str]:
        """Suffix-match an import-expanded dotted chain against importable
        functions. ``("predictionio_tpu_torch","ops","topk","fetch_topk")``
        matches the node whose dotted tuple ends with it."""
        if not chain:
            return []
        cands = self._fn_by_name.get(chain[-1], [])
        out = []
        for fn in cands:
            d = fn.dotted
            if len(chain) <= len(d) and d[-len(chain):] == chain:
                out.append(fn.key)
        return out

    def _resolve_dotted_class(
        self, chain: tuple[str, ...]
    ) -> list[ClassInfo]:
        if not chain:
            return []
        out = []
        for cls in self._class_by_name.get(chain[-1], []):
            d = cls.dotted
            if len(chain) <= len(d) and d[-len(chain):] == chain:
                out.append(cls)
        return out

    def _class_hierarchy(self, cls: ClassInfo) -> list[ClassInfo]:
        """The class plus its project ancestors and descendants."""
        seen: dict[str, ClassInfo] = {}
        stack = [cls]
        while stack:  # ancestors
            c = stack.pop()
            if c.key in seen:
                continue
            seen[c.key] = c
            for base in c.bases:
                stack.extend(self._resolve_dotted_class(base))
        stack = [cls]
        visited = set()
        while stack:  # descendants
            c = stack.pop()
            if c.key in visited:
                continue
            visited.add(c.key)
            for sub_key in self._subclasses.get(c.key, ()):
                sub = self.classes.get(sub_key)
                if sub is not None and sub.key not in seen:
                    seen[sub.key] = sub
                    stack.append(sub)
        return list(seen.values())

    def _method_candidates(self, cls: ClassInfo, meth: str) -> list[str]:
        return [
            c.methods[meth]
            for c in self._class_hierarchy(cls)
            if meth in c.methods
        ]

    def _infer_attr_types(self) -> None:
        """Populate ClassInfo.attr_types from ``self.X = <typed thing>``
        assignments and annotated ``__init__`` parameters."""
        for fi in self._files.values():
            for cls in fi.classes:
                for meth_key in cls.methods.values():
                    fn = self.functions[meth_key]
                    params: dict[str, ast.AST | None] = {}
                    args = fn.node.args
                    for a in (
                        list(args.posonlyargs)
                        + list(args.args)
                        + list(args.kwonlyargs)
                    ):
                        params[a.arg] = a.annotation
                    for stmt in ast.walk(fn.node):
                        attr_name, value, ann = None, None, None
                        if isinstance(stmt, ast.Assign):
                            for tgt in stmt.targets:
                                if (
                                    isinstance(tgt, ast.Attribute)
                                    and isinstance(tgt.value, ast.Name)
                                    and tgt.value.id == "self"
                                ):
                                    attr_name, value = tgt.attr, stmt.value
                        elif isinstance(stmt, ast.AnnAssign):
                            tgt = stmt.target
                            if (
                                isinstance(tgt, ast.Attribute)
                                and isinstance(tgt.value, ast.Name)
                                and tgt.value.id == "self"
                            ):
                                attr_name, value = tgt.attr, stmt.value
                                ann = stmt.annotation
                        if attr_name is None:
                            continue
                        types: list[str] = []
                        chains: list[tuple[str, ...]] = []
                        if ann is not None:
                            chains.extend(_annotation_chains(ann))
                        if isinstance(value, ast.Call):
                            chain = _dotted_chain(value.func)
                            if chain:
                                chains.append(chain)
                        elif isinstance(value, ast.Name) and value.id in params:
                            chains.extend(
                                _annotation_chains(params[value.id])
                            )
                        elif (
                            isinstance(value, ast.BoolOp)
                            or isinstance(value, ast.IfExp)
                        ):
                            # `x or Default()` / conditional defaults
                            for sub in ast.walk(value):
                                if isinstance(sub, ast.Call):
                                    chain = _dotted_chain(sub.func)
                                    if chain:
                                        chains.append(chain)
                                elif (
                                    isinstance(sub, ast.Name)
                                    and sub.id in params
                                ):
                                    chains.extend(
                                        _annotation_chains(params[sub.id])
                                    )
                        for chain in chains:
                            for c in self._resolve_dotted_class(
                                fi.expand(chain)
                            ):
                                types.append(c.key)
                        if types:
                            merged = tuple(
                                dict.fromkeys(
                                    cls.attr_types.get(attr_name, ())
                                    + tuple(types)
                                )
                            )
                            cls.attr_types[attr_name] = merged

    def _local_var_types(
        self, fn: FunctionNode, fi: _FileIndex
    ) -> dict[str, list[ClassInfo]]:
        """``store = ArtifactStore(d)`` style local constructions, plus
        annotated parameters of the function itself."""
        out: dict[str, list[ClassInfo]] = {}
        args = fn.node.args
        for a in (
            list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)
        ):
            classes = []
            for chain in _annotation_chains(a.annotation):
                classes.extend(self._resolve_dotted_class(fi.expand(chain)))
            if classes:
                out[a.arg] = classes
        for stmt in _own_body_walk(fn.node):
            if isinstance(stmt, ast.Assign) and isinstance(
                stmt.value, ast.Call
            ):
                chain = _dotted_chain(stmt.value.func)
                if not chain:
                    continue
                classes = self._resolve_dotted_class(fi.expand(chain))
                if not classes:
                    continue
                for tgt in stmt.targets:
                    if isinstance(tgt, ast.Name):
                        out[tgt.id] = classes
        return out

    def _add_call_edges(self, fn: FunctionNode, fi: _FileIndex) -> None:
        edges = self.calls.setdefault(fn.key, set())
        sites = self.call_sites.setdefault(fn.key, [])
        own_cls = self.class_of(fn)
        local_types = self._local_var_types(fn, fi)
        # lexical scope chain of nested-def names
        scope: dict[str, str] = {}
        anc = fn
        while True:
            for k in self.nested.get(anc.key, ()):
                nested_fn = self.functions[k]
                scope.setdefault(nested_fn.name, k)
            if anc.parent is None:
                break
            anc = self.functions[anc.parent]
        for node in _own_body_walk(fn.node):
            if not isinstance(node, ast.Call):
                continue

            def add(callees: Iterable[str], node: ast.Call = node) -> None:
                for c in callees:
                    edges.add(c)
                    sites.append((node, c))

            func = node.func
            if isinstance(func, ast.Name):
                name = func.id
                if name in scope:
                    add((scope[name],))
                elif name in fi.top_defs:
                    add((fi.top_defs[name],))
                elif name in fi.imports:
                    add(self._resolve_dotted_fn(fi.imports[name]))
                continue
            chain = _dotted_chain(func)
            if not chain or len(chain) < 2:
                continue
            head, meth = chain[0], chain[-1]
            if head in ("self", "cls") and own_cls is not None:
                if len(chain) == 2:
                    add(self._method_candidates(own_cls, meth))
                elif len(chain) == 3:
                    for cls_key in own_cls.attr_types.get(chain[1], ()):
                        cls = self.classes.get(cls_key)
                        if cls is not None:
                            add(self._method_candidates(cls, meth))
                continue
            if len(chain) == 2 and head in local_types:
                for cls in local_types[head]:
                    add(self._method_candidates(cls, meth))
                continue
            add(self._resolve_dotted_fn(fi.expand(chain)))

    def _link_subclasses(self) -> None:
        for cls in self.classes.values():
            for base in cls.bases:
                for parent in self._resolve_dotted_class(base):
                    self._subclasses.setdefault(parent.key, set()).add(
                        cls.key
                    )


def _own_body_walk(
    fn: ast.FunctionDef | ast.AsyncFunctionDef,
) -> Iterator[ast.AST]:
    """Walk a function's own statements without descending into nested
    defs, classes, or lambdas — those are separate graph nodes (or, for
    lambdas, deliberately unresolved)."""
    stack: list[ast.AST] = list(fn.body)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda),
            ):
                continue
            stack.append(child)


def build_project(
    files: Iterable[tuple[str, ast.Module]],
) -> ProjectGraph:
    """Index every (path, parsed tree) pair and resolve call edges."""
    graph = ProjectGraph()
    for path, tree in files:
        graph._index_file(path, tree)
    graph._link_subclasses()
    graph._infer_attr_types()
    for fi in graph._files.values():
        for fn in graph.functions_in(fi.path):
            graph._add_call_edges(fn, fi)
    return graph
