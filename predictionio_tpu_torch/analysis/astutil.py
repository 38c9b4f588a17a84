"""Shared AST helpers for the rule modules.

The staging detection here is *syntactic*: it recognizes the idioms this
codebase (and PyTorch code generally) uses to hand a function to a
compiler or a CUDA graph — ``@torch.compile``, ``@torch.compile(mode=...)``,
``functools.partial(torch.compile, ...)``, ``torch.compile(fn, ...)`` and
``torch.cuda.make_graphed_callables(fn, ...)`` as expressions, and
``with torch.cuda.graph(g):`` capture blocks — without importing torch or
resolving names. False negatives from exotic aliasing
(``mycompile = torch.compile``) are acceptable; false positives are not.

Where the JAX analyzer reads ``static_argnums``/``static_argnames``, a
staged torch function declares a parameter static by annotating it with a
Python scalar type (``mode: str``, ``n: int``): its guards specialise on
each value by design, and branching on it is not a hazard.
"""

from __future__ import annotations

import ast
import dataclasses

# dotted spellings of the staging transforms
COMPILE_CHAINS = frozenset({"torch.compile"})
GRAPHED_CALLABLE_CHAINS = frozenset(
    {"torch.cuda.make_graphed_callables", "cuda.make_graphed_callables"}
)
GRAPH_CAPTURE_CHAINS = frozenset({"torch.cuda.graph", "cuda.graph"})

# attribute reads that are static under staging (safe to branch on)
STATIC_ATTRS = frozenset(
    {"shape", "ndim", "dtype", "device", "is_cuda", "layout", "requires_grad", "size"}
)
# tensor methods whose result is static metadata, not data
STATIC_METHODS = frozenset(
    {"size", "dim", "numel", "nelement", "element_size", "is_floating_point",
     "is_contiguous", "get_device"}
)
# builtin calls whose result is static even on a staged argument
STATIC_CALLS = frozenset({"len", "isinstance", "hasattr", "getattr", "type"})
# annotations that declare a parameter a compile-time constant
STATIC_ANNOTATIONS = frozenset({"int", "float", "bool", "str"})

MUTATING_METHODS = frozenset(
    {
        "append",
        "extend",
        "insert",
        "add",
        "update",
        "pop",
        "popitem",
        "clear",
        "remove",
        "discard",
        "setdefault",
        "appendleft",
        "extendleft",
    }
)

MUTABLE_FACTORIES = frozenset(
    {"dict", "list", "set", "defaultdict", "OrderedDict", "Counter", "deque"}
)


def dotted(node: ast.AST) -> str | None:
    """'torch.cuda.synchronize' for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def last_component(node: ast.AST) -> str | None:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


@dataclasses.dataclass(frozen=True)
class JitInfo:
    """What a staging transform declares: its kind (``compile``,
    ``graphed`` for make_graphed_callables, ``graph`` for a capture
    block) and, for ``torch.compile``, whether ``dynamic=True`` asked for
    symbolic Python numbers."""

    kind: str
    dynamic: bool = False


def _dynamic_kw(keywords: list[ast.keyword]) -> bool:
    return any(
        kw.arg == "dynamic"
        and isinstance(kw.value, ast.Constant)
        and kw.value.value is True
        for kw in keywords
    )


def _chain_kind(expr: ast.AST) -> str | None:
    d = dotted(expr)
    if d in COMPILE_CHAINS:
        return "compile"
    if d in GRAPHED_CALLABLE_CHAINS:
        return "graphed"
    return None


def jit_expr_info(expr: ast.AST) -> JitInfo | None:
    """JitInfo when ``expr`` denotes a staging transform (bare, called
    with options, or partial'd)."""
    kind = _chain_kind(expr)
    if kind is not None:
        return JitInfo(kind)
    if isinstance(expr, ast.Call):
        func_last = last_component(expr.func)
        if func_last == "partial" and expr.args:
            inner = _chain_kind(expr.args[0])
            if inner is not None:
                return JitInfo(inner, _dynamic_kw(expr.keywords))
        kind = _chain_kind(expr.func)
        if kind is not None:
            # torch.compile(fn, mode=...) / torch.compile(mode=...) used as
            # expression or decorator factory
            return JitInfo(kind, _dynamic_kw(expr.keywords))
    return None


def capture_info(expr: ast.AST) -> JitInfo | None:
    """JitInfo when ``expr`` opens a CUDA graph capture
    (``torch.cuda.graph(g)`` as a with-item)."""
    if isinstance(expr, ast.Call) and dotted(expr.func) in GRAPH_CAPTURE_CHAINS:
        return JitInfo("graph")
    return None


def jit_decorator_info(
    fn: ast.FunctionDef | ast.AsyncFunctionDef,
) -> JitInfo | None:
    for dec in fn.decorator_list:
        info = jit_expr_info(dec)
        if info is not None:
            return info
    return None


def wrapped_function_names(tree: ast.Module) -> dict[str, JitInfo]:
    """Functions handed to a staging transform by name anywhere in the
    module (``step = torch.compile(_step)``,
    ``torch.cuda.make_graphed_callables(fwd, args)``)."""
    out: dict[str, JitInfo] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and node.args:
            kind = _chain_kind(node.func)
            if kind is not None and isinstance(node.args[0], ast.Name):
                out.setdefault(
                    node.args[0].id, JitInfo(kind, _dynamic_kw(node.keywords))
                )
    return out


def is_static_annotation(ann: ast.AST | None) -> bool:
    """``n: int`` / ``mode: "str"`` declare a compile-time constant."""
    if isinstance(ann, ast.Name):
        return ann.id in STATIC_ANNOTATIONS
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value in STATIC_ANNOTATIONS
    return False


def param_names(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> list[str]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args]
    if a.vararg:
        names.append(a.vararg.arg)
    names += [p.arg for p in a.kwonlyargs]
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


def static_param_names(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> set[str]:
    a = fn.args
    return {
        p.arg
        for p in a.posonlyargs + a.args + a.kwonlyargs
        if is_static_annotation(p.annotation)
    }


def traced_param_names(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> set[str]:
    """Parameters that carry tensors into a staged function: every
    parameter but ``self``/``cls`` and those annotated as Python
    scalars."""
    a = fn.args
    traced = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}
    traced -= static_param_names(fn)
    traced -= {"self", "cls"}
    return traced


def dynamic_names(node: ast.AST) -> set[str]:
    """Names whose *concrete value* the expression inspects.

    ``x.shape[0]``, ``x.size(0)``, ``len(x)``, ``isinstance(x, T)`` and
    ``x is None`` are static under staging and contribute nothing; a bare
    ``x`` (or ``x + 1``, ``x[0] > 0`` ...) needs the tensor's data and
    contributes ``x``.
    """
    if isinstance(node, ast.Name):
        return {node.id}
    if isinstance(node, ast.Attribute):
        if node.attr in STATIC_ATTRS:
            return set()
        return dynamic_names(node.value)
    if isinstance(node, ast.Call):
        func_last = last_component(node.func)
        if isinstance(node.func, ast.Name) and func_last in STATIC_CALLS:
            return set()
        if isinstance(node.func, ast.Attribute) and func_last in STATIC_METHODS:
            return set()
        out = set()
        if isinstance(node.func, ast.Attribute):
            out |= dynamic_names(node.func.value)
        for arg in node.args:
            out |= dynamic_names(arg)
        for kw in node.keywords:
            out |= dynamic_names(kw.value)
        return out
    if isinstance(node, ast.Compare) and all(
        isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops
    ):
        # `x is None` / `x is not None` inspect identity, not the value
        return set()
    out = set()
    for child in ast.iter_child_nodes(node):
        out |= dynamic_names(child)
    return out


def is_mutable_literal(node: ast.AST) -> bool:
    return isinstance(
        node,
        (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp, ast.SetComp),
    )


def is_mutable_factory_call(node: ast.AST) -> bool:
    if isinstance(node, ast.Call):
        last = last_component(node.func)
        return last in MUTABLE_FACTORIES
    return False


def module_level_statements(tree: ast.Module) -> list[ast.stmt]:
    """Statements that execute at import time: module body plus class
    bodies, excluding every function body (functions are call-graph nodes
    and get reachability-scoped treatment instead)."""
    out: list[ast.stmt] = []

    def collect(body: list[ast.stmt]) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(stmt, ast.ClassDef):
                collect(stmt.body)
                continue
            out.append(stmt)

    collect(tree.body)
    return out


def walk_skipping_nested_functions(body: list[ast.stmt]):
    """Yield every node in ``body`` without descending into nested
    function/class definitions (their scopes are analyzed separately)."""
    stack: list[ast.AST] = list(body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)
        ):
            continue
        stack.extend(ast.iter_child_nodes(node))


# methods that copy a tensor to the host (called without arguments), and
# the card-wide / event / stream wait
_FETCH_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
_WAIT_METHODS = frozenset({"synchronize"})
_ASARRAY_LAST2 = frozenset(
    {
        ("np", "asarray"),
        ("numpy", "asarray"),
        ("np", "array"),
        ("numpy", "array"),
    }
)


def _is_cpu_target(node: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant) and node.value == "cpu":
        return True
    return (
        isinstance(node, ast.Call)
        and last_component(node.func) == "device"
        and bool(node.args)
        and isinstance(node.args[0], ast.Constant)
        and node.args[0].value == "cpu"
    )


def sync_call_label(call: ast.Call) -> str | None:
    """A human label when ``call`` is a blocking device->host sync,
    else None. One-argument ``np.asarray``/``np.array`` only: the two-
    argument ``np.asarray(x, np.float32)`` form is this codebase's host
    conversion idiom."""
    func = call.func
    if not isinstance(func, ast.Attribute):
        return None
    if (func.attr in _FETCH_METHODS and not call.args) or func.attr in _WAIT_METHODS:
        d = dotted(func)
        return (d if d and d.startswith("torch.") else f".{func.attr}") + "()"
    if func.attr == "to" and (
        any(_is_cpu_target(a) for a in call.args[:1])
        or any(kw.arg == "device" and _is_cpu_target(kw.value) for kw in call.keywords)
    ):
        return ".to('cpu')"
    d = dotted(func)
    if d:
        parts = tuple(d.split("."))
        if (
            len(parts) >= 2
            and parts[-2:] in _ASARRAY_LAST2
            and len(call.args) == 1
            and not call.keywords
        ):
            return d + "()"
    return None
