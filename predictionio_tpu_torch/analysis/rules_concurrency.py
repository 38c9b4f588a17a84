"""Concurrency rules: unlocked module-level mutable state in threaded files.

A module that spawns threads (``threading.Thread``, ``ThreadPoolExecutor``)
and mutates module-level dicts/lists/sets from function bodies without a
visible lock is a data race waiting for traffic: CPython's GIL makes single
bytecodes atomic, not read-modify-write sequences like ``d[k] = d.get(k)+1``
(the event-server stats pattern). The check is structural: the mutation must
happen lexically inside a ``with <lock>:`` block, where ``<lock>`` is a name
bound to ``threading.Lock()``/``RLock()``/... at module level or any dotted
name containing "lock".
"""

from __future__ import annotations

import ast

from predictionio_tpu_torch.analysis import astutil
from predictionio_tpu_torch.analysis.core import (
    FileContext,
    Finding,
    Severity,
    register_checker,
    register_rule,
)

register_rule(
    "concurrency-unlocked-global",
    "concurrency",
    Severity.WARNING,
    "module-level mutable state mutated in a thread-spawning module "
    "without holding a visible lock",
)

_THREAD_FACTORIES = frozenset(
    {"Thread", "ThreadPoolExecutor", "Timer", "start_new_thread"}
)
_LOCK_FACTORIES = frozenset(
    {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}
)


def _is_threaded_module(tree: ast.Module) -> bool:
    """Spawns threads — or imports threading at all: a module holding a
    lock advertises that its module state is reached from worker threads
    even when the Thread() call lives in a caller."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            last = astutil.last_component(node.func)
            if last in _THREAD_FACTORIES:
                return True
        elif isinstance(node, ast.Import):
            if any(a.name.split(".")[0] == "threading" for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom):
            if (node.module or "").split(".")[0] in ("threading", "concurrent"):
                return True
    return False


def _module_state(tree: ast.Module) -> tuple[set[str], set[str]]:
    """(mutable global names, lock names) bound at module level."""
    mutable: set[str] = set()
    locks: set[str] = set()
    for stmt in tree.body:
        targets: list[ast.expr] = []
        value: ast.expr | None = None
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        if value is None:
            continue
        is_lock = (
            isinstance(value, ast.Call)
            and astutil.last_component(value.func) in _LOCK_FACTORIES
        )
        is_mutable = astutil.is_mutable_literal(value) or astutil.is_mutable_factory_call(
            value
        )
        for t in targets:
            if not isinstance(t, ast.Name):
                continue
            if is_lock:
                locks.add(t.id)
            elif is_mutable:
                mutable.add(t.id)
    return mutable, locks


def _with_holds_lock(stmt: ast.With | ast.AsyncWith, locks: set[str]) -> bool:
    for item in stmt.items:
        expr = item.context_expr
        # `with lock:` / `with self._lock:` / `with _lock.acquire_timeout():`
        d = astutil.dotted(expr) or astutil.dotted(
            expr.func if isinstance(expr, ast.Call) else expr
        )
        if not d:
            continue
        parts = d.lower().split(".")
        if any(p in {l.lower() for l in locks} or "lock" in p for p in parts):
            return True
    return False


def _mutation_target(node: ast.AST, mutable: set[str]) -> str | None:
    """The mutated global name when ``node`` mutates one, else None."""
    if isinstance(node, ast.AugAssign):
        root = node.target
        while isinstance(root, (ast.Subscript, ast.Attribute)):
            root = root.value
        if isinstance(root, ast.Name) and root.id in mutable:
            return root.id
    elif isinstance(node, ast.Assign):
        for t in node.targets:
            root = t
            while isinstance(root, (ast.Subscript, ast.Attribute)):
                root = root.value
            if isinstance(root, ast.Name) and root.id in mutable and root is not t:
                # subscript/attribute store into the container; a bare
                # rebinding of the module name needs `global`, handled below
                return root.id
    elif isinstance(node, ast.Delete):
        for t in node.targets:
            if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name):
                if t.value.id in mutable:
                    return t.value.id
    elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        if node.func.attr in astutil.MUTATING_METHODS and isinstance(
            node.func.value, ast.Name
        ):
            if node.func.value.id in mutable:
                return node.func.value.id
    return None


@register_checker
def check_unlocked_globals(ctx: FileContext):
    if not _is_threaded_module(ctx.tree):
        return []
    mutable, locks = _module_state(ctx.tree)
    if not mutable:
        return []
    findings: list[Finding] = []

    def visit(body: list[ast.stmt], held: bool, global_decls: set[str]):
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a nested def starts with no lock held: it may be called
                # from anywhere, not just from under this `with`
                visit(stmt.body, False, set())
                continue
            if isinstance(stmt, ast.ClassDef):
                visit(stmt.body, held, set())
                continue
            if isinstance(stmt, ast.Global):
                global_decls.update(stmt.names)
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                visit(
                    stmt.body,
                    held or _with_holds_lock(stmt, locks),
                    global_decls,
                )
                continue
            if isinstance(stmt, (ast.If, ast.While, ast.For, ast.AsyncFor)):
                visit(stmt.body, held, global_decls)
                visit(stmt.orelse, held, global_decls)
                continue
            if isinstance(stmt, ast.Try):
                visit(stmt.body, held, global_decls)
                for h in stmt.handlers:
                    visit(h.body, held, global_decls)
                visit(stmt.orelse, held, global_decls)
                visit(stmt.finalbody, held, global_decls)
                continue
            if held:
                continue
            name = None
            for node in astutil.walk_skipping_nested_functions([stmt]):
                name = _mutation_target(node, mutable)
                if name:
                    break
                # `global g; g = ...` rebinding races against readers too
                if (
                    isinstance(node, ast.Assign)
                    and any(
                        isinstance(t, ast.Name) and t.id in global_decls
                        for t in node.targets
                    )
                ):
                    hits = [
                        t.id
                        for t in node.targets
                        if isinstance(t, ast.Name) and t.id in global_decls
                    ]
                    name = hits[0]
                    break
            if name:
                findings.append(
                    ctx.finding(
                        "concurrency-unlocked-global",
                        stmt,
                        f"module-level mutable {name!r} mutated without a "
                        f"visible lock in a module that spawns threads",
                    )
                )

    # module body itself runs single-threaded at import; only functions race
    for stmt in ctx.tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            visit(stmt.body, False, set())
        elif isinstance(stmt, ast.ClassDef):
            for sub in stmt.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    visit(sub.body, False, set())
    return findings
