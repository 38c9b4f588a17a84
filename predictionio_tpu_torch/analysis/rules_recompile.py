"""Recompile-hazard rules.

``torch.compile`` caches a graph per set of guards: tensor shapes, dtypes
and devices, and the *value* of every Python scalar, string and container
structure the function was called with. A CUDA graph is a capture of one
call. Three idioms silently defeat the cache and turn the serving hot path
into a compile loop:

- passing Python literals (bools, numbers, strings, lists/dicts) to a
  compiled function at parameters not declared static (annotated with
  their Python type) — each distinct value or structure installs a new
  guard and compiles again;
- building the compiled wrapper itself inside a loop (``torch.compile(f)``
  or a CUDA graph capture per request) — a fresh wrapper means a fresh
  cache, a fresh capture means a fresh graph;
- a compiled closure capturing mutable enclosing state — a compiled graph
  guards on it and recompiles at every mutation, and a captured CUDA
  graph replays the value it saw at capture time.
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
    "recompile-unhashable-arg",
    "recompile",
    Severity.WARNING,
    "literal bool/number/str/list/dict argument to a compiled function at "
    "a parameter not declared static (annotated int/bool/str); each "
    "distinct value or structure installs a guard and recompiles",
)
register_rule(
    "recompile-jit-in-loop",
    "recompile",
    Severity.WARNING,
    "torch.compile wrapper or CUDA graph capture constructed inside a "
    "loop; every iteration gets a fresh compilation cache or graph",
)
register_rule(
    "recompile-closure-capture",
    "recompile",
    Severity.WARNING,
    "compiled closure captures mutable enclosing state; every mutation "
    "fails a guard and recompiles (a captured CUDA graph replays the "
    "value it saw)",
)


def _collect_jitted_defs(
    tree: ast.Module,
) -> dict[str, tuple[astutil.JitInfo, list[str] | None, set[str]]]:
    """Module-level compiled defs: ``@torch.compile def f`` and
    ``f = torch.compile(g, ...)``. Maps name -> (staging info, positional
    param names when the def is visible — needed to resolve static
    parameters passed positionally — and the static parameter names)."""
    defs: dict[str, ast.FunctionDef | ast.AsyncFunctionDef] = {
        stmt.name: stmt
        for stmt in tree.body
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
    }

    def params(fn):
        if fn is None:
            return None, set()
        return (
            [p.arg for p in fn.args.posonlyargs + fn.args.args],
            astutil.static_param_names(fn),
        )

    out: dict[str, tuple[astutil.JitInfo, list[str] | None, set[str]]] = {}
    for stmt in tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            info = astutil.jit_decorator_info(stmt)
            if info is not None:
                out[stmt.name] = (info, *params(stmt))
        elif isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call):
            info = astutil.jit_expr_info(stmt.value)
            if info is not None:
                # f = torch.compile(g): reuse g's params when g is a local def
                inner = (
                    stmt.value.args[0].id
                    if stmt.value.args
                    and isinstance(stmt.value.args[0], ast.Name)
                    else None
                )
                for target in stmt.targets:
                    if isinstance(target, ast.Name):
                        out[target.id] = (info, *params(defs.get(inner)))
    return out


def _literal_kind(node: ast.AST, dynamic: bool) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, bool):
        return "bool"
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return "str"
    # dynamic=True makes Python numbers symbolic: no guard on the value
    if (
        not dynamic
        and isinstance(node, ast.Constant)
        and isinstance(node.value, (int, float))
    ):
        return "number"
    if isinstance(node, (ast.List, ast.ListComp)):
        return "list"
    if isinstance(node, (ast.Dict, ast.DictComp)):
        return "dict"
    if isinstance(node, (ast.Set, ast.SetComp)):
        return "set"
    return None


def _check_call_args(
    ctx: FileContext,
    call: ast.Call,
    name: str,
    info: astutil.JitInfo,
    params: list[str] | None,
    static: set[str],
) -> list[Finding]:
    findings = []
    for i, arg in enumerate(call.args):
        # a static parameter passed positionally: credit it when the def's
        # params are visible
        if params and i < len(params) and params[i] in static:
            continue
        kind = _literal_kind(arg, info.dynamic)
        if kind:
            findings.append(
                ctx.finding(
                    "recompile-unhashable-arg",
                    arg,
                    f"{kind} literal passed to compiled {name!r} at position "
                    f"{i}, a parameter not declared static; annotate it "
                    f"with its Python type or hoist it out of the call",
                )
            )
    for kw in call.keywords:
        if kw.arg is None or kw.arg in static:
            continue
        kind = _literal_kind(kw.value, info.dynamic)
        if kind:
            findings.append(
                ctx.finding(
                    "recompile-unhashable-arg",
                    kw.value,
                    f"{kind} literal passed to compiled {name!r} as "
                    f"{kw.arg}=, a parameter not declared static; annotate "
                    f"it with its Python type or hoist it out of the call",
                )
            )
    return findings


_WRAPPER_TEXT = {
    "compile": "torch.compile wrapper",
    "graphed": "make_graphed_callables capture",
    "graph": "CUDA graph capture",
}


def _check_jit_in_loops(ctx: FileContext) -> list[Finding]:
    findings: list[Finding] = []
    seen: set[int] = set()

    def flag(sub: ast.AST, info: astutil.JitInfo):
        if id(sub) in seen:
            return
        seen.add(id(sub))
        findings.append(
            ctx.finding(
                "recompile-jit-in-loop",
                sub,
                f"{_WRAPPER_TEXT[info.kind]} constructed inside a loop; "
                f"hoist it out so the compiled code survives iterations",
            )
        )

    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
            continue
        # stay out of nested defs: a function *defined* in the loop body
        # runs later, not per iteration — but its torch.compile decoration
        # DOES construct a fresh wrapper each time through the loop
        for sub in astutil.walk_skipping_nested_functions(
            node.body + node.orelse
        ):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in sub.decorator_list:
                    info = astutil.jit_expr_info(dec)
                    if info is not None:
                        flag(dec, info)
            elif isinstance(sub, ast.Call):
                info = astutil.jit_expr_info(sub) or astutil.capture_info(sub)
                if info is not None:
                    flag(sub, info)
    return findings


def _mutable_locals(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> set[str]:
    """Names the enclosing function binds to mutable containers or mutates."""
    out: set[str] = set()
    for node in astutil.walk_skipping_nested_functions(fn.body):
        if isinstance(node, ast.Assign):
            if astutil.is_mutable_literal(node.value) or (
                astutil.is_mutable_factory_call(node.value)
            ):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out.add(t.id)
        elif isinstance(node, ast.AugAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr in astutil.MUTATING_METHODS and isinstance(
                node.func.value, ast.Name
            ):
                out.add(node.func.value.id)
    return out


def _free_reads(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> set[str]:
    bound = set(astutil.param_names(fn))
    reads: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Name):
            if isinstance(node.ctx, (ast.Store, ast.Del)):
                bound.add(node.id)
            else:
                reads.add(node.id)
    return reads - bound


def _check_closure_capture(ctx: FileContext) -> list[Finding]:
    findings: list[Finding] = []
    for outer in ast.walk(ctx.tree):
        if not isinstance(outer, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        mutable = _mutable_locals(outer)
        if not mutable:
            continue
        for inner in ast.walk(outer):
            if inner is outer or not isinstance(
                inner, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                continue
            if astutil.jit_decorator_info(inner) is None:
                continue
            hits = _free_reads(inner) & mutable
            if hits:
                findings.append(
                    ctx.finding(
                        "recompile-closure-capture",
                        inner,
                        f"compiled {inner.name!r} captures mutable enclosing "
                        f"state {'/'.join(sorted(hits))!r}; every mutation "
                        f"recompiles — pass it as an argument instead",
                    )
                )
    return findings


@register_checker
def check_recompile_hazards(ctx: FileContext):
    # every hazard here needs a staging transform somewhere in the file;
    # the substring test skips the three tree walks for the files with
    # none (lint wall-clock budget)
    if "compile" not in ctx.source and "graph" not in ctx.source:
        return []
    findings: list[Finding] = []
    jitted = _collect_jitted_defs(ctx.tree)
    if jitted:
        for node in ast.walk(ctx.tree):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id in jitted
            ):
                info, params, static = jitted[node.func.id]
                findings.extend(
                    _check_call_args(ctx, node, node.func.id, info, params, static)
                )
    findings.extend(_check_jit_in_loops(ctx))
    findings.extend(_check_closure_capture(ctx))
    return findings
