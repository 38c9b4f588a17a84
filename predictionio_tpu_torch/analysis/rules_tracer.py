"""Staging-safety rules: Python control flow and host casts on tensors
inside a staged function.

A function that ``torch.compile`` compiles, or whose work a CUDA graph
captures (``torch.cuda.graph`` blocks, ``make_graphed_callables``), must
keep data-dependent decisions on the device. A Python ``if``/``while``/
``assert`` on a tensor argument, or ``int()``/``float()``/``bool()``/
``.item()``/``.tolist()`` of one, needs the tensor's value on the host:
under ``torch.compile`` that is a graph break plus a device->host sync (and
the guard it installs recompiles on every new value); inside a CUDA graph
capture the sync is illegal and the capture fails, or — worse — the value
seen at capture time is baked into every replay. Both are deploy-time
landmines this rule family surfaces at review time.
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
    "tracer-python-branch",
    "tracer",
    Severity.ERROR,
    "Python if/while/assert branches on a tensor inside a function that "
    "torch.compile stages or a CUDA graph captures; use torch.where/"
    "torch.cond or declare the argument static (annotate it int/bool/str)",
)
register_rule(
    "tracer-host-cast",
    "tracer",
    Severity.ERROR,
    "int()/float()/bool()/.item() forces a tensor to a host scalar inside "
    "a function that torch.compile stages or a CUDA graph captures; keep "
    "the computation on-device",
)

_CAST_BUILTINS = frozenset({"int", "float", "bool"})
_CAST_METHODS = frozenset({"item", "tolist"})


def _check_staged_body(
    ctx: FileContext, body: list[ast.stmt], traced: set[str], where: str
) -> list[Finding]:
    findings: list[Finding] = []

    def visit_expr_for_casts(expr: ast.AST, traced: set[str]):
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            if (
                isinstance(node.func, ast.Name)
                and node.func.id in _CAST_BUILTINS
                and node.args
            ):
                hit = astutil.dynamic_names(node.args[0]) & traced
                if hit:
                    findings.append(
                        ctx.finding(
                            "tracer-host-cast",
                            node,
                            f"{node.func.id}() on tensor "
                            f"{'/'.join(sorted(hit))!r} inside {where}",
                        )
                    )
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _CAST_METHODS
                and not node.args
            ):
                hit = astutil.dynamic_names(node.func.value) & traced
                if hit:
                    findings.append(
                        ctx.finding(
                            "tracer-host-cast",
                            node,
                            f".{node.func.attr}() on tensor "
                            f"{'/'.join(sorted(hit))!r} inside {where}",
                        )
                    )

    def visit_stmts(body: list[ast.stmt], traced: set[str]):
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue  # nested scopes get their own decoration check
            if isinstance(stmt, (ast.If, ast.While)):
                hit = astutil.dynamic_names(stmt.test) & traced
                if hit:
                    kw = "while" if isinstance(stmt, ast.While) else "if"
                    findings.append(
                        ctx.finding(
                            "tracer-python-branch",
                            stmt,
                            f"Python `{kw}` on tensor "
                            f"{'/'.join(sorted(hit))!r} inside {where}; "
                            f"use torch.where/torch.cond or keep the "
                            f"decision on the device",
                        )
                    )
                visit_expr_for_casts(stmt.test, traced)
                visit_stmts(stmt.body, set(traced))
                visit_stmts(stmt.orelse, set(traced))
                continue
            if isinstance(stmt, ast.Assert):
                hit = astutil.dynamic_names(stmt.test) & traced
                if hit:
                    findings.append(
                        ctx.finding(
                            "tracer-python-branch",
                            stmt,
                            f"`assert` on tensor "
                            f"{'/'.join(sorted(hit))!r} inside {where}; "
                            f"use torch._assert_async or assert on static "
                            f"shape/dtype only",
                        )
                    )
                visit_expr_for_casts(stmt.test, traced)
                continue
            if isinstance(stmt, ast.Assign):
                visit_expr_for_casts(stmt.value, traced)
                tainted = bool(astutil.dynamic_names(stmt.value) & traced)
                for target in stmt.targets:
                    if isinstance(target, ast.Name):
                        if tainted:
                            traced.add(target.id)
                        else:
                            traced.discard(target.id)
                continue
            if isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
                if stmt.value is not None:
                    visit_expr_for_casts(stmt.value, traced)
                    if isinstance(stmt.target, ast.Name) and (
                        astutil.dynamic_names(stmt.value) & traced
                    ):
                        traced.add(stmt.target.id)
                continue
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                visit_expr_for_casts(stmt.iter, traced)
                inner = set(traced)
                if astutil.dynamic_names(stmt.iter) & traced and isinstance(
                    stmt.target, ast.Name
                ):
                    inner.add(stmt.target.id)
                visit_stmts(stmt.body, inner)
                visit_stmts(stmt.orelse, set(traced))
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                visit_stmts(stmt.body, traced)
                continue
            if isinstance(stmt, ast.Try):
                visit_stmts(stmt.body, set(traced))
                for handler in stmt.handlers:
                    visit_stmts(handler.body, set(traced))
                visit_stmts(stmt.orelse, set(traced))
                visit_stmts(stmt.finalbody, set(traced))
                continue
            # leaf statements: scan any embedded expressions for casts
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    visit_expr_for_casts(child, traced)

    visit_stmts(body, set(traced))
    return findings


def _kind_text(kind: str, name: str) -> str:
    if kind == "compile":
        return f"compiled function {name!r}"
    return f"CUDA-graph-captured function {name!r}"


@register_checker
def check_tracer_safety(ctx: FileContext):
    if "torch" not in ctx.source and "cuda" not in ctx.source:
        return []
    findings: list[Finding] = []
    wrapped = astutil.wrapped_function_names(ctx.tree)
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        info = astutil.jit_decorator_info(node) or wrapped.get(node.name)
        traced = astutil.traced_param_names(node)
        if info is not None:
            if traced:
                findings.extend(
                    _check_staged_body(
                        ctx, node.body, traced, _kind_text(info.kind, node.name)
                    )
                )
            continue
        # `with torch.cuda.graph(g):` blocks capture what their body runs
        for sub in astutil.walk_skipping_nested_functions(node.body):
            if isinstance(sub, (ast.With, ast.AsyncWith)) and any(
                astutil.capture_info(item.context_expr) for item in sub.items
            ):
                if traced:
                    findings.extend(
                        _check_staged_body(
                            ctx,
                            sub.body,
                            traced,
                            f"the CUDA graph capture in {node.name!r}",
                        )
                    )
    return findings
