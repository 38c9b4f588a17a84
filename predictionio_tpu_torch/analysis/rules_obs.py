"""Observability rules for serving-path modules.

``print(...)`` and bare root-logger calls (``logging.info(...)`` et al.)
on the serving path are invisible to the telemetry layer: they bypass the
structured ``pio.trace`` JSON log (so a grep for a trace id misses them),
they can't be correlated with a request, and ``print`` additionally
flushes to an unbuffered fd inside the event loop. Serving code should
record spans (``predictionio_tpu_torch.obs.tracing.Tracer.span``) or log
through a named module logger / the structured trace logger
(``predictionio_tpu_torch.obs.tracing.get_trace_logger``).

Scope is the same ``LintConfig.serving_globs`` the host-sync family uses;
training scripts and CLIs may print freely.
"""

from __future__ import annotations

import ast
import re

from predictionio_tpu_torch.analysis import astutil
from predictionio_tpu_torch.analysis.core import (
    FileContext,
    Finding,
    Severity,
    matches_any_glob,
    register_checker,
    register_rule,
)

register_rule(
    "obs-unstructured-log",
    "obs",
    Severity.WARNING,
    "print()/bare logging.* call in a serving-path module; use the "
    "structured trace logger (obs.tracing.get_trace_logger) or a span "
    "so the output joins the request's trace",
)

register_rule(
    "obs-label-cardinality",
    "obs",
    Severity.WARNING,
    "metric label value derived from per-request data (query/user/entity "
    "ids) on the serving path; every distinct value allocates a series "
    "forever — use a bounded label, a span tag, or a histogram exemplar",
)

# direct root-logger methods: logging.info(...) etc. — a named logger
# (logging.getLogger(__name__).info) is fine and NOT matched
_ROOT_LOG_METHODS = frozenset(
    {"debug", "info", "warning", "warn", "error", "exception", "critical", "log"}
)


def _unstructured_label(call: ast.Call) -> str | None:
    func = call.func
    if isinstance(func, ast.Name) and func.id == "print":
        return "print()"
    if isinstance(func, ast.Attribute) and func.attr in _ROOT_LOG_METHODS:
        d = astutil.dotted(func)
        if d and d == f"logging.{func.attr}":
            return d + "()"
    return None


# metric-write methods whose keyword arguments are label values
_METRIC_WRITE_METHODS = frozenset({"inc", "dec", "set", "set_total", "observe"})
# keyword arguments of those methods that are NOT labels: exemplars are
# *designed* to carry per-request trace ids (bounded: one per bucket)
_NON_LABEL_KWARGS = frozenset({"exemplar", "amount", "value"})
# identifier fragments that smell like per-request data. Deliberately NOT
# matching broad-but-bounded names like "status"/"endpoint"/"app_id" —
# canonical routes and status codes are finite; query payloads, user ids,
# entity ids, and trace ids are not.
_SUSPECT_NAME_RE = re.compile(
    r"(query|queries|payload|request|trace|span|user|entity|event|qid|uid)",
    re.IGNORECASE,
)


def _suspect_names(expr: ast.AST) -> list[str]:
    """Identifier-ish names appearing anywhere in a label-value expression
    that match the per-request pattern."""
    names: list[str] = []
    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and _SUSPECT_NAME_RE.search(node.id):
            names.append(node.id)
        elif isinstance(node, ast.Attribute) and _SUSPECT_NAME_RE.search(
            node.attr
        ):
            names.append(node.attr)
    return names


@register_checker
def check_label_cardinality(ctx: FileContext):
    """Heuristic: in serving-path modules, a keyword argument to a metric
    write (``.inc(...)``/``.observe(...)``/``.set(...)``) is a label
    value; if its expression references per-request-looking data, each
    distinct request mints a new timeseries — the classic slow-leak that
    takes down both the scraper and the process. Constants are always
    fine; deliberate bounded cases suppress inline with a reason."""
    cfg = ctx.config
    if not matches_any_glob(ctx.path or ctx.display_path, cfg.serving_globs):
        return []
    findings: list[Finding] = []
    for node in ast.walk(ctx.tree):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _METRIC_WRITE_METHODS
            and node.keywords
        ):
            continue
        for kw in node.keywords:
            if kw.arg is None or kw.arg in _NON_LABEL_KWARGS:
                continue
            if isinstance(kw.value, ast.Constant):
                continue  # literal label values are bounded by definition
            suspects = _suspect_names(kw.value)
            if suspects:
                findings.append(
                    ctx.finding(
                        "obs-label-cardinality",
                        node,
                        f"label {kw.arg!r} is derived from per-request "
                        f"data ({', '.join(sorted(set(suspects)))}); every "
                        "distinct value allocates a metric series forever "
                        "— use a bounded label, a span tag, or an exemplar",
                    )
                )
    return findings


@register_checker
def check_unstructured_log(ctx: FileContext):
    cfg = ctx.config
    # absolute path when available: display paths are cwd-relative and
    # would silently miss the globs when linting from inside the package
    if not matches_any_glob(ctx.path or ctx.display_path, cfg.serving_globs):
        return []
    findings: list[Finding] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call):
            label = _unstructured_label(node)
            if label:
                findings.append(
                    ctx.finding(
                        "obs-unstructured-log",
                        node,
                        f"{label} on the serving path is invisible to the "
                        "telemetry layer; record a span or log via the "
                        "structured trace logger",
                    )
                )
    return findings
