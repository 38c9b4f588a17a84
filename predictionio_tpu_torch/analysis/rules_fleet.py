"""Fleet attribution rule: no unattributed proxies or state transitions.

The fleet gateway/supervisor are the observability plane's *last*
blind spot: an outbound replica call that bypasses the span helpers is a
hop ``/traces/recent`` can never assemble into a waterfall, and a health
or lifecycle transition (eject/readmit/park/restart) that only hits a
bare logger is evidence the incident flight recorder never sees. The
``fleet-unattributed-proxy`` rule holds both to the telemetry funnel:

- an HTTP client call (``.request(...)``/``.get(...)``/``.post(...)``
  on a session-ish receiver) must live in a function that also records a
  span (``Tracer.span``/``record_span``), routes through a ``_note_*``
  telemetry helper, or fires the incident recorder — otherwise the
  forward is invisible to the trace plane;
- an assignment to replica/worker state attributes (``healthy``,
  ``parked``) must live in a function that attributes the transition the
  same way (span helper, ``_note_*``, or a metric ``.inc(...)``) —
  ``__init__`` construction is exempt (initial state is not a
  transition).

The telemetry plane's own fetches (metric federation, trace fan-in,
health probes) are the sanctioned exceptions — suppressed inline with
reasons at the three call sites, because tracing the instrument's own
traffic would recurse it into its own data.
"""

from __future__ import annotations

import ast

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
    "fleet-unattributed-proxy",
    "fleet",
    Severity.ERROR,
    "outbound replica call or replica state transition in a fleet module "
    "without span/telemetry attribution; route it through the tracer "
    "(span/record_span), a _note_* helper, or the incident recorder so "
    "the gateway hop and the eject/park timeline stay observable",
)

# HTTP verb methods that make an outbound call when invoked on a client
# session (the ClientSession / HTTPConnection surface)
_HTTP_VERBS = frozenset({"request", "get", "post", "put", "delete", "head"})

# receiver spellings that identify an HTTP client session in these
# modules: self._http()... , session.... , self._session....
_SESSION_MARKERS = ("_http", "session")

# calls that count as telemetry attribution inside the same function
_SPAN_HELPERS = frozenset({"span", "record_span"})
# replica/worker state attributes whose assignment IS a fleet transition:
# health (eject/readmit), park (crash-loop budget), and retire (scale-in
# drain) all change what the routable set means
_TRANSITION_ATTRS = frozenset({"healthy", "parked", "retiring"})


def _is_session_receiver(node: ast.AST) -> bool:
    """True when the attribute chain under an HTTP-verb call smells like
    a client session (``self._http()``, ``self._session``, ``session``)."""
    for sub in ast.walk(node):
        name = None
        if isinstance(sub, ast.Attribute):
            name = sub.attr
        elif isinstance(sub, ast.Name):
            name = sub.id
        if name and any(marker in name for marker in _SESSION_MARKERS):
            return True
    return False


def _attributes_telemetry(fn: ast.AST) -> bool:
    """Does this function route through the telemetry funnel in its OWN
    body? Span helpers, ``_note_*`` helpers, metric ``.inc``, or an
    incident ``trigger`` count — but attribution inside a *nested*
    function def does not vouch for the enclosing one (each function is
    judged alone, symmetrically with how violations are scanned)."""
    for node in _own_nodes(fn):
        if not isinstance(node, ast.Call):
            continue
        attr = astutil.last_component(node.func)
        if attr is None:
            continue
        if (
            attr in _SPAN_HELPERS
            or attr.startswith("_note_")
            or attr == "inc"
            or attr == "trigger"
        ):
            return True
    return False


def _function_nodes(tree: ast.Module):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _own_nodes(fn: ast.AST):
    """Walk a function's body WITHOUT descending into nested function
    defs (a nested helper is attributed — or not — on its own)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


@register_checker
def check_fleet_attribution(ctx: FileContext):
    cfg = ctx.config
    if not matches_any_glob(ctx.path or ctx.display_path, cfg.fleet_globs):
        return []
    findings: list[Finding] = []
    for fn in _function_nodes(ctx.tree):
        if fn.name == "__init__":
            continue  # constructing initial state is not a transition
        attributed = _attributes_telemetry(fn)
        if attributed:
            continue
        for node in _own_nodes(fn):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _HTTP_VERBS
                and _is_session_receiver(node.func.value)
            ):
                findings.append(
                    ctx.finding(
                        "fleet-unattributed-proxy",
                        node,
                        f"outbound .{node.func.attr}() in {fn.name}() has no "
                        "span/telemetry attribution; this hop is invisible "
                        "to /traces/recent — wrap it in a gateway.proxy "
                        "span or a _note_* helper",
                    )
                )
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (
                    node.targets
                    if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for target in targets:
                    if (
                        isinstance(target, ast.Attribute)
                        and target.attr in _TRANSITION_ATTRS
                    ):
                        findings.append(
                            ctx.finding(
                                "fleet-unattributed-proxy",
                                node,
                                f"state transition .{target.attr} = ... in "
                                f"{fn.name}() has no telemetry attribution; "
                                "eject/readmit/park must route through a "
                                "_note_* helper, a span, or a counter so "
                                "incident bundles can replay the timeline",
                            )
                        )
    return findings
