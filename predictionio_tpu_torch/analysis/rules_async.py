"""``async-blocking-call``: blocking work parked on a fleet event loop.

The multi-host tier's p99 depends on three event loops never blocking: the
gateway (every in-flight proxy stalls together), the supervisor/autoscaler
loop (missed probes eject healthy replicas), and the event/serving HTTP
servers. This rule flags, inside any function *reachable from a declared
async entry point* (``LintConfig.entry_points``, category ``async-loop`` —
every ``async def`` in ``fleet/``, ``data/api/`` and the serving workflow):

- direct blocking primitives: ``time.sleep``, ``requests.*``,
  ``subprocess.run``/``check_*``, ``fcntl.flock``/``lockf``, builtin
  ``open()``, ``os.fsync``, ``socket.create_connection``;
- calls into project functions that are *transitively* blocking — the
  registry's flock'd file I/O three calls below an async handler is
  reported AT the call site in the async module, naming the primitive it
  bottoms out in.

The sanctioned pattern is the one the codebase already uses everywhere:
hand the blocking callable to ``loop.run_in_executor`` (the callable is an
*argument* there, not a call, so no edge forms — and async-loop
reachability deliberately does not flow into nested executor-delegate
defs).
"""

from __future__ import annotations

import ast
import dataclasses
from collections import deque

from predictionio_tpu_torch.analysis import astutil
from predictionio_tpu_torch.analysis.core import (
    FileContext,
    Finding,
    ProjectState,
    Severity,
    matches_any_glob,
    register_checker,
    register_rule,
)
from predictionio_tpu_torch.analysis.reachability import CATEGORY_ASYNC, short_path

register_rule(
    "async-blocking-call",
    "async",
    Severity.ERROR,
    "blocking call (time.sleep/requests/subprocess/flock/open/sync "
    "socket) on an event-loop path; hand it to loop.run_in_executor or "
    "suppress with a reason",
)

_BLOCKING_LAST2 = {
    ("time", "sleep"): "time.sleep()",
    ("subprocess", "run"): "subprocess.run()",
    ("subprocess", "call"): "subprocess.call()",
    ("subprocess", "check_call"): "subprocess.check_call()",
    ("subprocess", "check_output"): "subprocess.check_output()",
    ("subprocess", "getoutput"): "subprocess.getoutput()",
    ("subprocess", "getstatusoutput"): "subprocess.getstatusoutput()",
    ("fcntl", "flock"): "fcntl.flock()",
    ("fcntl", "lockf"): "fcntl.lockf()",
    ("os", "fsync"): "os.fsync()",
    ("os", "fdatasync"): "os.fdatasync()",
    ("socket", "create_connection"): "socket.create_connection()",
    ("io", "open"): "io.open()",
}
_REQUESTS_VERBS = frozenset(
    {"get", "post", "put", "delete", "head", "patch", "options", "request"}
)


def _blocking_primitive_label(
    call: ast.Call, expand
) -> str | None:
    """Label when ``call`` is a known blocking primitive; ``expand``
    rewrites a dotted chain's head through the file's import table, so
    ``from time import sleep; sleep(...)`` and ``import subprocess as
    sp; sp.run(...)`` both resolve."""
    func = call.func
    if isinstance(func, ast.Name):
        if func.id == "open":
            return "open()"
        chain = expand((func.id,))
        if len(chain) >= 2 and chain[-2:] in _BLOCKING_LAST2:
            return _BLOCKING_LAST2[chain[-2:]]
        return None
    d = astutil.dotted(func)
    if not d:
        return None
    chain = expand(tuple(d.split(".")))
    if len(chain) >= 2:
        last2 = chain[-2:]
        if last2 in _BLOCKING_LAST2:
            return _BLOCKING_LAST2[last2]
        if chain[0] == "requests" and chain[-1] in _REQUESTS_VERBS:
            return f"requests.{chain[-1]}()"
    return None


@dataclasses.dataclass(frozen=True)
class _BlockInfo:
    """Why a project function counts as blocking."""

    label: str  # the primitive it bottoms out in
    path: str  # file of the primitive call
    line: int
    via: str | None  # callee key it was inherited through (None = direct)


def _blocking_closure(
    ctx: FileContext, state: ProjectState
) -> dict[str, _BlockInfo]:
    """Every function that blocks, directly or through a call chain —
    reverse-propagated over CALL edges, computed once per graph."""
    if ctx.cache.get("_blocking_graph") is state.graph:
        return ctx.cache["_blocking"]
    graph = state.graph
    blocking: dict[str, _BlockInfo] = {}
    for fn in graph.functions.values():
        expand = lambda chain, path=fn.path: graph.expand_chain(path, chain)
        for node in astutil.walk_skipping_nested_functions(fn.node.body):
            if not isinstance(node, ast.Call):
                continue
            label = _blocking_primitive_label(node, expand)
            if label is not None:
                blocking[fn.key] = _BlockInfo(
                    label, fn.path, node.lineno, None
                )
                break
    callers = graph.callers()
    queue = deque(blocking)
    while queue:
        key = queue.popleft()
        info = blocking[key]
        for caller in callers.get(key, ()):
            if caller in blocking:
                continue
            blocking[caller] = _BlockInfo(
                info.label, info.path, info.line, key
            )
            queue.append(caller)
    ctx.cache["_blocking"] = blocking
    ctx.cache["_blocking_graph"] = state.graph
    return blocking


@register_checker
def check_async_blocking(ctx: FileContext):
    if not matches_any_glob(ctx.graph_path, ctx.config.async_globs):
        return []
    state = ctx.project()
    blocking = _blocking_closure(ctx, state)
    graph = state.graph
    findings: list[Finding] = []
    for fn, origin in state.reach.iter_reachable_in_file(
        ctx.graph_path, CATEGORY_ASYNC
    ):
        note = state.reach.reach_note(fn, origin)
        expand = lambda chain, path=fn.path: graph.expand_chain(path, chain)
        # direct primitives in this function's own body
        for node in astutil.walk_skipping_nested_functions(fn.node.body):
            if not isinstance(node, ast.Call):
                continue
            label = _blocking_primitive_label(node, expand)
            if label is not None:
                findings.append(
                    ctx.finding(
                        "async-blocking-call",
                        node,
                        f"{label} blocks the event loop in {fn.name!r}"
                        f"{note}; hand it to loop.run_in_executor",
                    )
                )
        # calls that bottom out in a blocking primitive elsewhere; callees
        # inside async-glob modules are skipped — they are async-reachable
        # themselves and the primitive is reported there, at its own line
        reported: set[int] = set()
        for node, callee_key in graph.call_sites.get(fn.key, ()):
            if id(node) in reported:
                continue
            info = blocking.get(callee_key)
            if info is None:
                continue
            callee = graph.functions.get(callee_key)
            if callee is None or matches_any_glob(
                callee.path, ctx.config.async_globs
            ):
                continue
            reported.add(id(node))
            findings.append(
                ctx.finding(
                    "async-blocking-call",
                    node,
                    f"call to {callee.qualname!r} does blocking "
                    f"{info.label} ({short_path(info.path)}:{info.line}) "
                    f"on the event loop in {fn.name!r}{note}; hand it to "
                    "loop.run_in_executor",
                )
            )
    return findings
