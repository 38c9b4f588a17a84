"""Host-sync rules for the serving / predict / eval reachability scopes.

``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
``torch.cuda.synchronize()``, an Event's or Stream's ``.synchronize()`` and
a one-argument ``np.asarray``/``np.array`` of a tensor all stall the caller
until the card has finished everything queued before them and the bytes
have crossed PCIe. In a training script that is a benchmark tool; on the
serving hot path it parks a handler thread behind the card's queue and the
p99 collapses under load.

These rules are reachability-targeted: they fire in ANY function the call
graph can reach from a declared entry point of the matching category
(``LintConfig.entry_points``) — a helper three calls below
``predict_batch_dispatch`` in a module no glob names is in scope.
Legitimate syncs (startup warm-up, the one packed top-k fetch, final
response materialization) get an inline suppression with a reason.
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
from predictionio_tpu_torch.analysis.reachability import (
    CATEGORY_EVAL,
    CATEGORY_PREDICT,
    CATEGORY_SERVING,
)

register_rule(
    "hostsync-serving-path",
    "hostsync",
    Severity.ERROR,
    "blocking device->host sync (.item()/.tolist()/.cpu()/.numpy()/"
    ".to('cpu')/synchronize()/np.asarray) in a function reachable from a "
    "serving entry point; move it off the request path or suppress with "
    "a reason",
)

register_rule(
    "serving-host-roundtrip",
    "hostsync",
    Severity.ERROR,
    "device fetch or sync (.item()/.tolist()/.cpu()/.numpy()/.to('cpu')/"
    "synchronize()/one-arg np.asarray) or host argsort/argpartition on an "
    "engine predict path; fuse score+select on the card via ops/topk "
    "(host-born scores end through topk.host_top_k)",
)

_HOST_SORT_LAST2 = frozenset(
    {
        ("np", "argsort"),
        ("numpy", "argsort"),
        ("np", "argpartition"),
        ("numpy", "argpartition"),
    }
)


def _roundtrip_label(call: ast.Call) -> str | None:
    label = astutil.sync_call_label(call)
    if label is not None:
        return label
    d = astutil.dotted(call.func)
    if d:
        parts = tuple(d.split("."))
        if len(parts) >= 2 and parts[-2:] in _HOST_SORT_LAST2:
            return d + "()"
    return None


@register_checker
def check_serving_roundtrip(ctx: FileContext):
    """The engines' predict paths must route score+select through the
    fused top-k helper: flag the full-fetch/host-sort endings in every
    function reachable from a predict entry point (the declared roots —
    ``Engine.dispatch_batch``, the batchpredict drain, the ann search
    path, the eval-grid cell scorers — plus everything they call,
    including nested ``finalize`` helpers)."""
    state = ctx.project()
    findings: list[Finding] = []
    for fn, origin in state.reach.iter_reachable_in_file(
        ctx.graph_path, CATEGORY_PREDICT
    ):
        note = state.reach.reach_note(fn, origin)
        for sub in astutil.walk_skipping_nested_functions(fn.node.body):
            if not isinstance(sub, ast.Call):
                continue
            label = _roundtrip_label(sub)
            if label:
                findings.append(
                    ctx.finding(
                        "serving-host-roundtrip",
                        sub,
                        f"{label} in {fn.name!r} round-trips host-side; "
                        "route score+select through ops/topk "
                        f"(fused top-k / host_top_k){note}",
                    )
                )
    return findings


register_rule(
    "eval-per-query-predict",
    "hostsync",
    Severity.ERROR,
    "per-query .predict() call on the evaluation grid's cell scoring "
    "path; held-out queries must go through Engine.dispatch_batch "
    "mega-batches (tuning/cells.dispatch_scores) — a predict loop costs "
    "one device round-trip per held-out query per cell",
)


@register_checker
def check_eval_per_query_predict(ctx: FileContext):
    """The grid's whole reason to exist is deleting the sequential
    MetricEvaluator's per-query device round-trips; hold that property
    statically: in any function reachable from a declared cell-scoring
    entry (``dispatch_scores``/``score_cell``), a ``X.predict(...)``
    attribute call is an error. ``predict_batch``/
    ``predict_batch_dispatch``/``batch_predict`` (the batched entries
    dispatch_batch composes) are the sanctioned spellings."""
    state = ctx.project()
    findings: list[Finding] = []
    for fn, origin in state.reach.iter_reachable_in_file(
        ctx.graph_path, CATEGORY_EVAL
    ):
        note = state.reach.reach_note(fn, origin)
        for sub in astutil.walk_skipping_nested_functions(fn.node.body):
            if not isinstance(sub, ast.Call):
                continue
            func = sub.func
            if isinstance(func, ast.Attribute) and func.attr == "predict":
                findings.append(
                    ctx.finding(
                        "eval-per-query-predict",
                        sub,
                        f".predict() inside {fn.name!r} scores one query "
                        "per device round-trip; route the batch through "
                        "Engine.dispatch_batch (tuning/cells."
                        f"dispatch_scores){note}",
                    )
                )
    return findings


@register_checker
def check_hostsync(ctx: FileContext):
    """Serving-path host syncs: module-level statements in the declared
    serving entry modules, plus every function reachable from a serving
    entry point — wherever it lives."""
    state = ctx.project()
    findings: list[Finding] = []
    serving_globs = state.reach.entry_module_globs(CATEGORY_SERVING)
    if matches_any_glob(ctx.graph_path, serving_globs):
        for node in astutil.walk_skipping_nested_functions(
            astutil.module_level_statements(ctx.tree)
        ):
            if isinstance(node, ast.Call):
                label = astutil.sync_call_label(node)
                if label:
                    findings.append(
                        ctx.finding(
                            "hostsync-serving-path",
                            node,
                            f"{label} blocks on a device->host sync at "
                            "module level on the serving path",
                        )
                    )
    for fn, origin in state.reach.iter_reachable_in_file(
        ctx.graph_path, CATEGORY_SERVING
    ):
        note = state.reach.reach_note(fn, origin)
        for node in astutil.walk_skipping_nested_functions(fn.node.body):
            if not isinstance(node, ast.Call):
                continue
            label = astutil.sync_call_label(node)
            if label:
                findings.append(
                    ctx.finding(
                        "hostsync-serving-path",
                        node,
                        f"{label} blocks on a device->host sync in "
                        f"{fn.name!r} on the serving path{note}",
                    )
                )
    return findings
