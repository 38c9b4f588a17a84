"""Stream-path rules.

``stream-unbounded-drain``: an event-store read on the stream path
without a ``limit=`` bound. The speed layer tails the event store
continuously; after downtime the backlog can be the WHOLE store, so an
unbounded ``find``/``find_after`` materializes millions of events in one
list and OOMs the host exactly when it is trying to catch up. Every read
on the stream path must carry an explicit bound (the tailer's
``batch_limit`` is the backpressure unit).

Heuristic scope: files matching ``LintConfig.stream_globs`` (the
``stream/`` package by default). To avoid flagging ``str.find`` and
other unrelated ``.find`` methods, ``find`` calls are only flagged when
the receiver looks like an event DAO (name ends with ``events`` /
``levents`` / ``pevents``) or the call carries an event-find keyword
(``app_id``/``channel_id``/``event_names``/...); ``find_after`` is
unambiguous and always checked.
"""

from __future__ import annotations

import ast

from predictionio_tpu_torch.analysis.core import (
    FileContext,
    Finding,
    Severity,
    matches_any_glob,
    register_checker,
    register_rule,
)

register_rule(
    "stream-unbounded-drain",
    "stream",
    Severity.ERROR,
    "event-store read on the stream path without a limit= bound; an "
    "unbounded drain after downtime can materialize the whole store "
    "and OOM the host",
)

_FIND_KWARGS = frozenset(
    {
        "app_id",
        "channel_id",
        "start_time",
        "until_time",
        "entity_type",
        "entity_id",
        "event_names",
        "target_entity_type",
        "target_entity_id",
        "cursor",
    }
)

_DAO_RECEIVER_SUFFIXES = ("events", "levents", "pevents", "tailer")


def _receiver_name(func: ast.Attribute) -> str:
    node = func.value
    if isinstance(node, ast.Attribute):
        return node.attr.lower()
    if isinstance(node, ast.Name):
        return node.id.lower()
    return ""


def _has_bound(call: ast.Call, positional_limit_at: int) -> bool:
    for kw in call.keywords:
        if kw.arg == "limit":
            return not (
                isinstance(kw.value, ast.Constant) and kw.value.value is None
            )
        if kw.arg is None:  # **kwargs may carry a limit; don't guess
            return True
    return len(call.args) > positional_limit_at


@register_checker
def check_unbounded_drain(ctx: FileContext):
    path = ctx.path or ctx.display_path
    if not matches_any_glob(path, ctx.config.stream_globs):
        return []
    findings: list[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call) or not isinstance(
            node.func, ast.Attribute
        ):
            continue
        name = node.func.attr
        if name == "find_after":
            # positional layout: (app_id, channel_id, cursor, limit)
            if not _has_bound(node, positional_limit_at=3):
                findings.append(
                    ctx.finding(
                        "stream-unbounded-drain",
                        node,
                        "find_after without limit=; bound the drain "
                        "(the tailer's batch_limit is the backpressure unit)",
                    )
                )
        elif name == "find":
            receiver = _receiver_name(node.func)
            dao_like = receiver.endswith(_DAO_RECEIVER_SUFFIXES)
            kw_names = {kw.arg for kw in node.keywords if kw.arg}
            if not dao_like and not (kw_names & _FIND_KWARGS):
                continue
            if "limit" not in kw_names:
                findings.append(
                    ctx.finding(
                        "stream-unbounded-drain",
                        node,
                        "event-store find without limit= on the stream "
                        "path; an unbounded read can OOM a catch-up drain",
                    )
                )
    return findings
