"""Post-promote cache warm: a bounded ``pio batchpredict``-style replay.

The result cache is in-process, per-replica, and stable-lane
only — a fresh promote starts every replica at 0% hit rate exactly when
the new model is most interesting. The warm closes that gap the only way
an out-of-process controller can: replay real queries over the serving
HTTP surface (``POST /queries.json``) so each replica's own cache fills
through the same code path production traffic uses. Misses are the
point; errors are counted, never raised — a failed warm must not undo a
good promote (the "zero client-visible 5xx" rule: warming happens on the
stable lane AFTER the bake resolved, so a dead replica here surfaces as
a warm error count, not a client failure).

Queries come from the batchpredict ``--from-events`` source (distinct
users off the event store) capped at ``limit`` — the same bounded corpus
the nightly precompute uses, so warm cost is predictable.

The port's own copy of ``predictionio_tpu/lifecycle/warm.py``.
"""

from __future__ import annotations

import json
import logging
import urllib.error
import urllib.request
from typing import Any, Callable, Iterable, Iterator

logger = logging.getLogger("predictionio_tpu_torch.lifecycle")


def replay_queries(
    serve_url: str,
    queries: Iterable[dict[str, Any]],
    *,
    limit: int = 256,
    timeout_s: float = 10.0,
) -> dict[str, int]:
    """POST up to ``limit`` queries to ``{serve_url}/queries.json`` and
    return ``{"ok": n, "error": n}``. Never raises."""
    url = serve_url.rstrip("/") + "/queries.json"
    counts = {"ok": 0, "error": 0}
    for i, query in enumerate(queries):
        if limit and i >= limit:
            break
        body = json.dumps(query).encode("utf-8")
        req = urllib.request.Request(
            url, data=body, headers={"Content-Type": "application/json"}
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                resp.read()
                counts["ok"] += 1
        except (urllib.error.URLError, OSError, ValueError):
            counts["error"] += 1
    if counts["error"]:
        logger.warning(
            "lifecycle warm: %d/%d queries failed against %s",
            counts["error"],
            counts["ok"] + counts["error"],
            url,
        )
    return counts


def event_store_queries(
    storage: Any, app_id: int, *, num: int = 10, limit: int = 256
) -> Iterator[dict[str, Any]]:
    """Bounded distinct-user queries off the event store — the
    batchpredict ``--from-events`` source, reused verbatim."""
    from predictionio_tpu_torch.workflow.batch_predict import iter_event_users

    levents = storage.get_l_events()
    for _, query in iter_event_users(levents, app_id, limit=limit, num=num):
        yield query


def build_warmer(
    serve_url: str,
    query_source: Callable[[], Iterable[dict[str, Any]]],
    *,
    limit: int = 256,
    timeout_s: float = 10.0,
) -> Callable[[str], dict[str, int]]:
    """The controller's ``warm(version)`` callable: re-materialize the
    query corpus each promote (the event store may have grown) and replay
    it. The version argument is logging-only — the gateway already routes
    the stable lane to the promoted model."""

    def warm(version: str) -> dict[str, int]:
        logger.info(
            "lifecycle warm: replaying up to %d queries for %s", limit, version
        )
        return replay_queries(
            serve_url, query_source(), limit=limit, timeout_s=timeout_s
        )

    return warm


__all__ = ["build_warmer", "event_store_queries", "replay_queries"]
