"""SelfCleaningDataSource — time-windowed event retention + compaction.

Reference parity: ``core/.../core/SelfCleaningDataSource.scala:42-324`` — a
mixin for data sources: keep only events inside an ``EventWindow`` duration,
deduplicate identical events, compress each entity's ``$set``/``$unset``
chain to one equivalent ``$set``, and optionally write the cleaned stream
back to the store (``cleanPersistedPEvents``).

The port's own copy of ``predictionio_tpu/controller/self_cleaning.py``;
event properties are a plain dict here.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import json
import logging
from typing import Iterable

from predictionio_tpu_torch.data.aggregator import aggregate_properties
from predictionio_tpu_torch.data.event import Event, now_utc
from predictionio_tpu_torch.data.store.event_store import resolve_app
from predictionio_tpu_torch.workflow.context import WorkflowContext

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class EventWindow:
    """ref controller/EventWindow: duration like "30 days", and flags."""

    duration: _dt.timedelta | None = None
    remove_duplicates: bool = False
    compress_properties: bool = False

    @staticmethod
    def parse_duration(s: str) -> _dt.timedelta:
        value, _, unit = s.strip().partition(" ")
        n = float(value)
        unit = unit.rstrip("s")
        scale = {
            "second": 1,
            "minute": 60,
            "hour": 3600,
            "day": 86400,
            "week": 7 * 86400,
        }.get(unit)
        if scale is None:
            raise ValueError(f"cannot parse duration {s!r}")
        return _dt.timedelta(seconds=n * scale)


def _dedup_key(e: Event) -> tuple:
    return (
        e.event,
        e.entity_type,
        e.entity_id,
        e.target_entity_type,
        e.target_entity_id,
        json.dumps(e.properties, sort_keys=True),
        e.event_time,
    )


def clean_events(events: Iterable[Event], window: EventWindow) -> list[Event]:
    """Pure cleaning pass: window filter -> dedup -> $set-chain compression."""
    events = list(events)
    if window.duration is not None:
        cutoff = now_utc() - window.duration
        events = [e for e in events if e.event_time >= cutoff]
    if window.remove_duplicates:
        seen: set[tuple] = set()
        deduped = []
        for e in events:
            key = _dedup_key(e)
            if key not in seen:
                seen.add(key)
                deduped.append(e)
        events = deduped
    if window.compress_properties:
        special = [e for e in events if e.event in ("$set", "$unset", "$delete")]
        other = [e for e in events if e.event not in ("$set", "$unset", "$delete")]
        compressed: list[Event] = []
        by_type: dict[str, list[Event]] = {}
        for e in special:
            by_type.setdefault(e.entity_type, []).append(e)
        for entity_type, es in by_type.items():
            for entity_id, pm in aggregate_properties(es).items():
                compressed.append(
                    Event(
                        event="$set",
                        entity_type=entity_type,
                        entity_id=entity_id,
                        properties=dict(pm.fields),
                        event_time=pm.last_updated,
                    )
                )
        events = sorted(other + compressed, key=lambda e: e.event_time)
    return events


class SelfCleaningDataSource:
    """Mixin for DataSources. Subclasses define ``app_name`` (or params with
    one) and ``event_window``; call ``cleaned_events(ctx)`` instead of a raw
    find, or ``clean_persisted_events(ctx)`` to compact the store in place
    (ref cleanPersistedPEvents)."""

    event_window: EventWindow = EventWindow()

    def _app_name(self, ctx: WorkflowContext) -> str:
        params = getattr(self, "params", None)
        return getattr(params, "app_name", "") or ctx.app_name  # type: ignore[return-value]

    def cleaned_events(self, ctx: WorkflowContext) -> list[Event]:
        app_name = self._app_name(ctx)
        events = ctx.p_event_store().find(app_name, ctx.channel_name)
        return clean_events(events, self.event_window)

    def clean_persisted_events(self, ctx: WorkflowContext) -> int:
        """Replace the stored stream with its cleaned form. Returns the
        number of events after cleaning.

        Ordering is insert-then-delete: the cleaned events (fresh ids) go in
        first, and only then are the original ids removed. A crash in between
        leaves a recoverable superset (temporary duplicates), never a wiped
        store — unlike drop-table-then-reinsert, which loses the app's whole
        history if the process dies mid-way.
        """
        app_name = self._app_name(ctx)
        storage = ctx.storage
        app_id, channel_id = resolve_app(storage, app_name, ctx.channel_name)
        levents = storage.get_l_events()
        originals = list(storage.get_p_events().find(app_id, channel_id))
        cleaned = clean_events(originals, self.event_window)
        # strip stale event ids so re-insert assigns fresh ones
        import dataclasses as _dc

        levents.insert_batch(
            [_dc.replace(e, event_id=None) for e in cleaned], app_id, channel_id
        )
        old_ids = [e.event_id for e in originals if e.event_id]
        # batch delete: one pass for file-backed stores, one txn for SQL —
        # per-id LEvents.delete would rewrite the JSONL file O(N) times
        storage.get_p_events().delete(old_ids, app_id, channel_id)
        logger.info(
            "self-cleaning: %s now holds %d events", app_name, len(cleaned)
        )
        return len(cleaned)
