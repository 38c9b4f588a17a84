"""Event-server ingestion statistics.

Reference parity: ``data/.../api/Stats.scala:18-82`` + ``StatsActor.scala:35-77``
— per-app counters keyed by HTTP status code and by
(entityType, targetEntityType, event), kept for the current hour and for the
server lifetime, surfaced at ``/stats.json``.

The lifetime store is a pair of labelled counters; hourly windows are
derived by snapshotting counter values at hour boundaries and reporting the
diff. The response shape (``currentHour`` / ``longLive`` / ``prevHour``) is
the JAX package's.

The port's own copy of ``predictionio_tpu/data/api/stats.py``: the
counters (``pio_events_ingested_total`` / ``pio_events_by_type_total``)
live in the event server's metrics registry, so a scrape of ``/metrics``
and ``/stats.json`` read the same numbers.
"""

from __future__ import annotations

import datetime as _dt
import threading
from typing import Any

from predictionio_tpu_torch.data.event import UTC, Event, format_event_time
from predictionio_tpu_torch.obs.metrics import Counter, MetricsRegistry

# counters store label values as strings; None target_entity_type maps to ""
_NONE_TARGET = ""


def _snapshot_counter(counter: Counter) -> dict[tuple[str, ...], float]:
    return dict(counter.collect())


def _diff(
    current: dict[tuple[str, ...], float], base: dict[tuple[str, ...], float]
) -> dict[tuple[str, ...], float]:
    out: dict[tuple[str, ...], float] = {}
    for key, value in current.items():
        delta = value - base.get(key, 0.0)
        if delta > 0:
            out[key] = delta
    return out


class StatsCollector:
    """Hourly + lifetime ingestion stats on top of the metrics registry
    (ref StatsActor hour-bucketing)."""

    def __init__(self, registry: MetricsRegistry | None = None):
        self.registry = registry or MetricsRegistry()
        self._status = self.registry.counter(
            "pio_events_ingested_total",
            "events accepted by the collection API, by app and HTTP status",
            labelnames=("app_id", "status"),
        )
        self._ete = self.registry.counter(
            "pio_events_by_type_total",
            "events accepted by the collection API, by app and "
            "(entityType, targetEntityType, event)",
            labelnames=("app_id", "entity_type", "target_entity_type", "event"),
        )
        now = _dt.datetime.now(tz=UTC)
        self._lock = threading.Lock()
        self._start_time = now
        self._hour_start = self._floor_hour(now)
        # counter values at the start of the current hourly window
        self._hour_base_status: dict[tuple[str, ...], float] = {}
        self._hour_base_ete: dict[tuple[str, ...], float] = {}
        # (start, end, status_diff, ete_diff) of the completed previous hour
        self._prev_hour: (
            tuple[
                _dt.datetime,
                _dt.datetime,
                dict[tuple[str, ...], float],
                dict[tuple[str, ...], float],
            ]
            | None
        ) = None

    @staticmethod
    def _floor_hour(t: _dt.datetime) -> _dt.datetime:
        return t.replace(minute=0, second=0, microsecond=0)

    def _roll(self, now: _dt.datetime) -> None:
        """Close the hourly window when the wall clock crosses an hour
        boundary: the finished window becomes ``prevHour`` (as a diff of
        counter snapshots) and the new window re-bases."""
        hour = self._floor_hour(now)
        if hour <= self._hour_start:
            return
        status_now = _snapshot_counter(self._status)
        ete_now = _snapshot_counter(self._ete)
        self._prev_hour = (
            self._hour_start,
            hour,
            _diff(status_now, self._hour_base_status),
            _diff(ete_now, self._hour_base_ete),
        )
        self._hour_base_status = status_now
        self._hour_base_ete = ete_now
        self._hour_start = hour

    def bookkeeping(self, app_id: int, status_code: int, event: Event) -> None:
        # both increments happen under the collector lock so an hour-roll
        # snapshot can never observe one counter updated and not the other
        # (statusCode vs basic totals must always agree per window)
        with self._lock:
            self._roll(_dt.datetime.now(tz=UTC))
            self._status.inc(app_id=str(app_id), status=str(status_code))
            # bounded cardinality: event shapes come from the app's schema
            # pio-lint: disable=obs-label-cardinality -- event shapes bounded by app schema, documented caveat
            self._ete.inc(
                app_id=str(app_id),
                entity_type=event.entity_type,
                target_entity_type=event.target_entity_type or _NONE_TARGET,
                event=event.event,
            )

    @staticmethod
    def _window_json(
        app_id: int,
        start: _dt.datetime,
        end: _dt.datetime | None,
        status: dict[tuple[str, ...], float],
        ete: dict[tuple[str, ...], float],
    ) -> dict[str, Any]:
        aid = str(app_id)
        basic = [
            {
                "entityType": k[1],
                "targetEntityType": k[2] if k[2] != _NONE_TARGET else None,
                "event": k[3],
                "count": int(v),
            }
            for k, v in sorted(
                ete.items(), key=lambda item: (item[0][1], item[0][2], item[0][3])
            )
            if k[0] == aid
        ]
        status_codes = [
            {"status": int(k[1]), "count": int(v)}
            for k, v in sorted(
                status.items(), key=lambda item: int(item[0][1])
            )
            if k[0] == aid
        ]
        return {
            "startTime": format_event_time(start),
            "endTime": format_event_time(end) if end else None,
            "basic": basic,
            "statusCode": status_codes,
        }

    def get_stats(self, app_id: int) -> dict[str, Any]:
        with self._lock:
            self._roll(_dt.datetime.now(tz=UTC))
            status_now = _snapshot_counter(self._status)
            ete_now = _snapshot_counter(self._ete)
            out = {
                "currentHour": self._window_json(
                    app_id,
                    self._hour_start,
                    None,
                    _diff(status_now, self._hour_base_status),
                    _diff(ete_now, self._hour_base_ete),
                ),
                "longLive": self._window_json(
                    app_id, self._start_time, None, status_now, ete_now
                ),
            }
            if self._prev_hour is not None:
                start, end, status_diff, ete_diff = self._prev_hour
                out["prevHour"] = self._window_json(
                    app_id, start, end, status_diff, ete_diff
                )
            return out
