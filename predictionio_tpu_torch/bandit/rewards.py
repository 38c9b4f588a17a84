"""Reward accounting: served impressions matched to feedback events.

The serving tier records ``trace_id -> (arm, version)`` for every answered
request (bounded FIFO — an impression that never sees feedback ages out
as pure exploration cost). The reward tailer pages NEW feedback events
from the event store through the ``find_after`` contract — bounded pages,
cursor seeded at the head when the bandit engages, so historical events
never retro-credit an arm — and matches them back by the trace id the
client echoed into the event's properties (docs/bandit.md states the
matching rules).

The port's own copy of ``predictionio_tpu/bandit/rewards.py``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Sequence


class ImpressionLog:
    """Bounded trace->arm map. ``record`` is on the serving hot path:
    one lock, one dict insert, one possible FIFO eviction."""

    def __init__(self, capacity: int = 65536):
        self.capacity = max(16, int(capacity))
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, tuple[str, str]]" = OrderedDict()
        self.evicted = 0

    def record(self, trace_id: str, arm: str, version: str) -> None:
        if not trace_id:
            return
        with self._lock:
            self._entries[trace_id] = (arm, version)
            self._entries.move_to_end(trace_id)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evicted += 1

    def peek(self, trace_id: str) -> tuple[str, str] | None:
        """Non-destructive lookup (status/debug): which arm answered this
        trace, without consuming its one reward credit."""
        with self._lock:
            return self._entries.get(trace_id)

    def match(self, trace_id: str) -> tuple[str, str] | None:
        """Pop the impression for a rewarded trace: one impression earns
        reward once (duplicate feedback events for the same trace are
        dropped as unmatched — at-least-once event delivery must not
        double-credit an arm)."""
        with self._lock:
            return self._entries.pop(trace_id, None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


class RewardTailer:
    """Bounded ``find_after`` tail over the app's feedback events.

    Matching rules (docs/bandit.md): an event credits an arm iff its
    event name is in ``event_names``, its properties carry
    ``trace_property``, and that trace id is a live impression. The reward
    value is ``properties[reward_property]`` clamped to [0, 1]
    (absent -> 1.0: a bare conversion event is full reward)."""

    def __init__(
        self,
        levents,
        app_id: int,
        channel_id: int | None = None,
        *,
        event_names: Sequence[str] = ("reward",),
        trace_property: str = "traceId",
        reward_property: str = "reward",
        page: int = 256,
        max_pages: int = 16,
    ):
        self.levents = levents
        self.app_id = app_id
        self.channel_id = channel_id
        self.event_names = frozenset(event_names)
        self.trace_property = trace_property
        self.reward_property = reward_property
        self.page = max(1, int(page))
        self.max_pages = max(1, int(max_pages))
        # only events ingested AFTER the bandit engaged count as reward
        self._cursor = levents.seq_head(app_id, channel_id)

    def poll(
        self, impressions: ImpressionLog
    ) -> tuple[list[tuple[str, str, float]], int]:
        """Drain new feedback events; returns (matched credits as
        ``(arm, version, reward)`` triples, unmatched feedback count)."""
        from predictionio_tpu_torch.data.storage.base import event_seq_key

        credits: list[tuple[str, str, float]] = []
        unmatched = 0
        for _ in range(self.max_pages):
            batch = list(
                self.levents.find_after(
                    self.app_id, self.channel_id, self._cursor, self.page
                )
            )
            if not batch:
                break
            self._cursor = event_seq_key(batch[-1])
            for e in batch:
                if e.event not in self.event_names:
                    continue
                trace = e.properties.get(self.trace_property)
                if not isinstance(trace, str) or not trace:
                    unmatched += 1
                    continue
                hit = impressions.match(trace)
                if hit is None:
                    unmatched += 1
                    continue
                raw = e.properties.get(self.reward_property)
                try:
                    reward = float(raw) if raw is not None else 1.0
                except (TypeError, ValueError):
                    reward = 1.0
                arm, version = hit
                credits.append((arm, version, min(1.0, max(0.0, reward))))
            if len(batch) < self.page:
                break
        return credits, unmatched
