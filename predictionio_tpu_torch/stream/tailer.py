"""Event tailer: bounded micro-batch drains behind resilience policies.

Wraps an ``LEvents`` DAO's ``find_after`` tail read (the ordering
contract of ``data/storage/base.event_seq_key``) with the resilience
policy vocabulary: transient storage errors are retried with backoff, persistent
failure opens a circuit breaker (``CircuitOpenError`` surfaces to the
pipeline, which pauses tailing until the breaker's recovery window), and
every drain runs under its own deadline so a wedged backend cannot stall
the loop forever. Batches are bounded by ``batch_limit`` — backpressure
is structural: the tailer never materializes more than one batch.

Own copy of ``predictionio_tpu/stream/tailer.py``, without its tracing
span (the port has no tracer yet).
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
from typing import Any

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import event_seq_key
from predictionio_tpu_torch.resilience import (
    CircuitBreaker,
    Deadline,
    ResiliencePolicy,
    RetryPolicy,
)
from predictionio_tpu_torch.stream.cursor import Position

_UTC = _dt.timezone.utc


@dataclasses.dataclass
class DrainResult:
    """One micro-batch: the events, the cursor position after them, and
    whether the store likely has more (a full batch came back)."""

    events: list[Event]
    position: Position | None  # unchanged when the drain was empty
    more: bool


def default_tail_policy(
    breaker_threshold: int = 5, breaker_recovery_s: float = 5.0
) -> ResiliencePolicy:
    return ResiliencePolicy(
        retry=RetryPolicy(max_attempts=3, backoff_base_s=0.05),
        breaker=CircuitBreaker(
            name="stream-tail",
            failure_threshold=breaker_threshold,
            recovery_timeout_s=breaker_recovery_s,
        ),
    )


class EventTailer:
    """Drains new events for one (app, channel) in bounded batches."""

    def __init__(
        self,
        levents: Any,
        app_id: int,
        channel_id: int | None = None,
        *,
        batch_limit: int = 500,
        drain_timeout_s: float = 10.0,
        lag_probe_limit: int = 1000,
        safety_lag_s: float = 0.0,
        policy: ResiliencePolicy | None = None,
    ):
        if batch_limit <= 0:
            raise ValueError(f"batch_limit must be positive, got {batch_limit}")
        self.levents = levents
        self.app_id = app_id
        self.channel_id = channel_id
        self.batch_limit = batch_limit
        self.drain_timeout_s = drain_timeout_s
        self.lag_probe_limit = lag_probe_limit
        # Watermark against the concurrent-commit race: creation_time is
        # stamped at Event CONSTRUCTION, so a slow commit can land behind
        # an already-advanced cursor and be skipped. With a safety lag,
        # the drain never advances past (now - safety_lag_s) — any insert
        # whose construct->commit latency is under the lag is safe.
        # 0 (default) trusts commit latency ~0 (single-writer embedded
        # stores, tests); `pio stream` defaults it on.
        self.safety_lag_s = max(0.0, safety_lag_s)
        self.policy = policy or default_tail_policy()

    def _read(self, position: Position | None, limit: int) -> list[Event]:
        return self.levents.find_after(
            self.app_id,
            self.channel_id,
            cursor=position,
            limit=limit,
        )

    def drain(self, position: Position | None) -> DrainResult:
        """One bounded tail read strictly past ``position``. Retries ride
        the policy; a tripped breaker raises ``CircuitOpenError`` here and
        the caller pauses."""
        events = self.policy.call(
            self._read,
            position,
            self.batch_limit,
            deadline=Deadline.after(self.drain_timeout_s),
        )
        full = len(events) >= self.batch_limit
        if self.safety_lag_s > 0 and events:
            cutoff = _dt.datetime.now(tz=_UTC) - _dt.timedelta(seconds=self.safety_lag_s)
            kept = len(events)
            while kept and events[kept - 1].creation_time > cutoff:
                kept -= 1
            if kept < len(events):
                # the tail is inside the watermark window: leave it for the
                # next cycle (more=False: waiting, not behind)
                events = events[:kept]
                full = False
        if not events:
            return DrainResult([], position, False)
        return DrainResult(events, event_seq_key(events[-1]), full)

    def lag(
        self, position: Position | None, assume_backlog: bool = False
    ) -> tuple[int, float]:
        """(events behind, seconds behind): a bounded probe past the
        cursor, under the same policy + deadline as ``drain`` (a wedged
        backend must open the breaker here too, not hang the loop). The
        event count saturates at ``lag_probe_limit``; seconds = age of
        the OLDEST unprocessed event (0 when caught up).

        ``assume_backlog=True`` (the caller just hit its drain budget
        with a full batch still pending) reads ONE row for the age and
        reports the saturated count — re-fetching up to the probe limit
        would double the read I/O on exactly the rows the next cycle's
        drain is about to read."""
        limit = 1 if assume_backlog else self.lag_probe_limit
        probe = self.policy.call(
            self._read,
            position,
            limit,
            deadline=Deadline.after(self.drain_timeout_s),
        )
        if not probe:
            return 0, 0.0
        oldest = probe[0].creation_time
        now = _dt.datetime.now(tz=_UTC)
        n = self.lag_probe_limit if assume_backlog else len(probe)
        return n, max(0.0, (now - oldest).total_seconds())

    def head_position(self) -> Position | None:
        """The current end of the store in tail order — what a fresh
        cursor is seeded with so only NEW events fold in. One
        ``seq_head`` call (indexed DESC read on sql/sqlite, one scan on
        the others), policy-wrapped."""
        return self.policy.call(
            self.levents.seq_head,
            self.app_id,
            self.channel_id,
            deadline=Deadline.after(self.drain_timeout_s),
        )

    def snapshot(self) -> dict[str, Any]:
        return {
            "appId": self.app_id,
            "channelId": self.channel_id,
            "batchLimit": self.batch_limit,
            "policy": self.policy.snapshot(),
        }


__all__ = ["DrainResult", "EventTailer", "default_tail_policy"]
