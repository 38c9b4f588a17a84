"""Request-scoped tracing: trace ids, spans, a ring buffer, JSON logs.

The port's own copy of ``predictionio_tpu/obs/tracing.py``. A trace id is
minted (or accepted from the ``X-Pio-Trace-Id`` header) at ingress and
rides a :mod:`contextvars` variable on the handler thread; thread hops (the
micro-batcher's dispatch and fetch workers, the sniffer and background-HTTP
pools) re-install it explicitly, because a ``ThreadPoolExecutor`` does not
copy the caller's context.

Every finished span is (a) appended to a bounded ring buffer served at
``/traces/recent`` and (b) emitted as one JSON line on the ``pio.trace``
logger — the structured log the acceptance trail greps for a single trace
id across ingress, batch, and storage spans. Span kinds used by the
framework: ``ingress`` (HTTP arrival), ``batch`` (micro-batch queue +
device dispatch/fetch, with wall/queue/device timings in tags),
``storage`` (DAO method via :mod:`predictionio_tpu_torch.data.storage.traced`),
``serving`` (per-query decode/serve work).

Standard library only: the event server and the CLI reach this module
without importing torch.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
import logging
import os
import random
import threading
import time
from collections import deque
from typing import Any, Iterator

TRACE_HEADER = "X-Pio-Trace-Id"
_random = random.Random()
os.register_at_fork(after_in_child=_random.seed)  # a forked child draws its own ids

# one trace id per logical request, carried across awaits by contextvars
_current_trace: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "pio_trace_id", default=None
)

_trace_logger = logging.getLogger("pio.trace")


def mint_trace_id() -> str:
    # 64 random bits as 16 hex digits, the JAX package's format, without
    # the os.urandom system call of uuid4 (which releases the GIL: a
    # thread switch per id on a server with a thread per connection)
    return f"{_random.getrandbits(64):016x}"


def _span_id() -> str:
    return f"{_random.getrandbits(32):08x}"


def current_trace_id() -> str | None:
    return _current_trace.get()


def set_trace_id(trace_id: str | None) -> contextvars.Token:
    """Install ``trace_id`` for the current context; pair with
    :func:`reset_trace_id` (thread hops install/reset around each unit of
    work for one request)."""
    return _current_trace.set(trace_id)


def reset_trace_id(token: contextvars.Token) -> None:
    _current_trace.reset(token)


def get_trace_logger() -> logging.Logger:
    """The structured span logger (one JSON object per line). Serving-path
    code should log through spans/this logger, not ``print`` or the root
    logger — the ``obs-unstructured-log`` lint rule enforces it."""
    return _trace_logger


@dataclasses.dataclass
class Span:
    trace_id: str
    name: str
    kind: str = "internal"
    span_id: str = dataclasses.field(default_factory=_span_id)
    # timing hygiene contract: start_time is a WALL-CLOCK display anchor
    # only (correlating spans with external logs); every duration in this
    # module — span durations, phase timings, queue waits — is measured
    # from time.perf_counter()/time.monotonic(), never as a wall-clock
    # delta, so an NTP step can shift where a span *appears* on a timeline
    # but can never corrupt how long anything *took*
    start_time: float = dataclasses.field(default_factory=time.time)
    duration_s: float = 0.0
    status: str = "ok"
    tags: dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json_dict(self) -> dict[str, Any]:
        return {
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "name": self.name,
            "kind": self.kind,
            "startTime": round(self.start_time, 6),
            "durationMs": round(self.duration_s * 1000.0, 3),
            "status": self.status,
            "tags": self.tags,
        }


class Tracer:
    """Span sink: bounded ring buffer + JSON log emission.

    One process-wide default instance (:func:`get_tracer`) is shared by
    the servers and the storage wrappers, mirroring how all structured
    logs converge on one logging tree; tests may construct private
    tracers for isolation.
    """

    def __init__(self, ring_size: int = 512):
        self._ring: deque[Span] = deque(maxlen=max(1, ring_size))
        self._lock = threading.Lock()
        self.spans_recorded = 0

    @contextlib.contextmanager
    def span(
        self,
        name: str,
        kind: str = "internal",
        trace_id: str | None = None,
        **tags: Any,
    ) -> Iterator[Span]:
        """Time a block as one span. The span is yielded so callers can
        attach tags mid-flight; an escaping exception marks the status
        with the exception type and re-raises."""
        sp = Span(
            trace_id=trace_id or current_trace_id() or mint_trace_id(),
            name=name,
            kind=kind,
            tags=dict(tags),
        )
        t0 = time.perf_counter()
        try:
            yield sp
        except BaseException as exc:
            sp.status = type(exc).__name__
            raise
        finally:
            sp.duration_s = time.perf_counter() - t0
            self.record(sp)

    def record_span(
        self,
        name: str,
        kind: str,
        duration_s: float,
        trace_id: str | None = None,
        status: str = "ok",
        **tags: Any,
    ) -> Span:
        """Record an already-timed span (the micro-batcher measures queue
        /dispatch/fetch itself and reports per-query afterwards)."""
        sp = Span(
            trace_id=trace_id or current_trace_id() or mint_trace_id(),
            name=name,
            kind=kind,
            start_time=time.time() - duration_s,
            duration_s=duration_s,
            status=status,
            tags=dict(tags),
        )
        self.record(sp)
        return sp

    def record(self, span: Span) -> None:
        with self._lock:
            self._ring.append(span)
            self.spans_recorded += 1
        if _trace_logger.isEnabledFor(logging.INFO):
            _trace_logger.info("%s", json.dumps(span.to_json_dict()))

    def recent(self, limit: int | None = None) -> list[dict[str, Any]]:
        """Newest-first JSON dicts for ``/traces/recent``."""
        with self._lock:
            spans = list(self._ring)
        spans.reverse()
        if limit is not None:
            spans = spans[: max(0, limit)]
        return [s.to_json_dict() for s in spans]

    def find(self, trace_id: str) -> list[dict[str, Any]]:
        """All ring-resident spans of one trace, oldest first."""
        with self._lock:
            return [
                s.to_json_dict() for s in self._ring if s.trace_id == trace_id
            ]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


_default_tracer = Tracer()


def get_tracer() -> Tracer:
    """The process-wide tracer shared by servers and storage wrappers."""
    return _default_tracer
