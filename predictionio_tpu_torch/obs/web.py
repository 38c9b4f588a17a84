"""The observability surface shared by the query server and the event
server: breaker instruments and the ``/metrics``, ``/slo`` and
``/traces/recent`` answers.

Port of ``predictionio_tpu/obs/web.py``. The JAX routes answer through
aiohttp; the port's servers run the standard library's
``ThreadingHTTPServer``, so each function here returns ``(status,
content type, body bytes)`` for the handler to write, and the content
negotiation is the JAX one: ``Accept: application/openmetrics-text`` or
``?exemplars=1`` gives the OpenMetrics text with trace-id exemplars, any
other scrape the plain Prometheus v0.0.4 text.
"""

from __future__ import annotations

import json
from typing import Any, Mapping

from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.obs.slo import SLOEngine
from predictionio_tpu_torch.obs.tracing import Tracer
from predictionio_tpu_torch.resilience.breaker import CLOSED, HALF_OPEN, OPEN, CircuitBreaker

# numeric encoding of breaker states for the pio_breaker_state gauge
BREAKER_STATE_VALUES = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
OPENMETRICS_CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"
JSON_CONTENT_TYPE = "application/json; charset=utf-8"

# (status, content type, body)
WebAnswer = tuple[int, str, bytes]


class BreakerInstruments:
    """A transition counter fed by each breaker's listener, and a state
    gauge refreshed at scrape time (open -> half-open happens lazily on the
    clock, which no listener event covers)."""

    def __init__(self, registry: MetricsRegistry):
        self._transitions = registry.counter(
            "pio_breaker_transitions_total",
            "circuit breaker state transitions, by breaker and target state",
            labelnames=("breaker", "to"),
        )
        self._state = registry.gauge(
            "pio_breaker_state",
            "breaker state (0=closed, 1=half-open, 2=open)",
            labelnames=("breaker",),
        )
        self._breakers: list[CircuitBreaker] = []

    def watch(self, breaker: CircuitBreaker) -> CircuitBreaker:
        """Chain the transition listener onto ``breaker`` and include it in
        the scrape-time refresh; returns the breaker."""
        breaker.chain_listener(self.on_transition)
        self._breakers.append(breaker)
        self.collect()
        return breaker

    def unwatch(self, breaker: CircuitBreaker) -> None:
        """Forget a retired replica's breaker: stop refreshing it and drop
        its state gauge series (the transition counter stays: history is
        monotonic, the gauge is a live-set claim)."""
        self._breakers = [b for b in self._breakers if b is not breaker]
        self._state.remove(breaker=breaker.name)

    def on_transition(self, name: str, old: str, new: str) -> None:
        self._transitions.inc(breaker=name, to=new)
        self._state.set(BREAKER_STATE_VALUES.get(new, -1.0), breaker=name)

    def collect(self) -> None:
        """Registry collector: refresh every watched breaker's gauge."""
        for breaker in self._breakers:
            self._state.set(BREAKER_STATE_VALUES.get(breaker.state, -1.0), breaker=breaker.name)


def _json(status: int, body: Any) -> WebAnswer:
    return status, JSON_CONTENT_TYPE, json.dumps(body).encode()


def _wants_exemplars(query: Mapping[str, str], headers: Mapping[str, str]) -> bool:
    """Exemplars ride only on negotiated scrapes: OpenMetrics in Accept or
    an explicit ``?exemplars=1``. The default stays strict v0.0.4, which a
    plain-text parser reads. ``headers`` may be any case-insensitive
    mapping (``http.server``'s message) or one with lower-cased names."""
    if query.get("exemplars", "") not in ("", "0", "false"):
        return True
    accept = headers.get("Accept") or headers.get("accept") or ""
    return "openmetrics" in accept.lower()


def metrics_response(
    registry: MetricsRegistry, query: Mapping[str, str], headers: Mapping[str, str]
) -> WebAnswer:
    """The ``/metrics`` answer: the registry's exposition, OpenMetrics with
    exemplars when negotiated."""
    exemplars = _wants_exemplars(query, headers)
    return (
        200,
        OPENMETRICS_CONTENT_TYPE if exemplars else PROMETHEUS_CONTENT_TYPE,
        registry.render_prometheus(exemplars=exemplars).encode(),
    )


def slo_response(engine: SLOEngine, extra: dict[str, Any] | None = None) -> WebAnswer:
    """The ``/slo`` JSON report: burn rates per objective and window (the
    query server adds its phase waterfall under ``phases``)."""
    body = engine.report()
    if extra:
        body.update(extra)
    return _json(200, body)


def traces_response(tracer: Tracer, query: Mapping[str, str]) -> WebAnswer:
    """Recent spans from the ring buffer (``?limit=N``, newest first)."""
    try:
        limit = int(query.get("limit", 100))
    except ValueError:
        return _json(400, {"message": "limit must be an integer"})
    return _json(200, {"spans": tracer.recent(limit)})
