"""Breaker instruments shared by the query server and the event server
(port of ``BreakerInstruments`` from ``predictionio_tpu/obs/web.py``; the
HTTP routes of that module, ``/metrics``, ``/slo`` and
``/traces/recent``, are not ported yet)."""

from __future__ import annotations

from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.resilience.breaker import CLOSED, HALF_OPEN, OPEN, CircuitBreaker

# numeric encoding of breaker states for the pio_breaker_state gauge
BREAKER_STATE_VALUES = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}


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

    def on_transition(self, name: str, old: str, new: str) -> None:
        self._transitions.inc(breaker=name, to=new)
        self._state.set(BREAKER_STATE_VALUES.get(new, -1.0), breaker=name)

    def collect(self) -> None:
        """Registry collector: refresh every watched breaker's gauge."""
        for breaker in self._breakers:
            self._state.set(BREAKER_STATE_VALUES.get(breaker.state, -1.0), breaker=breaker.name)
