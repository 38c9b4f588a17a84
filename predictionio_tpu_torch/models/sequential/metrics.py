"""The ``pio_seq_*`` metric family (the port's own copy of
``predictionio_tpu/models/sequential/metrics.py``).

Registered eagerly (AnnInstruments discipline): the family exists at zero
from process start so scrapers and the docs metrics-contract test see it
before the first session folds in. The stream pipeline binds it to the
:class:`~predictionio_tpu_torch.stream.trainers.SequentialStreamTrainer` via its
``instruments`` kwarg."""

from __future__ import annotations

from predictionio_tpu_torch.obs.metrics import MetricsRegistry


class SeqInstruments:
    def __init__(self, registry: MetricsRegistry | None = None):
        self.registry = registry or MetricsRegistry()
        r = self.registry
        self.transitions = r.counter(
            "pio_seq_transitions_total",
            "session transitions (prev item -> next item) absorbed by the "
            "streaming sequential trainer",
        )
        self.items_touched = r.counter(
            "pio_seq_items_touched_total",
            "items whose outgoing transition row changed, summed over "
            "absorbed micro-batches",
        )
        self.states = r.gauge(
            "pio_seq_states",
            "states (items) in the last published transition matrix",
        )
        self.pairs = r.gauge(
            "pio_seq_pairs",
            "distinct (from, to) transition pairs in the last published "
            "matrix",
        )
        self.sessions = r.gauge(
            "pio_seq_sessions",
            "live per-user session cursors the stream trainer tracks "
            "(bounded by its max_users)",
        )
        self.snapshots = r.counter(
            "pio_seq_snapshots_total",
            "stream snapshots rebuilt into a servable SequentialModel",
        )

    def on_absorb(self, transitions: int, items_touched: int) -> None:
        self.transitions.inc(float(transitions))
        self.items_touched.inc(float(items_touched))

    def on_snapshot(self, states: int, pairs: int, sessions: int) -> None:
        self.states.set(float(states))
        self.pairs.set(float(pairs))
        self.sessions.set(float(sessions))
        self.snapshots.inc()
