"""Per-request latency attribution: the phase waterfall.

The port's own copy of ``predictionio_tpu/obs/waterfall.py``. Every query
is accounted into an explicit sequence of phases that tile the request's
wall clock, so "the server is slow" decomposes into "the fetch phase is
slow" with a concrete trace id attached.

Phases, in request order:

- ``ingress_parse``   auth check, payload read, JSON decode
- ``cache``           version-keyed result-cache lookup (every request
                      observes its lookup cost; a HIT ends the request
                      here — its waterfall is parse -> cache -> respond,
                      no queue/dispatch/device phases at all)
- ``queue_wait``      micro-batch admission queue (incl. in-flight
                      backpressure while earlier batches occupy the
                      dispatch pipeline)
- ``batch_assembly``  draining queued peers into this batch
- ``dispatch``        decode -> supplement -> host-to-device enqueue
- ``device_compute``  the fetch thread's wall time waiting for the lane's
                      results (the algorithms' finalizers; a host sync
                      should go through ``obs.torchprof.timed_fetch`` so
                      its stall also lands in the stall counter)
- ``fetch``           result distribution residual: executor hop +
                      unpack outside compute and serve
- ``serve``           serving.serve + top-k post-processing + encode
- ``respond``         future resolution -> response serialization

Every observation lands in ONE fixed-bucket histogram
(``pio_phase_seconds{phase=…}``) with the request's trace id captured as
the bucket's exemplar — a p99 outlier in any phase links to a concrete
trace in ``/traces/recent`` instead of an anonymous count. Batch-scoped
phases (assembly/dispatch/device/fetch/serve) are observed once per
*query*, valued at the batch's duration: every rider of a batch really
does wait out the whole batch, so per-query phase sums reconcile with
per-query e2e latency (the contract tests assert within 10%).

Stdlib-only, like the rest of the metrics layer.
"""

from __future__ import annotations

from typing import Any

from predictionio_tpu_torch.obs.metrics import Histogram, MetricsRegistry

# request-ordered phase vocabulary; label values of pio_phase_seconds
PHASE_INGRESS_PARSE = "ingress_parse"
PHASE_CACHE = "cache"
PHASE_QUEUE_WAIT = "queue_wait"
PHASE_BATCH_ASSEMBLY = "batch_assembly"
PHASE_DISPATCH = "dispatch"
PHASE_DEVICE_COMPUTE = "device_compute"
PHASE_FETCH = "fetch"
PHASE_SERVE = "serve"
PHASE_RESPOND = "respond"

PHASES: tuple[str, ...] = (
    PHASE_INGRESS_PARSE,
    PHASE_CACHE,
    PHASE_QUEUE_WAIT,
    PHASE_BATCH_ASSEMBLY,
    PHASE_DISPATCH,
    PHASE_DEVICE_COMPUTE,
    PHASE_FETCH,
    PHASE_SERVE,
    PHASE_RESPOND,
)

PHASE_METRIC = "pio_phase_seconds"


class PhaseWaterfall:
    """The per-request phase histogram + its JSON snapshot.

    ``observe`` is one histogram observation under a per-metric lock —
    hot-path cheap. Negative durations (clock skew across threads,
    residual clamping) are floored at zero so the waterfall never renders
    a phase that "gave time back".
    """

    def __init__(self, registry: MetricsRegistry):
        self.hist: Histogram = registry.histogram(
            PHASE_METRIC,
            "per-request latency by serving phase "
            "(ingress_parse|cache|queue_wait|batch_assembly|dispatch|"
            "device_compute|fetch|serve|respond); bucket exemplars carry "
            "the trace id of the most recent observation",
            labelnames=("phase",),
        )

    def observe(
        self, phase: str, seconds: float, exemplar: str | None = None
    ) -> None:
        self.hist.observe(max(0.0, seconds), exemplar=exemplar, phase=phase)

    def observe_batch(self, phase: str, seconds: float, exemplars: list) -> None:
        """One batch-scoped phase for every rider of a batch: the same
        value once per rider, under one lock (the port's collect and finish
        threads are on the serial path of every query)."""
        if exemplars:
            self.hist.observe_many(max(0.0, seconds), len(exemplars), exemplar=exemplars[-1], phase=phase)

    def snapshot(self) -> dict[str, Any]:
        """Per-phase summaries + exemplars, request-ordered — the JSON the
        ``/slo`` report and dashboards embed."""
        out: dict[str, Any] = {}
        for phase in PHASES:
            s = self.hist.summary(phase=phase)
            if not s.get("count"):
                continue
            out[phase] = {
                **{k: round(float(v), 6) for k, v in s.items()},
                "exemplars": self.hist.exemplars(phase=phase),
            }
        return out


def phase_tags_ms(**phase_seconds: float) -> dict[str, float]:
    """Span-tag helper: ``{phase}_ms`` rounded, skipping Nones — keeps the
    query.batch/ingress span tags consistent with the histogram phases."""
    return {
        f"{name}_ms": round(max(0.0, s) * 1000.0, 3)
        for name, s in phase_seconds.items()
        if s is not None
    }


__all__ = [
    "PHASES",
    "PHASE_METRIC",
    "PHASE_INGRESS_PARSE",
    "PHASE_CACHE",
    "PHASE_QUEUE_WAIT",
    "PHASE_BATCH_ASSEMBLY",
    "PHASE_DISPATCH",
    "PHASE_DEVICE_COMPUTE",
    "PHASE_FETCH",
    "PHASE_SERVE",
    "PHASE_RESPOND",
    "PhaseWaterfall",
    "phase_tags_ms",
]
