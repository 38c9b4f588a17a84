"""Speed layer: streaming incremental training from the event store.

The paper frames PredictionIO as a Lambda architecture; until this package
the reproduction only had the batch half (events accumulate, models change
when a full ``pio train`` runs). The speed layer closes the loop:

- :mod:`.cursor` — durable per-app cursors into the event store (atomic
  tmp+rename state files; resume-after-crash; the bookkeeping behind
  exactly-once *publish* on top of at-least-once event reads);
- :mod:`.tailer` — drains new events in bounded micro-batches behind the
  resilience policies (retry transient storage errors, breaker
  pauses tailing, deadline per drain);
- :mod:`.trainers` — the :class:`~predictionio_tpu_torch.stream.trainers.
  IncrementalTrainer` protocol plus fold-in ALS (batched SPD solves via
  ``ops/spd_solve``: kernel B1 on the card), streaming naive-Bayes count updates, and
  incremental cooccurrence counts — each with a rolling held-out drift
  guard;
- :mod:`.pipeline` — the ``pio stream`` loop: drain -> fold-in ->
  snapshot -> publish a *candidate* to the model registry, where the
  bake gates and candidate breaker decide promote/rollback.

Port of ``predictionio_tpu/stream/``.
"""

from predictionio_tpu_torch.stream.cursor import CursorStore, StreamCursor, span_id_of
from predictionio_tpu_torch.stream.pipeline import (
    StreamConfig,
    StreamInstruments,
    StreamPipeline,
    serve_metrics,
    trainer_for_models,
)
from predictionio_tpu_torch.stream.tailer import DrainResult, EventTailer
from predictionio_tpu_torch.stream.trainers import (
    DriftReport,
    FoldInALSTrainer,
    IncrementalTrainer,
    RollingHoldout,
    SequentialStreamTrainer,
    StreamingCooccurrenceTrainer,
    StreamingNaiveBayesTrainer,
)

__all__ = [
    "CursorStore",
    "DrainResult",
    "DriftReport",
    "EventTailer",
    "FoldInALSTrainer",
    "IncrementalTrainer",
    "RollingHoldout",
    "SequentialStreamTrainer",
    "StreamConfig",
    "StreamInstruments",
    "StreamPipeline",
    "StreamCursor",
    "StreamingCooccurrenceTrainer",
    "StreamingNaiveBayesTrainer",
    "serve_metrics",
    "span_id_of",
    "trainer_for_models",
]
