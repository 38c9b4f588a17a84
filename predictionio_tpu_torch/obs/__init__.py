"""Observability: the metrics registry and the step profiler that the
offline verbs (``pio batchpredict``, the evaluation grid) record into.
Port of the parts of ``predictionio_tpu/obs/`` those verbs read; tracing,
the SLO engine and ``/metrics`` come later."""
