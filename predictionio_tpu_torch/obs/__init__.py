"""Observability of the port (port of ``predictionio_tpu/obs/``):

- ``metrics``: counters, gauges and fixed-bucket histograms with the
  Prometheus text (and OpenMetrics, with trace-id exemplars) exposition
  served at ``/metrics`` by both servers, byte-equal to the JAX package's;
- ``tracing``: trace ids (``X-Pio-Trace-Id``), spans, the ring buffer
  behind ``/traces/recent`` and the ``pio.trace`` JSON log;
- ``waterfall``: the nine-phase latency attribution of a query
  (``pio_phase_seconds{phase}``);
- ``slo``: objectives evaluated as multi-window burn rates (``/slo``);
- ``web``: breaker instruments and the ``/metrics``, ``/slo`` and
  ``/traces/recent`` answers for the stdlib HTTP handlers;
- ``profiler``: single-flight ``torch.profiler`` captures published as
  content-addressed bundles (``POST /profile/capture``, ``pio profile``);
- ``sampler``: the always-on host stack sampler (``GET /profile/stacks``);
- ``incidents`` and ``tsring``: incident bundles and the telemetry ring
  (``pio stream --obs-dir``, ``pio incidents``);
- ``torchprof``: the kernel-build watcher and the timed fetch;
- ``xray``: the step profiler, the card's memory readings and the
  capacity planner (``pio doctor --capacity``);
- ``costmodel``: the analytic roofline (``pio doctor --roofline``).

Nothing is imported here: ``metrics``, ``tracing``, ``waterfall``,
``slo``, ``sampler``, ``incidents``, ``tsring`` and ``costmodel`` are
standard library only, and the event server and the CLI use them without
importing torch. The sharding inspector of the JAX ``xray`` is not ported.
"""
