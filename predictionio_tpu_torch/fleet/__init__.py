"""Serving fleet: N supervised QueryServer replicas behind one gateway.

The single-process QueryServer is both the scaling ceiling and the
single point of failure; this package makes replica count a deployment
knob (``pio deploy --fleet N``) instead of a rewrite:

- :mod:`.supervisor` — spawns and watches the worker processes,
  restarting crashes with exponential backoff and a crash-loop budget;
- :mod:`.gateway` — routes queries (least-loaded + consistent-hash
  tie-break), ejects/readmits replicas from ``/healthz`` probes and
  per-replica circuit breakers, retries idempotent queries once on a
  different replica, and drains gracefully on SIGTERM;
- :mod:`.federation` — merges the replicas' Prometheus scrapes into the
  gateway's ``/metrics`` (the ``pio top --fleet`` endpoint);
- :mod:`.autoscaler` — SLO-driven elasticity: a control loop that reads
  the telemetry ring (fleet burn rates, queue-depth/inflight/shed
  history) and resizes the fleet through the supervisor and the
  gateway's membership funnel, with heterogeneous ``cpu-fallback``
  overflow replicas (``pio deploy --fleet N --autoscale``);
- :mod:`.launch` — the ``pio deploy --fleet N`` glue that runs
  supervisor + gateway (+ autoscaler, + lifecycle controller) in one
  process.

Replicas coordinate ONLY through the model registry: its rollout state
carries a monotonic ``state_generation`` every worker polls, so a
promote/rollback issued through any replica (or the gateway) propagates
fleet-wide and flushes each per-process result cache.

Port of ``predictionio_tpu/fleet/`` with the same exports. The gateway
runs on the standard library's ``ThreadingHTTPServer`` instead of aiohttp,
and the supervisor's, autoscaler's and lifecycle controller's loops run
on threads of their own instead of an event loop.
"""

from predictionio_tpu_torch.fleet.autoscaler import (
    Autoscaler,
    AutoscalerConfig,
    ScalingPolicy,
)
from predictionio_tpu_torch.fleet.federation import federate_metrics
from predictionio_tpu_torch.fleet.gateway import Gateway, GatewayConfig, Replica
from predictionio_tpu_torch.fleet.supervisor import (
    REPLICA_CLASS_CPU,
    REPLICA_CLASS_DEVICE,
    Supervisor,
    SupervisorConfig,
    WorkerSpec,
)

__all__ = [
    "Autoscaler",
    "AutoscalerConfig",
    "Gateway",
    "GatewayConfig",
    "REPLICA_CLASS_CPU",
    "REPLICA_CLASS_DEVICE",
    "Replica",
    "ScalingPolicy",
    "Supervisor",
    "SupervisorConfig",
    "WorkerSpec",
    "federate_metrics",
]
