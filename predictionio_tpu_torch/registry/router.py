"""Rollout routing: serving lanes, sticky canary hashing, per-version
instruments.

The QueryServer serves a pinned *stable* lane and, during a rollout, a
*candidate* lane. Routing must be:

- **Sticky per user.** A user sees ONE model for the whole bake — flapping
  between recommendation models per request reads as a broken product and
  poisons divergence metrics. :func:`sticky_bucket` hashes the routing key
  (plus a salt so successive rollouts resample different users) into
  ``[0, 1)``; a request goes candidate iff its bucket falls under the
  canary fraction.
- **Consistent per batch.** A lane is an immutable :class:`Lane` tuple
  (algorithms, serving, models, version, instance) snapshotted in a single
  attribute read, so an in-flight micro-batch is immune to concurrent
  promote/rollback — the same contract the server already gives /reload.

Per-version metrics carry the ``version`` label on the existing /metrics
surface (``pio_model_requests_total``, ``pio_model_errors_total``,
``pio_model_predict_seconds``, ``pio_shadow_divergence_total``) — the
inputs the rollout controller gates promotion on.

(Own copy of ``predictionio_tpu/registry/router.py`` on the port's
``obs/metrics.py``; :func:`sticky_bucket` gives the reference's buckets,
so a fleet that mixes packages canaries the same users.)
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import hashlib
import json
import threading
from typing import Any, NamedTuple

from predictionio_tpu_torch.obs.metrics import MetricsRegistry

LANE_STABLE = "stable"
LANE_CANDIDATE = "candidate"
LANE_SHADOW = "shadow"

# the latency gate's (rows, seconds) log: pairs kept per version, and
# versions kept (a rollout compares two; older ones are dropped first)
PREDICT_LOG_PAIRS = 4096
PREDICT_LOG_VERSIONS = 8


@dataclasses.dataclass
class _PredictLog:
    total: int = 0
    pairs: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=PREDICT_LOG_PAIRS)
    )


class Lane(NamedTuple):
    """One servable model version. Immutable: the dispatch thread snapshots
    the whole quadruple-plus-instance in one attribute read."""

    algorithms: list[Any]
    serving: Any
    models: list[Any]
    version: str
    instance_id: str
    engine_params: Any = None  # carried so promote can adopt them wholesale


class RolloutPlan(NamedTuple):
    """The routing decision inputs, snapshotted together. ``mode`` is
    off|canary|shadow; ``salt`` varies per staged rollout so consecutive
    canaries sample different user populations."""

    mode: str
    fraction: float
    salt: str


PLAN_OFF = RolloutPlan("off", 0.0, "")


def sticky_bucket(key: str, salt: str = "") -> float:
    """Deterministically map a routing key to ``[0, 1)``. sha256 (not
    ``hash()``) so the assignment is stable across processes and restarts —
    a replica fleet must agree on which users are canaried."""
    digest = hashlib.sha256(f"{salt}:{key}".encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "big") / float(1 << 64)


def routing_key(payload: Any, field: str) -> str:
    """Extract the sticky key from a query payload: the configured field
    when present (``user`` by default), else a canonical hash of the whole
    payload — still deterministic, so identical queries route identically
    even without a user id."""
    if isinstance(payload, dict):
        value = payload.get(field)
        if value is not None:
            return str(value)
    try:
        return json.dumps(payload, sort_keys=True, default=str)
    except (TypeError, ValueError):
        return repr(payload)


def choose_lane(plan: RolloutPlan, key: str) -> str:
    """stable | candidate for one request under the given plan. Shadow
    mode always answers from stable (the candidate is scored async)."""
    if plan.mode != "canary" or plan.fraction <= 0.0:
        return LANE_STABLE
    if sticky_bucket(key, plan.salt) < plan.fraction:
        return LANE_CANDIDATE
    return LANE_STABLE


class RolloutInstruments:
    """Per-version serving metrics on the server's existing registry.

    Label cardinality is bounded by GC: only versions actually serving
    (stable + one candidate at a time) produce series.
    """

    def __init__(self, registry: MetricsRegistry):
        self.requests = registry.counter(
            "pio_model_requests_total",
            "queries served, by model version and lane",
            labelnames=("version", "lane"),
        )
        self.errors = registry.counter(
            "pio_model_errors_total",
            "per-query predict/serve failures, by model version and lane",
            labelnames=("version", "lane"),
        )
        self.predict_seconds = registry.histogram(
            "pio_model_predict_seconds",
            "per-batch predict wall time, by model version",
            labelnames=("version",),
        )
        self._samples: dict[str, _PredictLog] = {}
        self._samples_lock = threading.Lock()
        self.divergence = registry.counter(
            "pio_shadow_divergence_total",
            "shadow-scored queries whose candidate result differed from stable",
            labelnames=("version",),
        )
        self.shadow_scored = registry.counter(
            "pio_shadow_scored_total",
            "queries shadow-scored against the candidate",
            labelnames=("version",),
        )
        self.shadow_dropped = registry.counter(
            "pio_shadow_dropped_total",
            "queries skipped by shadow scoring because the backlog was full "
            "(shadow is sampling, not accounting)",
            labelnames=("version",),
        )
        self.rollbacks = registry.counter(
            "pio_rollbacks_total",
            "candidate rollbacks, by trigger",
            labelnames=("reason",),
        )
        self.promotions = registry.counter(
            "pio_promotions_total",
            "candidate promotions to stable",
        )
        self.fraction_gauge = registry.gauge(
            "pio_rollout_fraction",
            "current canary fraction (0 when no rollout is active)",
        )
        self.mode_gauge = registry.gauge(
            "pio_rollout_mode",
            "rollout mode (0=off, 1=canary, 2=shadow)",
        )

    MODE_VALUES = {"off": 0.0, "canary": 1.0, "shadow": 2.0}

    def set_plan(self, plan: RolloutPlan) -> None:
        self.fraction_gauge.set(plan.fraction)
        self.mode_gauge.set(self.MODE_VALUES.get(plan.mode, -1.0))

    # -- controller inputs --------------------------------------------------
    def lane_counts(self, version: str) -> dict[str, float]:
        """requests/errors totals for one version across lanes, plus the
        shadow tallies — the raw inputs PromotionCriteria compares."""
        req = 0.0
        err = 0.0
        for lane in (LANE_STABLE, LANE_CANDIDATE, LANE_SHADOW):
            req += self.requests.value(version=version, lane=lane)
            err += self.errors.value(version=version, lane=lane)
        return {
            "requests": req,
            "errors": err,
            "shadow_scored": self.shadow_scored.value(version=version),
            "divergence": self.divergence.value(version=version),
        }

    def p95_seconds(self, version: str) -> float:
        summary = self.predict_seconds.summary(version=version)
        return float(summary.get("p95", 0.0)) if summary.get("count") else 0.0

    def observe_predict(self, seconds: float, rows: int, version: str) -> None:
        """One lane's predict wall time for a batch of ``rows`` queries:
        the ``pio_model_predict_seconds`` sample, and the (rows, seconds)
        pair the latency gate reads (the histogram alone cannot tell a
        slower model from a larger share of each micro-batch)."""
        self.predict_seconds.observe(seconds, version=version)
        with self._samples_lock:
            log = self._samples.pop(version, None) or _PredictLog()
            self._samples[version] = log  # most recently observed last
            while len(self._samples) > PREDICT_LOG_VERSIONS:
                self._samples.pop(next(iter(self._samples)))
            log.total += 1
            log.pairs.append((int(rows), float(seconds)))

    def predict_mark(self, version: str) -> int:
        """Baseline for :meth:`predict_samples_since`."""
        with self._samples_lock:
            log = self._samples.get(version)
            return log.total if log is not None else 0

    def predict_samples_since(self, version: str, mark: int) -> list[tuple[int, float]]:
        """The (rows, seconds) pairs observed since ``mark`` (at most the
        last ``PREDICT_LOG_PAIRS``): a re-staged candidate is judged on this
        bake's latency, not a previous bake's."""
        with self._samples_lock:
            log = self._samples.get(version)
            if log is None or log.total <= mark:
                return []
            n = min(log.total - mark, len(log.pairs))
            return list(log.pairs)[-n:]

    def p95_of(self, seconds: list[float]) -> float:
        """The histogram's p95 estimate over these values (bucket-bounded,
        as the ``/metrics`` p95 reads)."""
        counts = [0] * (len(self.predict_seconds.buckets) + 1)
        for value in seconds:
            counts[bisect.bisect_left(self.predict_seconds.buckets, value)] += 1
        return self.predict_seconds.percentile_from_counts(counts, 0.95)
