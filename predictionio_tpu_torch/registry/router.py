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

import hashlib
import json
from typing import Any, NamedTuple

from predictionio_tpu_torch.obs.metrics import MetricsRegistry

LANE_STABLE = "stable"
LANE_CANDIDATE = "candidate"
LANE_SHADOW = "shadow"


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

    def predict_bucket_counts(self, version: str) -> list[int]:
        """Baseline snapshot for :meth:`p95_since`."""
        return self.predict_seconds.bucket_counts(version=version)

    def p95_since(self, version: str, baseline_counts: list[int]) -> float:
        """predict p95 over ONLY the samples observed since the baseline
        snapshot — a re-staged candidate must be judged on this bake's
        latency, not a previous bake's (lifetime p95 would carry old slow
        samples forever)."""
        current = self.predict_seconds.bucket_counts(version=version)
        delta = [max(0, c - b) for c, b in zip(current, baseline_counts)]
        if sum(delta) == 0:
            return 0.0
        return self.predict_seconds.percentile_from_counts(delta, 0.95)
