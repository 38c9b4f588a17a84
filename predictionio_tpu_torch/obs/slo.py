"""Declarative SLOs evaluated as multi-window burn rates (the port's own
copy of ``predictionio_tpu/obs/slo.py``).

The paper's own serving target — ``pio deploy`` answering at <10 ms p50 —
has so far been a bench assertion, not an operational signal. This module
makes objectives first-class: each SLO declares what a *bad* event is
(request over the latency threshold, 5xx answer, shed request) and what
fraction of good events it promises (the objective); the engine then
evaluates **burn rates** over multiple trailing windows from counter
snapshots, the way SRE alerting does it:

    bad_ratio(window) = Δbad / Δtotal          (counter deltas)
    burn_rate(window) = bad_ratio / (1 - objective)

burn 1.0 = consuming error budget exactly at the allowed rate; burn 10 =
the budget is gone 10x too fast. An SLO is *alerting* when every window
of its (short, long) pair exceeds its threshold — the standard
multi-window guard against paging on a single bad scrape.

Sources are cheap callables returning cumulative ``(total, bad)`` read
from the existing registry instruments (no second bookkeeping path):
:func:`counter_ratio_source` splits a labeled counter by a bad-label
predicate, :func:`histogram_threshold_source` counts observations above a
bucket bound (which is why the SLO latency threshold should sit exactly
on a bucket boundary — 10 ms does, on the default ladder), and
:func:`paired_counter_source` rates one counter against another (shed
requests vs all requests).

Snapshots ride on the registry collector hook, i.e. window resolution is
scrape cadence — exactly the resolution Prometheus itself would have.
Exposed three ways: ``pio_slo_*`` gauges on ``/metrics``, the ``/slo``
JSON report, and the `pio top` SLO line. Stdlib-only.
"""

from __future__ import annotations

import bisect
import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable

from predictionio_tpu_torch.obs.metrics import Counter, Histogram, MetricsRegistry

# (window_seconds, alerting burn threshold): the classic fast/slow pair —
# the fast window catches a cliff, the slow window proves it's sustained;
# both must breach before `alerting` flips.
DEFAULT_WINDOWS: tuple[tuple[float, float], ...] = ((300.0, 14.4), (3600.0, 6.0))

# counter snapshots closer together than this are coalesced: burn math
# needs window-scale resolution, not per-scrape resolution
_MIN_SAMPLE_INTERVAL_S = 0.5

Source = Callable[[], tuple[float, float]]  # -> cumulative (total, bad)


def counter_ratio_source(
    counter: Counter,
    bad: Callable[[dict[str, str]], bool],
    match: Callable[[dict[str, str]], bool] | None = None,
) -> Source:
    """(total, bad) over a labeled counter: ``match`` selects the series
    that count at all (default: every series), ``bad`` the failing ones."""

    def source() -> tuple[float, float]:
        total = 0.0
        bad_total = 0.0
        for key, value in counter.collect():
            labels = dict(zip(counter.labelnames, key))
            if match is not None and not match(labels):
                continue
            total += value
            if bad(labels):
                bad_total += value
        return total, bad_total

    return source


def histogram_threshold_source(
    hist: Histogram, threshold_s: float, **labels: str
) -> Source:
    """(total, over-threshold) from a histogram's cumulative buckets.

    ``threshold_s`` should sit on a bucket bound; when it falls inside a
    bucket the whole bucket counts as good (the conservative direction
    for a latency objective is arguable either way — sitting on a bound
    makes the question moot, which is why the ladder carries 0.01).
    """
    i = bisect.bisect_right(hist.buckets, threshold_s)

    def source() -> tuple[float, float]:
        counts = hist.bucket_counts(**labels)
        total = float(sum(counts))
        return total, total - float(sum(counts[:i]))

    return source


def paired_counter_source(total_fn: Source, bad_counter: Counter) -> Source:
    """Rate one counter against another's total — e.g. shed requests
    (their own counter) against all requests."""

    def source() -> tuple[float, float]:
        total, _ = total_fn()
        return total, bad_counter.total()

    return source


@dataclasses.dataclass
class _Sample:
    t: float
    total: float
    bad: float


class _Objective:
    def __init__(
        self,
        name: str,
        description: str,
        objective: float,
        source: Source,
        windows: tuple[tuple[float, float], ...],
    ):
        if not 0.0 <= objective < 1.0:
            raise ValueError(
                f"objective must be in [0, 1) (got {objective}): an "
                f"objective of 1.0 has zero error budget and an infinite "
                f"burn rate on the first bad event"
            )
        self.name = name
        self.description = description
        self.objective = objective
        self.budget = 1.0 - objective
        self.source = source
        # burn rate is bounded above by 1/budget (every event bad), so the
        # SRE-default thresholds (14.4/6) are unreachable for loose
        # objectives — a p50-style objective of 0.50 caps burn at 2.0 and
        # would structurally never alert. Clamp each window's threshold to
        # 90% of the ceiling so every declared objective stays alertable.
        burn_ceiling = 1.0 / self.budget
        self.windows = tuple(
            (w, min(max_burn, 0.9 * burn_ceiling)) for w, max_burn in windows
        )
        # samples arrive at scrape cadence; rate-limit recording and size
        # the deque from the slowest window so aggressive pollers (several
        # concurrent `pio top` watchers + a scraper) can never evict
        # samples still inside the window and silently shrink its span
        self._horizon_s = max(w for w, _ in self.windows) * 1.25
        maxlen = int(self._horizon_s / _MIN_SAMPLE_INTERVAL_S) + 16
        self.samples: deque[_Sample] = deque(maxlen=maxlen)

    def record(self, now: float) -> None:
        if self.samples and now - self.samples[-1].t < _MIN_SAMPLE_INTERVAL_S:
            return  # coalesce scrape bursts; windows keep full span
        total, bad = self.source()
        self.samples.append(_Sample(now, float(total), float(bad)))
        horizon = now - self._horizon_s
        while len(self.samples) > 2 and self.samples[0].t < horizon:
            self.samples.popleft()

    def evaluate(self, now: float) -> dict[str, Any]:
        latest = self.samples[-1] if self.samples else _Sample(now, 0.0, 0.0)
        windows: list[dict[str, Any]] = []
        breaches = 0
        evaluable = 0
        for window_s, max_burn in self.windows:
            base = None
            for s in self.samples:  # oldest sample still inside the window
                if s.t >= now - window_s:
                    base = s
                    break
            if base is None or base is latest:
                windows.append(
                    {
                        "window_s": window_s,
                        "actual_window_s": 0.0,
                        "total": 0.0,
                        "bad": 0.0,
                        "bad_ratio": 0.0,
                        "burn_rate": 0.0,
                        "max_burn": max_burn,
                    }
                )
                continue
            evaluable += 1
            d_total = max(0.0, latest.total - base.total)
            d_bad = max(0.0, latest.bad - base.bad)
            ratio = (d_bad / d_total) if d_total > 0 else 0.0
            burn = ratio / self.budget
            if burn > max_burn:
                breaches += 1
            windows.append(
                {
                    "window_s": window_s,
                    "actual_window_s": round(latest.t - base.t, 3),
                    "total": d_total,
                    "bad": d_bad,
                    "bad_ratio": round(ratio, 6),
                    "burn_rate": round(burn, 4),
                    "max_burn": max_burn,
                }
            )
        # multi-window rule: every evaluable window must breach; no data
        # is "not alerting", not "unknown-so-page"
        alerting = evaluable == len(self.windows) and breaches == len(self.windows)
        slow = windows[-1] if windows else None
        budget_remaining = (
            max(0.0, 1.0 - slow["bad_ratio"] / self.budget) if slow else 1.0
        )
        return {
            "name": self.name,
            "description": self.description,
            "objective": self.objective,
            "windows": windows,
            "alerting": alerting,
            "budget_remaining": round(budget_remaining, 4),
        }


class SLOEngine:
    """Objective registry + evaluator + gauge exporter.

    Construct with the server's metrics registry, ``add(...)`` each
    objective, then ``registry.register_collector(engine.collect)`` so
    every scrape snapshots the counters and refreshes the ``pio_slo_*``
    gauges. ``report(now=...)`` is the JSON twin behind ``/slo``.
    """

    def __init__(self, registry: MetricsRegistry):
        self._lock = threading.Lock()
        self._objectives: list[_Objective] = []
        self._g_burn = registry.gauge(
            "pio_slo_burn_rate",
            "error-budget burn rate per SLO and trailing window "
            "(1.0 = consuming budget exactly at the allowed rate)",
            labelnames=("slo", "window"),
        )
        self._g_bad = registry.gauge(
            "pio_slo_bad_ratio",
            "bad-event fraction per SLO and trailing window",
            labelnames=("slo", "window"),
        )
        self._g_alerting = registry.gauge(
            "pio_slo_alerting",
            "1 when every window of the SLO's multi-window pair exceeds "
            "its burn threshold",
            labelnames=("slo",),
        )
        self._g_objective = registry.gauge(
            "pio_slo_objective",
            "declared good-event objective per SLO",
            labelnames=("slo",),
        )

    def add(
        self,
        name: str,
        description: str,
        objective: float,
        source: Source,
        windows: tuple[tuple[float, float], ...] = DEFAULT_WINDOWS,
    ) -> None:
        with self._lock:
            if any(o.name == name for o in self._objectives):
                raise ValueError(f"duplicate SLO {name!r}")
            self._objectives.append(
                _Objective(name, description, objective, source, windows)
            )
        self._g_objective.set(objective, slo=name)

    def tick(self, now: float | None = None) -> None:
        """Snapshot every objective's counters (monotonic clock — burn
        windows must never jump with a wall-clock step)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            objectives = list(self._objectives)
        for obj in objectives:
            try:
                obj.record(now)
            except Exception:
                pass  # a broken source must not break the scrape

    def evaluate(self, now: float | None = None) -> list[dict[str, Any]]:
        now = time.monotonic() if now is None else now
        with self._lock:
            objectives = list(self._objectives)
        out = []
        for obj in objectives:
            report = obj.evaluate(now)
            for w in report["windows"]:
                label = str(int(w["window_s"]))
                self._g_burn.set(w["burn_rate"], slo=obj.name, window=label)
                self._g_bad.set(w["bad_ratio"], slo=obj.name, window=label)
            self._g_alerting.set(
                1.0 if report["alerting"] else 0.0, slo=obj.name
            )
            out.append(report)
        return out

    def collect(self) -> None:
        """Registry collector hook: one tick + gauge refresh per scrape."""
        self.tick()
        self.evaluate()

    def report(self, now: float | None = None) -> dict[str, Any]:
        """The ``/slo`` JSON body."""
        self.tick(now)
        return {"slos": self.evaluate(now)}


__all__ = [
    "DEFAULT_WINDOWS",
    "SLOEngine",
    "counter_ratio_source",
    "histogram_threshold_source",
    "paired_counter_source",
]
