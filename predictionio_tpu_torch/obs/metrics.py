"""Lock-cheap metrics registry: counters, gauges and fixed-bucket
histograms (port of ``predictionio_tpu/obs/metrics.py``; its Prometheus
text exposition without exemplars).

``inc``/``observe`` take one small per-metric lock; the registry lock is
taken only at instrument creation. Histograms use a fixed bucket ladder and
read percentiles by walking the cumulative counts.
"""

from __future__ import annotations

import bisect
import logging
import re
import threading
from typing import Any, Callable, Iterable

logger = logging.getLogger(__name__)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# latency ladder in seconds, 100 us to 10 s
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class _Metric:
    kind = ""

    def __init__(self, name: str, help: str = "", labelnames: tuple[str, ...] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for label in labelnames:
            if not _LABEL_RE.match(label) or label.startswith("__"):
                raise ValueError(f"invalid label name {label!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._series: dict[tuple[str, ...], Any] = {}

    def _key(self, labels: dict[str, str]) -> tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, got {tuple(sorted(labels))}"
            )
        return tuple(str(labels[n]) for n in self.labelnames)

    def collect(self) -> list[tuple[tuple[str, ...], Any]]:
        with self._lock:
            return list(self._series.items())


class Counter(_Metric):
    """Monotonically increasing float."""

    kind = "counter"

    def __init__(self, name: str, help: str = "", labelnames: tuple[str, ...] = ()):
        super().__init__(name, help, labelnames)
        if not labelnames:
            self._series[()] = 0.0  # an explicit 0 before the first inc

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        key = self._key(labels)
        with self._lock:
            return self._series.get(key, 0.0)


class Gauge(_Metric):
    """Point-in-time value."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "", labelnames: tuple[str, ...] = ()):
        super().__init__(name, help, labelnames)
        if not labelnames:
            self._series[()] = 0.0

    def set(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(value)

    def value(self, **labels: str) -> float:
        key = self._key(labels)
        with self._lock:
            return float(self._series.get(key, 0.0))


class _HistogramSeries:
    __slots__ = ("counts", "count", "sum", "max")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # +1 for the +Inf bucket
        self.count = 0
        self.sum = 0.0
        self.max = 0.0


class Histogram(_Metric):
    """Fixed-bucket histogram; percentiles interpolate inside the bucket."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str = "",
        labelnames: tuple[str, ...] = (),
        buckets: Iterable[float] | None = None,
    ):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(buckets if buckets is not None else DEFAULT_BUCKETS))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")

    def observe(self, value: float, **labels: str) -> None:
        value = float(value)
        i = bisect.bisect_left(self.buckets, value)
        key = self._key(labels)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = _HistogramSeries(len(self.buckets))
            series.counts[i] += 1
            series.count += 1
            series.sum += value
            series.max = max(series.max, value)

    def _snapshot(self, labels: dict[str, str]) -> tuple[list[int], int] | None:
        key = self._key(labels)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                return None
            return list(series.counts), series.count

    def _percentile_of(self, counts: list[int], count: int, q: float) -> float:
        if count == 0:
            return 0.0
        target = q * count
        acc = 0
        for i, c in enumerate(counts):
            prev, acc = acc, acc + c
            if acc >= target:
                if i >= len(self.buckets):
                    return self.buckets[-1]
                lo = self.buckets[i - 1] if i > 0 else 0.0
                return lo + (self.buckets[i] - lo) * ((target - prev) / c if c else 1.0)
        return self.buckets[-1]

    def percentile(self, q: float, **labels: str) -> float:
        snap = self._snapshot(labels)
        return 0.0 if snap is None else self._percentile_of(*snap, q)

    def bucket_counts(self, **labels: str) -> list[int]:
        """Per-bucket counts (last slot +Inf), zeros before the first
        observation: a baseline whose elementwise delta to a later snapshot
        :meth:`percentile_from_counts` reads as a window."""
        snap = self._snapshot(labels)
        return [0] * (len(self.buckets) + 1) if snap is None else snap[0]

    def percentile_from_counts(self, counts: list[int], q: float) -> float:
        return self._percentile_of(list(counts), sum(counts), q)

    def summary(self, **labels: str) -> dict[str, float]:
        key = self._key(labels)
        with self._lock:
            series = self._series.get(key)
            if series is None or series.count == 0:
                return {"count": 0}
            count, total, peak = series.count, series.sum, series.max
        return {
            "count": count,
            "sum": total,
            "mean": total / count,
            "p50": self.percentile(0.50, **labels),
            "p95": self.percentile(0.95, **labels),
            "p99": self.percentile(0.99, **labels),
            "max": peak,
        }


class MetricsRegistry:
    """Get-or-create instrument factory; re-declaring a name with another
    type or label set raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}
        self._collectors: list[Callable[[], None]] = []

    def register_collector(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` before every snapshot and scrape: the hook that
        refreshes derived gauges exactly when someone reads them."""
        with self._lock:
            self._collectors.append(fn)

    def _run_collectors(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            except Exception:  # a broken collector must not fail the scrape
                logger.exception("metrics collector %r failed", fn)

    def _get_or_create(self, cls, name: str, help: str, labelnames, **kw) -> Any:
        labelnames = tuple(labelnames)
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not cls or existing.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(existing).__name__}{existing.labelnames}"
                    )
                return existing
            metric = self._metrics[name] = cls(name, help, labelnames, **kw)
            return metric

    def counter(self, name: str, help: str = "", labelnames: Iterable[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames: Iterable[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(
        self,
        name: str,
        help: str = "",
        labelnames: Iterable[str] = (),
        buckets: Iterable[float] | None = None,
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames, buckets=buckets)

    def snapshot(self) -> dict[str, Any]:
        """JSON view: every series of every instrument."""
        self._run_collectors()
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        out: dict[str, Any] = {}
        for m in metrics:
            samples = []
            for key, v in m.collect():
                labels = dict(zip(m.labelnames, key))
                if isinstance(m, Histogram):
                    samples.append({"labels": labels, **m.summary(**labels)})
                else:
                    samples.append({"labels": labels, "value": v})
            out[m.name] = {"type": m.kind, "samples": samples}
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition v0.0.4 of every series."""
        self._run_collectors()
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        lines: list[str] = []
        for m in metrics:
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for key, v in sorted(m.collect()):
                labels = dict(zip(m.labelnames, key))
                if isinstance(m, Histogram):
                    acc = 0
                    for bound, c in zip((*m.buckets, "+Inf"), v.counts):
                        acc += c
                        le = bound if bound == "+Inf" else repr(float(bound))
                        lines.append(f"{m.name}_bucket{_labels({**labels, 'le': le})} {acc}")
                    lines.append(f"{m.name}_sum{_labels(labels)} {v.sum!r}")
                    lines.append(f"{m.name}_count{_labels(labels)} {v.count}")
                else:
                    lines.append(f"{m.name}{_labels(labels)} {float(v)!r}")
        return "\n".join(lines) + "\n"


def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{_escape(str(v))}"' for k, v in labels.items()) + "}"
