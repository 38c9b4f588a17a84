"""Lock-cheap metrics registry: counters, gauges and fixed-bucket
histograms, with the Prometheus text exposition (v0.0.4) and its
OpenMetrics variant with per-bucket trace-id exemplars.

The port's own copy of ``predictionio_tpu/obs/metrics.py``. The exposition
is byte-equal to the JAX package's for the same operations: sample values
go through :func:`format_value` (an integral value renders without
``.0``, infinities as ``+Inf``/``-Inf``), so a histogram's ``le="1"`` and a
counter's ``3`` are the same label values and samples a dashboard written
against the reference expects.

- ``inc``/``observe`` take one small per-metric lock; the registry lock is
  taken only at instrument creation and scrape time.
- Histograms use a fixed bucket ladder (100 us to 10 s by default);
  percentiles walk the cumulative counts and interpolate in the bucket.
- ``snapshot()`` is the JSON twin of ``render_prometheus()``.

Standard library only: the event server and the CLI use it without torch.
"""

from __future__ import annotations

import bisect
import logging
import math
import re
import threading
from typing import Any, Callable, Iterable

logger = logging.getLogger(__name__)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# serving-latency ladder in seconds: 100us up to 10s, roughly 2-2.5x steps.
# Fixed (not exponential-growing) so every writer only increments ints.
DEFAULT_BUCKETS = (
    0.0001,
    0.00025,
    0.0005,
    0.001,
    0.0025,
    0.005,
    0.01,
    0.025,
    0.05,
    0.1,
    0.25,
    0.5,
    1.0,
    2.5,
    5.0,
    10.0,
)


def _escape_label_value(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _format_labels(names: tuple[str, ...], values: tuple[str, ...]) -> str:
    if not names:
        return ""
    inner = ",".join(
        f'{n}="{_escape_label_value(v)}"' for n, v in zip(names, values)
    )
    return "{" + inner + "}"


def format_value(v: float) -> str:
    """Prometheus sample value: integers render without a trailing .0."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Metric:
    """Shared label plumbing. Subclasses hold per-labelset state in
    ``_series`` keyed by the tuple of label values (in ``labelnames``
    order) and guard it with one small lock."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", labelnames: tuple[str, ...] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._series: dict[tuple[str, ...], Any] = {}

    def _key(self, labels: dict[str, str]) -> tuple[str, ...]:
        # every label name present and no other: the same check as
        # comparing the two sets, without building them on the hot path
        if len(labels) == len(self.labelnames):
            try:
                return tuple(str(labels[n]) for n in self.labelnames)
            except KeyError:
                pass
        raise ValueError(
            f"metric {self.name} takes labels {self.labelnames}, "
            f"got {tuple(sorted(labels))}"
        )

    def collect(self) -> list[tuple[tuple[str, ...], Any]]:
        """Snapshot of (label_values, state) pairs, stable order."""
        with self._lock:
            return sorted(self._series.items())

    def remove(self, **labels: str) -> bool:
        """Drop one labeled series from the exposition (no-op when it was
        never observed). The fleet uses this when a replica is retired:
        a gauge for a worker that no longer exists is not 'zero', it is
        *gone* — rendering it forever reads as a live-but-down replica."""
        key = self._key(labels)
        with self._lock:
            return self._series.pop(key, None) is not None

    def prune(self, label_name: str, keep: Iterable[str]) -> int:
        """Reconcile-against-live-set: drop every series whose value for
        ``label_name`` is not in ``keep`` (the discipline the
        ``pio_ann_index_*`` gauges follow). Returns how many series were
        dropped. Unlabeled metrics and metrics without ``label_name``
        are left untouched."""
        if label_name not in self.labelnames:
            return 0
        idx = self.labelnames.index(label_name)
        keep_set = {str(v) for v in keep}
        with self._lock:
            dead = [k for k in self._series if k[idx] not in keep_set]
            for k in dead:
                del self._series[k]
            return len(dead)

    def render(self, exemplars: bool = False) -> list[str]:
        raise NotImplementedError


class Counter(_Metric):
    """Monotonically increasing float. ``set_total`` exists to mirror a
    counter maintained elsewhere (e.g. the micro-batcher's plain-int
    trip counts) without double bookkeeping — it clamps to monotonic."""

    kind = "counter"

    def __init__(self, name: str, help: str = "", labelnames: tuple[str, ...] = ()):
        super().__init__(name, help, labelnames)
        if not labelnames:
            # an unlabeled counter scrapes as an explicit 0 before its
            # first increment — "shed happened zero times" is a signal,
            # a missing series is a dashboard hole
            self._series[()] = 0.0

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def set_total(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = max(self._series.get(key, 0.0), float(value))

    def value(self, **labels: str) -> float:
        key = self._key(labels)
        with self._lock:
            return self._series.get(key, 0.0)

    def total(self) -> float:
        with self._lock:
            return sum(self._series.values())

    def render(self, exemplars: bool = False) -> list[str]:
        return [
            f"{self.name}{_format_labels(self.labelnames, k)} {format_value(v)}"
            for k, v in self.collect()
        ]


class Gauge(_Metric):
    """Point-in-time value. ``set_function`` registers a callback read at
    collect time (queue depth, breaker state) so the hot path pays
    nothing for gauges that merely mirror existing state."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "", labelnames: tuple[str, ...] = ()):
        super().__init__(name, help, labelnames)
        if not labelnames:
            self._series[()] = 0.0  # same explicit-zero contract as Counter

    def set(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self.inc(-amount, **labels)

    def set_function(self, fn: Callable[[], float], **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = fn

    def value(self, **labels: str) -> float:
        key = self._key(labels)
        with self._lock:
            v = self._series.get(key, 0.0)
        return float(v() if callable(v) else v)

    def render(self, exemplars: bool = False) -> list[str]:
        out = []
        for k, v in self.collect():
            if callable(v):
                try:
                    v = float(v())
                except Exception:
                    continue  # a failing callback must not break the scrape
            out.append(
                f"{self.name}{_format_labels(self.labelnames, k)} {format_value(v)}"
            )
        return out


class _HistogramSeries:
    __slots__ = ("counts", "count", "sum", "max", "exemplars")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # +1 for the +Inf bucket
        self.count = 0
        self.sum = 0.0
        self.max = 0.0
        # bucket index -> (exemplar_id, observed_value): the most recent
        # trace id observed into each bucket, so a tail bucket links to a
        # concrete trace in /traces/recent (OpenMetrics exemplars)
        self.exemplars: dict[int, tuple[str, float]] = {}


class Histogram(_Metric):
    """Fixed-bucket histogram with percentile extraction.

    ``observe`` is O(log B) (bisect into the bucket ladder) under the
    metric lock; percentiles walk cumulative counts at read time and
    interpolate inside the winning bucket, which is exact enough for
    p50/p95/p99 dashboards (error bounded by bucket width).
    """

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str = "",
        labelnames: tuple[str, ...] = (),
        buckets: Iterable[float] | None = None,
    ):
        super().__init__(name, help, labelnames)
        bs = tuple(sorted(buckets if buckets is not None else DEFAULT_BUCKETS))
        if not bs:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = bs

    def observe(
        self, value: float, exemplar: str | None = None, **labels: str
    ) -> None:
        """Record one observation. ``exemplar`` (typically the request's
        trace id) is kept per bucket — last writer wins — and rendered in
        the OpenMetrics exposition so a p99 outlier links to a concrete
        trace instead of being an anonymous count."""
        self.observe_many(value, 1, exemplar, **labels)

    def observe_many(
        self, value: float, count: int, exemplar: str | None = None, **labels: str
    ) -> None:
        """Record ``count`` observations of one value under one lock (a
        batch's riders share its batch-scoped phases); the exemplar is
        the last rider's, as ``count`` calls of :meth:`observe` leave it."""
        value = float(value)
        i = bisect.bisect_left(self.buckets, value)
        key = self._key(labels)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = _HistogramSeries(len(self.buckets))
            series.counts[i] += count
            series.count += count
            series.sum += value * count
            if value > series.max:
                series.max = value
            if exemplar:
                series.exemplars[i] = (str(exemplar), value)

    def _snapshot_series(self, key: tuple[str, ...]) -> _HistogramSeries | None:
        with self._lock:
            series = self._series.get(key)
            if series is None:
                return None
            copy = _HistogramSeries(len(self.buckets))
            copy.counts = list(series.counts)
            copy.count = series.count
            copy.sum = series.sum
            copy.max = series.max
            copy.exemplars = dict(series.exemplars)
            return copy

    def _percentile_of(self, series: _HistogramSeries, q: float) -> float:
        if series.count == 0:
            return 0.0
        target = q * series.count
        acc = 0
        for i, c in enumerate(series.counts):
            prev_acc = acc
            acc += c
            if acc >= target:
                if i >= len(self.buckets):  # +Inf bucket: no upper bound
                    return self.buckets[-1]
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i]
                frac = (target - prev_acc) / c if c else 1.0
                return lo + (hi - lo) * frac
        return self.buckets[-1]

    def percentile(self, q: float, **labels: str) -> float:
        series = self._snapshot_series(self._key(labels))
        if series is None:
            return 0.0
        return self._percentile_of(series, q)

    def bucket_counts(self, **labels: str) -> list[int]:
        """Per-bucket observation counts snapshot (last slot = +Inf); a
        zero vector when the series doesn't exist yet. Callers keep this
        as a baseline and hand the elementwise delta of two snapshots to
        :meth:`percentile_from_counts` — percentiles over a *window*,
        which a lifetime histogram cannot answer directly."""
        series = self._snapshot_series(self._key(labels))
        if series is None:
            return [0] * (len(self.buckets) + 1)
        return list(series.counts)

    def percentile_from_counts(self, counts: list[int], q: float) -> float:
        """Percentile over an externally supplied bucket-count vector
        (e.g. a delta of two :meth:`bucket_counts` snapshots)."""
        series = _HistogramSeries(len(self.buckets))
        series.counts = list(counts)
        series.count = sum(counts)
        return self._percentile_of(series, q)

    def exemplars(self, **labels: str) -> dict[str, dict[str, Any]]:
        """``{bucket_le: {"exemplar": id, "value": seconds}}`` snapshot of
        the per-bucket exemplars (``le`` formatted like the exposition,
        ``+Inf`` for the overflow bucket); empty when none captured."""
        series = self._snapshot_series(self._key(labels))
        if series is None:
            return {}
        out: dict[str, dict[str, Any]] = {}
        for i, (ex, v) in sorted(series.exemplars.items()):
            le = (
                format_value(self.buckets[i])
                if i < len(self.buckets)
                else "+Inf"
            )
            out[le] = {"exemplar": ex, "value": v}
        return out

    def summary(self, **labels: str) -> dict[str, float]:
        """One consistent snapshot -> count/mean/p50/p95/p99/sum (seconds)."""
        series = self._snapshot_series(self._key(labels))
        if series is None or series.count == 0:
            return {"count": 0}
        return {
            "count": series.count,
            "sum": series.sum,
            "mean": series.sum / series.count,
            "p50": self._percentile_of(series, 0.50),
            "p95": self._percentile_of(series, 0.95),
            "p99": self._percentile_of(series, 0.99),
            "max": series.max,
        }

    @staticmethod
    def _exemplar_suffix(series: _HistogramSeries, i: int) -> str:
        """OpenMetrics exemplar clause for bucket ``i`` (empty when none):
        ``# {trace_id="…"} <value>`` appended after the bucket sample."""
        entry = series.exemplars.get(i)
        if entry is None:
            return ""
        ex, v = entry
        return f' # {{trace_id="{_escape_label_value(ex)}"}} {format_value(v)}'

    def render(self, exemplars: bool = False) -> list[str]:
        out = []
        for key, _ in self.collect():
            series = self._snapshot_series(key)
            if series is None:
                continue
            acc = 0
            for i, (bound, c) in enumerate(zip(self.buckets, series.counts)):
                acc += c
                names = self.labelnames + ("le",)
                values = key + (format_value(bound),)
                suffix = self._exemplar_suffix(series, i) if exemplars else ""
                out.append(
                    f"{self.name}_bucket{_format_labels(names, values)} "
                    f"{acc}{suffix}"
                )
            names = self.labelnames + ("le",)
            suffix = (
                self._exemplar_suffix(series, len(self.buckets))
                if exemplars
                else ""
            )
            out.append(
                f"{self.name}_bucket{_format_labels(names, key + ('+Inf',))} "
                f"{series.count}{suffix}"
            )
            out.append(
                f"{self.name}_sum{_format_labels(self.labelnames, key)} "
                f"{format_value(series.sum)}"
            )
            out.append(
                f"{self.name}_count{_format_labels(self.labelnames, key)} "
                f"{series.count}"
            )
        return out


class MetricsRegistry:
    """Instrument factory + exposition. Get-or-create semantics so every
    layer (server, batcher, stats collector, build watcher) can ask for
    the instrument by name without threading object references around;
    re-declaring with a different type or label set is a programming
    error and raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}
        self._collectors: list[Callable[[], None]] = []

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
            metric = cls(name, help, labelnames, **kw)
            self._metrics[name] = metric
            return metric

    def counter(
        self, name: str, help: str = "", labelnames: Iterable[str] = ()
    ) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(
        self, name: str, help: str = "", labelnames: Iterable[str] = ()
    ) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(
        self,
        name: str,
        help: str = "",
        labelnames: Iterable[str] = (),
        buckets: Iterable[float] | None = None,
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def get(self, name: str) -> _Metric | None:
        with self._lock:
            return self._metrics.get(name)

    def register_collector(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` before every scrape/snapshot — the hook lazy gauges
        and the kernel-build watcher use to refresh derived state exactly when
        someone is looking."""
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

    def render_prometheus(self, exemplars: bool = False) -> str:
        """Prometheus text exposition format v0.0.4. With ``exemplars=True``
        histogram bucket lines carry OpenMetrics exemplar clauses
        (``… # {trace_id="…"} value``) and the output ends with ``# EOF``
        — serve that variant only to scrapers that negotiated OpenMetrics
        (a strict v0.0.4 parser rejects exemplar syntax)."""
        self._run_collectors()
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        lines: list[str] = []
        for m in metrics:
            if m.help:
                escaped = m.help.replace("\\", "\\\\").replace("\n", "\\n")
                lines.append(f"# HELP {m.name} {escaped}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m.render(exemplars=exemplars))
        if exemplars:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict[str, Any]:
        """JSON twin of the exposition: bench output and dashboards."""
        self._run_collectors()
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        out: dict[str, Any] = {}
        for m in metrics:
            samples: list[dict[str, Any]] = []
            if isinstance(m, Histogram):
                for key, _ in m.collect():
                    labels = dict(zip(m.labelnames, key))
                    samples.append({"labels": labels, **m.summary(**labels)})
            else:
                for key, v in m.collect():
                    if callable(v):
                        try:
                            v = float(v())
                        except Exception:
                            continue
                    samples.append(
                        {"labels": dict(zip(m.labelnames, key)), "value": v}
                    )
            out[m.name] = {"type": m.kind, "samples": samples}
        return out
