"""Serving-latency histogram (own copy of
``predictionio_tpu/utils/histogram.py``): exponential buckets, O(1)
observe, percentiles read as a bucket's upper edge.

The reference only tracked request count + running average
(``CreateServer.scala:400-402``); BASELINE.md asks for latency
percentiles (p50 target < 10 ms).
"""

from __future__ import annotations

import math
import threading


class LatencyHistogram:
    """Exponential buckets from 10us to ~100s, factor 1.25."""

    FACTOR = 1.25
    MIN_SEC = 1e-5

    def __init__(self):
        self._lock = threading.Lock()
        n = int(math.log(1e7, self.FACTOR)) + 2  # covers up to ~1e2 s
        self._buckets = [0] * n
        self._count = 0
        self._sum = 0.0
        self._max = 0.0

    def _index(self, sec: float) -> int:
        if sec <= self.MIN_SEC:
            return 0
        i = int(math.log(sec / self.MIN_SEC, self.FACTOR)) + 1
        return min(i, len(self._buckets) - 1)

    def observe(self, sec: float) -> None:
        with self._lock:
            self._buckets[self._index(sec)] += 1
            self._count += 1
            self._sum += sec
            self._max = max(self._max, sec)

    def _bucket_upper(self, i: int) -> float:
        return self.MIN_SEC * (self.FACTOR ** i)

    def _percentile_of(
        self, buckets: list[int], count: int, mx: float, q: float
    ) -> float:
        if count == 0:
            return 0.0
        target = q * count
        acc = 0
        for i, c in enumerate(buckets):
            acc += c
            if acc >= target:
                return self._bucket_upper(i)
        return mx

    def percentile(self, q: float) -> float:
        with self._lock:
            return self._percentile_of(self._buckets, self._count, self._max, q)

    def summary(self) -> dict:
        # ONE snapshot under the lock: re-reading live state per percentile
        # could report a p99 above the reported max when observe() lands
        # between the reads
        with self._lock:
            count, total, mx = self._count, self._sum, self._max
            buckets = list(self._buckets)
        if count == 0:
            return {"count": 0}
        return {
            "count": count,
            "mean_ms": 1000.0 * total / count,
            "p50_ms": 1000.0 * self._percentile_of(buckets, count, mx, 0.50),
            "p95_ms": 1000.0 * self._percentile_of(buckets, count, mx, 0.95),
            "p99_ms": 1000.0 * self._percentile_of(buckets, count, mx, 0.99),
            "max_ms": 1000.0 * mx,
        }
