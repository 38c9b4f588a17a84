"""Thread-safe TTL + LRU cache for serving-time storage lookups (own copy
of ``predictionio_tpu/utils/ttl_cache.py``).

The reference's e-commerce template queries the live LEventStore on every
predict (seen items, unavailable-items constraint —
``train-with-rate-event/src/main/scala/ECommAlgorithm.scala:252-300``),
putting one-or-more row-store round trips on the query hot path. Serving
here caches those lookups for a short TTL so steady-state p50 pays zero
storage round trips; ``ttl_s=0`` disables caching entirely, restoring the
reference's always-live semantics.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Hashable


class TTLCache:
    """``get_or_load(key, loader)`` with per-entry TTL and LRU bound.

    The loader runs OUTSIDE the lock (it does I/O); concurrent misses on
    one key may load twice — harmless for idempotent reads, and better
    than serializing every cache user behind storage latency.
    """

    def __init__(self, ttl_s: float, maxsize: int = 4096):
        self.ttl_s = float(ttl_s)
        self.maxsize = int(maxsize)
        self._entries: OrderedDict[Hashable, tuple[float, Any]] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get_or_load(self, key: Hashable, loader: Callable[[], Any]) -> Any:
        if self.ttl_s <= 0:
            return loader()
        now = time.monotonic()
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and now - entry[0] < self.ttl_s:
                self._entries.move_to_end(key)
                self.hits += 1
                return entry[1]
            self.misses += 1
        value = loader()
        with self._lock:
            self._entries[key] = (time.monotonic(), value)
            self._entries.move_to_end(key)
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
        return value

    def invalidate(self, key: Hashable | None = None) -> None:
        with self._lock:
            if key is None:
                self._entries.clear()
            else:
                self._entries.pop(key, None)
