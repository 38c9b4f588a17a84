"""Version-keyed serving result cache.

The port's own copy of ``predictionio_tpu/registry/result_cache.py``. The
cheapest request is the one that never enters the micro-batch queue. This
LRU answers repeat queries in microseconds, keyed on
``(model_version, canonical_query_bytes)`` — the model version IS the
cache epoch:

- **Version-keyed, not time-keyed.** Registry artifacts are immutable and
  content-addressed (``registry/store.py``): the same version answers a
  given query the same way forever, so an entry can never go stale by
  *model* change — a swap changes the lookup version and old entries
  simply stop being addressable. The TTL exists only for serving
  components that read live state outside the model (a FilterServing
  disabled-items file, the e-commerce constraint entities): their edits
  are visible within ``ttl_s`` at worst.
- **Stable lane only, quiesced rollouts only.** The query server bypasses
  the cache entirely while a rollout is active: canary users must
  exercise the candidate for the bake gates to mean anything, shadow mode
  needs dispatched stable answers to sample, and a cached canary answer
  outliving a rollback is exactly the stale-lane hazard the rollout
  machinery exists to prevent. Because candidate answers are never
  cached, "a canary answer served from a stale lane" is impossible by
  construction; the swap/rollback/promote paths additionally flush the
  affected version's entries (see QueryServer) so nothing lingers.
- **Hot-path cheap.** One small lock around an OrderedDict move-to-end;
  the serialized response text is memoized per entry on first hit, so a
  hit's respond phase is a prebuilt-string write.

Metrics are owned by the caller (the server wires pio_cache_* counters to
:meth:`stats`); this module stays import-light so tools can use it.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Callable


class _Entry:
    __slots__ = ("body", "text", "version", "expires_at")

    def __init__(self, body: Any, version: str, expires_at: float):
        self.body = body
        self.text: str | None = None  # serialized response, memoized on hit
        self.version = version
        self.expires_at = expires_at


class ResultCache:
    """Bounded LRU of encoded prediction bodies keyed on
    ``(model_version, canonical_query_bytes)``.

    ``max_entries <= 0`` disables every operation (the server treats a
    disabled cache as absent). ``ttl_s <= 0`` means entries live until
    evicted or invalidated.
    """

    def __init__(
        self,
        max_entries: int = 1024,
        ttl_s: float = 10.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.max_entries = int(max_entries)
        self.ttl_s = float(ttl_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._entries: OrderedDict[tuple[str, bytes], _Entry] = OrderedDict()
        # monotonic counters, surfaced as pio_cache_*_total by the server
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, version: str, key: bytes) -> _Entry | None:
        """The pre-admission lookup. Counts a hit or miss; an expired
        entry is dropped and counted as a miss."""
        if self.max_entries <= 0:
            return None
        k = (version, key)
        with self._lock:
            entry = self._entries.get(k)
            if entry is not None and (
                self.ttl_s > 0 and entry.expires_at < self._clock()
            ):
                del self._entries[k]
                self.evictions += 1
                entry = None
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(k)
            self.hits += 1
            return entry

    def put(self, version: str, key: bytes, body: Any) -> None:
        if self.max_entries <= 0:
            return
        entry = _Entry(
            body, version, self._clock() + self.ttl_s if self.ttl_s > 0 else 0.0
        )
        with self._lock:
            self._entries[(version, key)] = entry
            self._entries.move_to_end((version, key))
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.evictions += 1

    def flush_version(self, version: str) -> int:
        """Invalidate every entry of one model version (the swap /
        rollback / promote hook). Returns how many entries were dropped;
        the drop is counted as invalidations, not evictions."""
        with self._lock:
            doomed = [k for k in self._entries if k[0] == version]
            for k in doomed:
                del self._entries[k]
            self.invalidations += len(doomed)
            return len(doomed)

    def clear(self) -> int:
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self.invalidations += n
            return n

    def stats(self) -> dict[str, float]:
        with self._lock:
            return {
                "hits": float(self.hits),
                "misses": float(self.misses),
                "evictions": float(self.evictions),
                "invalidations": float(self.invalidations),
                "entries": float(len(self._entries)),
            }

    @property
    def hit_ratio(self) -> float:
        with self._lock:
            total = self.hits + self.misses
            return (self.hits / total) if total else 0.0
