"""Sharded columnar snapshot cache of the event table.

The reference hides event-scan throughput inside Spark's partitioned input
formats (``storage/jdbc/.../JDBCPEvents.scala:91-121`` JdbcRDD time-range
partitions, ``storage/hbase/.../HBPEvents.scala:63-95`` TableInputFormat
region splits): every ``pio train`` re-scans the SQL/HBase store in parallel.
Here the equivalent bottleneck is host-side: re-walking a row store and
re-dictionary-encoding 20M events per train run wastes minutes before the
first device step.

This module materialises the result of ``PEvents.to_columnar`` once, as N
row-block shards of dense numpy columns (``.npz``), keyed by a content stamp
of the underlying store. Subsequent trains with the same filters memory-load
the shards (near-disk-bandwidth) instead of re-scanning. Multi-host jobs pick
disjoint shard subsets deterministically (``shards_for_host``), mirroring the
reference's deterministic partition->executor assignment.

Invalidation: the cache key includes ``PEvents.version_stamp`` (cheap
count/max-rowid per backend). Any write to the app's events changes the stamp
and the next read rebuilds. Stale snapshot directories are garbage-collected
lazily (keep the newest ``keep`` per app/filter signature).

The port's own copy of ``predictionio_tpu/data/store/snapshot.py``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import uuid
from pathlib import Path
from typing import Any, Sequence

import numpy as np

from predictionio_tpu_torch.data.storage.base import ColumnarEvents

_META = "meta.json"


def _key(payload: dict[str, Any]) -> str:
    blob = json.dumps(payload, sort_keys=True, default=str).encode()
    return hashlib.sha1(blob).hexdigest()[:20]


def shards_for_host(n_shards: int, host_index: int, host_count: int) -> list[int]:
    """Deterministic host -> shard-subset assignment (round robin)."""
    if host_count <= 0:
        raise ValueError("host_count must be positive")
    return [s for s in range(n_shards) if s % host_count == host_index]


# canonical_order lives beside ColumnarEvents (it is a property of the
# encoding, used by parallel-scan drivers as well as this cache); re-exported
# here for existing importers
from predictionio_tpu_torch.data.storage.base import canonical_order  # noqa: E402,F401


def _shard_count_for(n_rows: int, n_shards: int) -> int:
    return max(1, min(n_shards, n_rows) if n_rows else 1)


def _shard_bounds(n_rows: int, n_shards: int) -> np.ndarray:
    return np.linspace(0, n_rows, n_shards + 1, dtype=np.int64)


def take_blocks(
    cols: ColumnarEvents, shard_ids: Sequence[int], n_shards: int = 8
) -> ColumnarEvents:
    """Select the row blocks that shards ``shard_ids`` of an ``n_shards``-way
    block partition would contain (same math as the shard files)."""
    n = len(cols)
    bounds = _shard_bounds(n, _shard_count_for(n, n_shards))
    idx = (
        np.concatenate(
            [np.arange(bounds[s], bounds[s + 1]) for s in shard_ids]
        ).astype(np.int64)
        if shard_ids
        else np.zeros((0,), np.int64)
    )
    take = idx.tolist()
    return ColumnarEvents(
        event_ids=[cols.event_ids[i] for i in take],
        event_names=[cols.event_names[i] for i in take],
        entity_ids=cols.entity_ids[idx],
        target_ids=cols.target_ids[idx],
        event_codes=cols.event_codes[idx],
        timestamps=cols.timestamps[idx],
        ratings=cols.ratings[idx],
        entity_vocab=cols.entity_vocab,
        target_vocab=cols.target_vocab,
        event_vocab=cols.event_vocab,
    )


def take_host_blocks(
    cols: ColumnarEvents, host_index: int, host_count: int, n_shards: int = 8
) -> ColumnarEvents:
    """This host's deterministic disjoint block subset (canonicalize first
    for order-nondeterministic drivers — see ``canonical_order``)."""
    count = _shard_count_for(len(cols), n_shards)
    return take_blocks(cols, shards_for_host(count, host_index, host_count), n_shards)


@dataclasses.dataclass
class SnapshotCache:
    """Columnar snapshot store rooted at ``root`` (one subdir per key)."""

    root: str | os.PathLike
    n_shards: int = 8
    keep: int = 2  # stale generations retained per signature before GC

    def __post_init__(self):
        self.root = Path(self.root)
        self.root.mkdir(parents=True, exist_ok=True)

    # -- public API ---------------------------------------------------------

    def columnar(
        self,
        p_events,
        app_id: int,
        channel_id: int | None = None,
        *,
        event_names: Sequence[str] | None = None,
        rating_key: str = "rating",
        host_index: int = 0,
        host_count: int = 1,
        refresh: bool = False,
        **find_kwargs: Any,
    ) -> ColumnarEvents:
        """Cached equivalent of ``p_events.to_columnar(...)``.

        Returns only this host's shard subset when ``host_count > 1``.
        """
        signature = {
            "app_id": app_id,
            "channel_id": channel_id,
            "event_names": sorted(event_names) if event_names else None,
            "rating_key": rating_key,
            "find": {k: str(v) for k, v in sorted(find_kwargs.items())},
            # distinct stores sharing one snapshot root must neither alias
            # on equal stamps nor GC each other's generations
            "store": getattr(p_events, "store_identity", lambda: None)(),
        }
        stamp = p_events.version_stamp(app_id, channel_id)
        key = _key({**signature, "stamp": stamp})
        d = self.root / key
        if refresh or stamp is None or not (d / _META).exists():
            # a caller-supplied frozen vocab IS the canonical encoding; only
            # scan-encounter-order vocabs need the deterministic remap
            cols = canonical_order(
                p_events.to_columnar(
                    app_id,
                    channel_id,
                    event_names=event_names,
                    rating_key=rating_key,
                    **find_kwargs,
                ),
                frozen_entity_vocab=find_kwargs.get("entity_vocab") is not None,
                frozen_target_vocab=find_kwargs.get("target_vocab") is not None,
            )
            if stamp is not None:
                self._write(d, cols, signature)
                self._gc(signature, keep_key=key)
            if host_count > 1:
                # Same block partition as the shard files, so a host that
                # misses (build pass) and a host that hits (shard read) see
                # disjoint, jointly-complete row sets. canonical_order above
                # makes this hold even for drivers whose scan order is
                # nondeterministic (ES parallel sliced scroll).
                shard_ids = shards_for_host(
                    self._shard_count(len(cols)), host_index, host_count
                )
                return self._take_blocks(cols, shard_ids)
            return cols
        shard_ids = shards_for_host(self._meta(d)["n_shards"], host_index, host_count)
        return self._read(d, shard_ids)

    # -- internals ----------------------------------------------------------

    def _meta(self, d: Path) -> dict:
        return json.loads((d / _META).read_text())

    def _shard_count(self, n_rows: int) -> int:
        return _shard_count_for(n_rows, self.n_shards)

    def _bounds(self, n_rows: int, n_shards: int) -> np.ndarray:
        return _shard_bounds(n_rows, n_shards)

    def _write(self, d: Path, cols: ColumnarEvents, signature: dict) -> None:
        # unique temp dir per writer: concurrent builders on a shared
        # snapshot root must not clobber each other's in-progress output
        tmp = d.parent / f".{d.name}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp"
        tmp.mkdir(parents=True)
        n = len(cols)
        n_shards = self._shard_count(n)
        bounds = self._bounds(n, n_shards)
        for s in range(n_shards):
            lo, hi = int(bounds[s]), int(bounds[s + 1])
            np.savez_compressed(
                tmp / f"shard_{s:05d}.npz",
                event_ids=np.asarray(cols.event_ids[lo:hi]),
                event_names=np.asarray(cols.event_names[lo:hi]),
                entity_ids=cols.entity_ids[lo:hi],
                target_ids=cols.target_ids[lo:hi],
                event_codes=cols.event_codes[lo:hi],
                timestamps=cols.timestamps[lo:hi],
                ratings=cols.ratings[lo:hi],
            )
        (tmp / _META).write_text(
            json.dumps(
                {
                    "n_rows": n,
                    "n_shards": n_shards,
                    "signature": signature,
                    "entity_vocab": cols.entity_vocab,
                    "target_vocab": cols.target_vocab,
                    "event_vocab": cols.event_vocab,
                }
            )
        )
        if d.exists():
            shutil.rmtree(d)
        try:
            tmp.rename(d)
        except OSError:
            # a concurrent builder renamed its identical snapshot first
            shutil.rmtree(tmp, ignore_errors=True)

    def _read(self, d: Path, shard_ids: Sequence[int]) -> ColumnarEvents:
        meta = self._meta(d)
        parts = [np.load(d / f"shard_{s:05d}.npz", allow_pickle=False) for s in shard_ids]

        def cat(name, dtype=None):
            if not parts:
                return np.zeros((0,), dtype or np.int32)
            arr = np.concatenate([p[name] for p in parts])
            return arr.astype(dtype) if dtype else arr

        return ColumnarEvents(
            event_ids=list(cat("event_ids").tolist()) if parts else [],
            event_names=list(cat("event_names").tolist()) if parts else [],
            entity_ids=cat("entity_ids", np.int32),
            target_ids=cat("target_ids", np.int32),
            event_codes=cat("event_codes", np.int32),
            timestamps=cat("timestamps", np.float64),
            ratings=cat("ratings", np.float32),
            entity_vocab=meta["entity_vocab"],
            target_vocab=meta["target_vocab"],
            event_vocab=meta["event_vocab"],
        )

    def _take_blocks(
        self, cols: ColumnarEvents, shard_ids: Sequence[int]
    ) -> ColumnarEvents:
        """Select the row blocks that shards ``shard_ids`` would contain."""
        return take_blocks(cols, shard_ids, self.n_shards)

    def _gc(self, signature: dict, keep_key: str) -> None:
        """Drop all-but-newest snapshot dirs sharing ``signature``."""
        matches = []
        for child in self.root.iterdir():
            meta_path = child / _META
            if not meta_path.exists() or child.name == keep_key:
                continue
            try:
                meta = json.loads(meta_path.read_text())
            except (OSError, json.JSONDecodeError):
                continue
            if meta.get("signature") == signature:
                matches.append((child.stat().st_mtime, child))
        matches.sort(reverse=True)
        for _, child in matches[max(0, self.keep - 1):]:
            shutil.rmtree(child, ignore_errors=True)
