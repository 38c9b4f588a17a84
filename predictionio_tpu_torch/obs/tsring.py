"""Durable telemetry ring: a fixed-size on-disk history of fleet snapshots
(the port's own copy of ``predictionio_tpu/obs/tsring.py``).

``/metrics`` federation is scrape-instant — the moment a worker dies or a
gateway restarts, the history an incident needs (queue depth climbing,
burn rate crossing, a replica flapping) is gone. This module keeps a
bounded, crash-safe window of it on disk:

- **Fixed size.** The ring is ``segments`` JSONL files of at most
  ``segment_records`` records each; when the active segment fills, the
  writer rotates to the next slot and truncates whatever the oldest
  cycle left there. Total disk use is bounded by construction — the ring
  can run for months without an operator thinking about it.
- **Atomic segment writes.** Each record is one ``json.dumps`` line
  written with a single ``write()`` + flush; a reader never sees half a
  record *as a record* because anything that does not parse as a
  complete JSON line (the torn tail of a crashed writer) is skipped on
  read. Rotation truncates via ``O_TRUNC`` open — a crash mid-rotation
  leaves either the old segment (stale seqs, superseded on read) or an
  empty file, both of which resume cleanly.
- **Crash-safe resume.** Every record carries a monotonically increasing
  ``seq``. On open, the ring scans all segments, finds the highest seq
  and its segment, and continues appending there — a restarted gateway
  picks up exactly where the dead one stopped, and ``window()`` serves
  the pre-crash history (the acceptance property ``pio top --history``
  leans on).

Queries: :meth:`TelemetryRing.window` (records newer than ``now - s``,
what ``GET /telemetry/window?s=N`` serves) and :meth:`TelemetryRing.tail`
(last N records, what incident bundles embed). Stdlib-only — `pio top`
and the CLI read rings without importing torch.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any

_SEGMENT_PREFIX = "seg-"
_SEGMENT_SUFFIX = ".jsonl"


class TelemetryRing:
    """Bounded on-disk ring of JSON snapshot records.

    One writer (the gateway/supervisor process), any number of readers
    (the CLI reads the directory directly). Writer methods are
    thread-safe within the process; cross-process single-writer
    discipline is the caller's (the fleet parent owns its ring).
    """

    def __init__(
        self,
        dir_path: str,
        segment_records: int = 256,
        segments: int = 8,
        writer_id: str = "",
    ):
        if segments < 2:
            raise ValueError("ring needs at least 2 segments to rotate")
        if segment_records < 1:
            raise ValueError("segment_records must be >= 1")
        if writer_id and not writer_id.replace("-", "").isalnum():
            raise ValueError("writer_id must be alphanumeric/dashes")
        self.dir = dir_path
        self.segment_records = int(segment_records)
        self.segments = int(segments)
        # writer namespace (--gateways N): each writer owns its own
        # segment files (``seg-<writer>-NNNNN.jsonl``) so two gateways
        # sharing one obs dir never interleave — or truncate — one
        # segment. The default "" keeps the classic single-writer names.
        # READS merge every writer's segments (ordered by time), so the
        # autoscaler and `pio top --history` see the whole tier.
        self.writer_id = writer_id
        self._lock = threading.Lock()
        os.makedirs(self.dir, exist_ok=True)
        self._fh = None  # lazily (re)opened append handle
        self._resume()

    # ------------------------------------------------------------------ io
    def _segment_path(self, index: int) -> str:
        mid = f"{self.writer_id}-" if self.writer_id else ""
        return os.path.join(
            self.dir, f"{_SEGMENT_PREFIX}{mid}{index:05d}{_SEGMENT_SUFFIX}"
        )

    @staticmethod
    def _read_segment(path: str) -> list[dict[str, Any]]:
        """Parse one segment, skipping torn/corrupt lines (the tail a
        crashed writer may leave is data loss of ONE record, never a
        poisoned ring)."""
        records: list[dict[str, Any]] = []
        try:
            with open(path, "r", encoding="utf-8", errors="replace") as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if isinstance(rec, dict) and "seq" in rec:
                        records.append(rec)
        except OSError:
            return []
        return records

    def _resume(self) -> None:
        """Find the live write position: the segment holding the highest
        seq, and how many records it already carries."""
        best_seq = -1
        active = 0
        active_count = 0
        for i in range(self.segments):
            recs = self._read_segment(self._segment_path(i))
            if not recs:
                continue
            top = max(int(r["seq"]) for r in recs)
            if top > best_seq:
                best_seq = top
                active = i
                active_count = len(recs)
        self._next_seq = best_seq + 1
        if active_count >= self.segment_records:
            # the active segment is already full: rotate immediately so
            # the first post-resume append does not overfill it
            self._active = (active + 1) % self.segments
            self._active_count = -1  # sentinel: truncate on next append
        else:
            self._active = active
            self._active_count = active_count

    def _open_active(self, truncate: bool) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
        mode = "w" if truncate else "a"
        self._fh = open(
            self._segment_path(self._active), mode, encoding="utf-8"
        )
        if truncate:
            self._active_count = 0

    # -------------------------------------------------------------- writing
    def append(self, record: dict[str, Any]) -> int:
        """Append one snapshot; returns its seq. ``t`` (unix seconds) is
        stamped when absent — readers window on it."""
        with self._lock:
            seq = self._next_seq
            self._next_seq += 1
            rec = dict(record)
            rec["seq"] = seq
            rec.setdefault("t", time.time())
            if self.writer_id:
                rec.setdefault("writer", self.writer_id)
            if self._fh is None:
                self._open_active(truncate=self._active_count < 0)
            elif self._active_count >= self.segment_records:
                self._active = (self._active + 1) % self.segments
                self._open_active(truncate=True)
            elif self._active_count < 0:
                self._open_active(truncate=True)
            line = json.dumps(rec, sort_keys=True)
            self._fh.write(line + "\n")
            self._fh.flush()
            self._active_count += 1
            return seq

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None

    @property
    def approx_count(self) -> int:
        """Cheap live-record estimate (no disk walk): seq count clamped
        to ring capacity — what the ``pio_telemetry_ring_records`` gauge
        reports per scrape."""
        capacity = self.segments * self.segment_records
        return min(self._next_seq, capacity)

    # -------------------------------------------------------------- reading
    def _all_segment_paths(self) -> dict[str, list[str]]:
        """Every writer's segment files in the directory, keyed by
        writer id ('' = the default single-writer namespace)."""
        try:
            names = os.listdir(self.dir)
        except OSError:
            return {}
        out: dict[str, list[str]] = {}
        for n in sorted(names):
            if not (
                n.startswith(_SEGMENT_PREFIX) and n.endswith(_SEGMENT_SUFFIX)
            ):
                continue
            stem = n[len(_SEGMENT_PREFIX):-len(_SEGMENT_SUFFIX)]
            writer, _sep, idx = stem.rpartition("-")
            if not idx.isdigit():
                continue
            out.setdefault(writer, []).append(os.path.join(self.dir, n))
        return out

    def records(self) -> list[dict[str, Any]]:
        """Every live record, oldest first. A single-writer directory
        reads in seq order exactly as before; a multi-writer one (the
        --gateways tier sharing an obs dir) merges every writer's
        segments ordered by record time (seqs are per-writer and tie
        within a writer)."""
        by_writer = self._all_segment_paths()
        recs_per: list[list[dict[str, Any]]] = []
        for paths in by_writer.values():
            recs: list[dict[str, Any]] = []
            for path in paths:
                recs.extend(self._read_segment(path))
            recs.sort(key=lambda r: int(r["seq"]))
            recs_per.append(recs)
        if not recs_per:
            return []
        if len(recs_per) == 1:
            return recs_per[0]
        out = [r for recs in recs_per for r in recs]
        out.sort(key=lambda r: (float(r.get("t", 0.0)), int(r["seq"])))
        return out

    def window(
        self, seconds: float, now: float | None = None
    ) -> list[dict[str, Any]]:
        """Records whose ``t`` falls inside the trailing window, oldest
        first — the ``GET /telemetry/window?s=N`` body."""
        now = time.time() if now is None else now
        cutoff = now - max(0.0, float(seconds))
        return [r for r in self.records() if float(r.get("t", 0.0)) >= cutoff]

    def tail(self, n: int) -> list[dict[str, Any]]:
        """Last ``n`` records, oldest first — what incident bundles embed."""
        recs = self.records()
        return recs[-max(0, int(n)):] if n else []

    def __len__(self) -> int:
        return len(self.records())


__all__ = ["TelemetryRing"]
