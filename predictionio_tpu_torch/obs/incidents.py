"""Incident flight recorder: snapshot the evidence before it evaporates
(the port's own copy of ``predictionio_tpu/obs/incidents.py``).

When a worker crashes, a breaker trips, or a fleet SLO starts burning,
the evidence an operator needs — the spans of the affected requests, the
telemetry history leading up to it, the rollout state, the dead
process's stderr — lives in process memory and dies with the process.
This module captures it at trigger time into an **incident bundle**: a
content-addressed directory of JSON parts plus raw text tails, published
atomically (written to a temp dir, ``os.rename``'d into place) so a
half-captured bundle can never be mistaken for a whole one.

Bundle layout (``<dir>/<utc-stamp>-<sha12>/``):

- ``manifest.json`` — trigger kind, wall/monotonic capture times, the
  caller's context dict, the list of captured parts, and the bundle's
  content hash (sha256 over every part, so ``pio incidents show``
  verifies what it prints).
- ``<source>.json`` — one file per registered source callable (merged
  recent traces, telemetry-ring tail, registry/rollout state, supervisor
  restart ladder, ...). A failing source records ``{"error": ...}``
  instead of sinking the capture.
- ``<name>.txt`` — raw text parts (the dead worker's stderr tail).

Triggers are rate-limited per kind (``min_interval_s``) — a crash-loop
must produce a few bundles, not thousands — and the directory is GC'd to
the newest ``max_bundles``. Stdlib-only; the async tiers hand the
recorder *sync* source callables (cached fan-in state), so a trigger
never blocks on the network mid-incident.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import shutil
import threading
import time
from typing import Any, Callable

logger = logging.getLogger(__name__)

MANIFEST_NAME = "manifest.json"


@dataclasses.dataclass(frozen=True)
class BundleRef:
    """One on-disk bundle, as ``pio incidents list`` sees it."""

    bundle_id: str
    path: str
    trigger: str
    captured_at: float

    def to_json_dict(self) -> dict[str, Any]:
        return {
            "id": self.bundle_id,
            "path": self.path,
            "trigger": self.trigger,
            "capturedAt": self.captured_at,
        }


class IncidentRecorder:
    """Named sources + rate-limited triggers -> content-addressed bundles.

    Construct once per fleet parent, ``add_source(name, fn)`` for every
    evidence stream (each ``fn`` is a cheap sync callable returning a
    JSON-serializable value), then call :meth:`trigger` from the failure
    paths. The clock is injectable so rate-limiting unit-tests without
    sleeping.
    """

    def __init__(
        self,
        dir_path: str,
        metrics: Any | None = None,
        min_interval_s: float = 30.0,
        max_bundles: int = 50,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.dir = dir_path
        self.min_interval_s = float(min_interval_s)
        self.max_bundles = int(max_bundles)
        self._clock = clock
        self._lock = threading.Lock()
        self._sources: dict[str, Callable[[], Any]] = {}
        self._last_trigger: dict[str, float] = {}
        os.makedirs(self.dir, exist_ok=True)
        if metrics is not None:
            self._m_bundles = metrics.counter(
                "pio_incident_bundles_total",
                "incident bundles captured, by trigger kind",
                labelnames=("trigger",),
            )
            self._m_suppressed = metrics.counter(
                "pio_incident_suppressed_total",
                "incident triggers suppressed by per-kind rate limiting",
            )
            self._m_errors = metrics.counter(
                "pio_incident_capture_errors_total",
                "evidence sources that failed during a bundle capture",
            )
        else:
            self._m_bundles = self._m_suppressed = self._m_errors = None

    def add_source(self, name: str, fn: Callable[[], Any]) -> None:
        """Register an evidence stream; captured into ``<name>.json`` on
        every trigger. Re-registering a name replaces it."""
        with self._lock:
            self._sources[name] = fn

    # ------------------------------------------------------------- capture
    def trigger(
        self,
        kind: str,
        context: dict[str, Any] | None = None,
        texts: dict[str, str] | None = None,
    ) -> str | None:
        """Capture a bundle for one incident. Returns the bundle path, or
        ``None`` when rate-limited. ``context`` rides in the manifest
        (who/what/where at trigger time); ``texts`` become raw ``.txt``
        parts (stderr tails). Never raises — a broken recorder must not
        take down the failure path that called it."""
        now = self._clock()
        with self._lock:
            last = self._last_trigger.get(kind)
            if last is not None and now - last < self.min_interval_s:
                if self._m_suppressed is not None:
                    self._m_suppressed.inc()
                return None
            self._last_trigger[kind] = now
            sources = dict(self._sources)
        try:
            return self._capture(kind, context or {}, texts or {}, sources)
        except Exception:
            logger.exception("incident capture failed for trigger %r", kind)
            if self._m_errors is not None:
                self._m_errors.inc()
            return None

    def _capture(
        self,
        kind: str,
        context: dict[str, Any],
        texts: dict[str, str],
        sources: dict[str, Callable[[], Any]],
    ) -> str:
        captured_at = time.time()
        parts: dict[str, Any] = {}
        for name, fn in sorted(sources.items()):
            try:
                parts[name] = _jsonable(fn())
            except Exception as exc:
                parts[name] = {"error": f"{type(exc).__name__}: {exc}"}
                if self._m_errors is not None:
                    self._m_errors.inc()
        manifest = {
            "trigger": kind,
            "capturedAt": captured_at,
            "capturedAtMonotonic": self._clock(),
            "context": _jsonable(context),
            "parts": sorted(parts),
            "texts": sorted(texts),
        }
        # content address: sha256 over the canonical serialization of
        # everything captured — identical evidence dedupes to one id and
        # `pio incidents show` can verify the bundle it prints
        hasher = hashlib.sha256()
        hasher.update(json.dumps(manifest, sort_keys=True).encode())
        for name in sorted(parts):
            hasher.update(json.dumps(parts[name], sort_keys=True).encode())
        for name in sorted(texts):
            hasher.update(texts[name].encode("utf-8", errors="replace"))
        digest = hasher.hexdigest()
        manifest["sha256"] = digest
        stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime(captured_at))
        bundle_id = f"{stamp}-{digest[:12]}"
        final = os.path.join(self.dir, bundle_id)
        tmp = os.path.join(self.dir, f".tmp-{bundle_id}-{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)
        try:
            for name, value in parts.items():
                with open(
                    os.path.join(tmp, f"{name}.json"), "w", encoding="utf-8"
                ) as fh:
                    json.dump(value, fh, indent=2, sort_keys=True)
            for name, text in texts.items():
                with open(
                    os.path.join(tmp, f"{name}.txt"),
                    "w",
                    encoding="utf-8",
                    errors="replace",
                ) as fh:
                    fh.write(text)
            with open(
                os.path.join(tmp, MANIFEST_NAME), "w", encoding="utf-8"
            ) as fh:
                json.dump(manifest, fh, indent=2, sort_keys=True)
            if os.path.isdir(final):
                shutil.rmtree(tmp)  # identical evidence already captured
            else:
                os.rename(tmp, final)
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if self._m_bundles is not None:
            self._m_bundles.inc(trigger=kind)
        self._gc()
        logger.warning("incident bundle captured: %s (%s)", bundle_id, kind)
        return final

    def _gc(self) -> None:
        refs = list_bundles(self.dir)
        for ref in refs[: max(0, len(refs) - self.max_bundles)]:
            shutil.rmtree(ref.path, ignore_errors=True)


def _jsonable(value: Any) -> Any:
    """Best-effort JSON coercion: evidence capture must never die on a
    numpy scalar or dataclass riding in a snapshot."""
    try:
        json.dumps(value)
        return value
    except (TypeError, ValueError):
        return json.loads(json.dumps(value, default=repr))


# --------------------------------------------------------------- inspection
def list_bundles(dir_path: str) -> list[BundleRef]:
    """Bundles oldest first (the `pio incidents list` order; GC drops
    from the front). Unreadable entries are skipped, not fatal."""
    refs: list[BundleRef] = []
    try:
        names = os.listdir(dir_path)
    except OSError:
        return []
    for name in names:
        if name.startswith("."):
            continue
        path = os.path.join(dir_path, name)
        manifest_path = os.path.join(path, MANIFEST_NAME)
        if not os.path.isfile(manifest_path):
            continue
        try:
            with open(manifest_path, encoding="utf-8") as fh:
                manifest = json.load(fh)
        except (OSError, json.JSONDecodeError):
            continue
        refs.append(
            BundleRef(
                bundle_id=name,
                path=path,
                trigger=str(manifest.get("trigger", "?")),
                captured_at=float(manifest.get("capturedAt", 0.0)),
            )
        )
    refs.sort(key=lambda r: (r.captured_at, r.bundle_id))
    return refs


def load_bundle(dir_path: str, bundle_id: str) -> dict[str, Any]:
    """The whole bundle as one dict: manifest + every part + every text.
    ``bundle_id`` may be a unique prefix (like git short hashes)."""
    path = resolve_bundle(dir_path, bundle_id)
    with open(os.path.join(path, MANIFEST_NAME), encoding="utf-8") as fh:
        manifest = json.load(fh)
    out: dict[str, Any] = {"manifest": manifest, "parts": {}, "texts": {}}
    for name in manifest.get("parts", []):
        try:
            with open(
                os.path.join(path, f"{name}.json"), encoding="utf-8"
            ) as fh:
                out["parts"][name] = json.load(fh)
        except (OSError, json.JSONDecodeError) as exc:
            out["parts"][name] = {"error": f"unreadable: {exc}"}
    for name in manifest.get("texts", []):
        try:
            with open(
                os.path.join(path, f"{name}.txt"),
                encoding="utf-8",
                errors="replace",
            ) as fh:
                out["texts"][name] = fh.read()
        except OSError as exc:
            out["texts"][name] = f"unreadable: {exc}"
    return out


def export_bundle(dir_path: str, bundle_id: str, dest: str) -> str:
    """Copy one bundle directory to ``dest`` (for attaching to a ticket);
    returns the created path."""
    src = resolve_bundle(dir_path, bundle_id)
    target = os.path.join(dest, os.path.basename(src))
    shutil.copytree(src, target)
    return target


def resolve_bundle(dir_path: str, bundle_id: str) -> str:
    """The directory of the one bundle whose id starts with
    ``bundle_id``; raises when none or several match."""
    matches = [
        r for r in list_bundles(dir_path) if r.bundle_id.startswith(bundle_id)
    ]
    if not matches:
        raise FileNotFoundError(f"no incident bundle matching {bundle_id!r}")
    if len(matches) > 1:
        ids = ", ".join(r.bundle_id for r in matches)
        raise ValueError(f"ambiguous bundle id {bundle_id!r}: {ids}")
    return matches[0].path


__all__ = [
    "BundleRef",
    "IncidentRecorder",
    "export_bundle",
    "list_bundles",
    "load_bundle",
    "resolve_bundle",
]
