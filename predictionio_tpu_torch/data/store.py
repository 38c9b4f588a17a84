"""A local file store: apps, one JSON-lines event file per app, engine
instances and model blobs.

Layout under the root directory::

    apps.json                 {"<app name>": <app id>}
    events/<app id>.jsonl     one wire event per line (creationTime included)
    instances/<id>.json       engine-instance record of a train run
    models/<id>.bin           the run's model blob (PIOTPU02 framing)

The root is the ``root`` argument, else ``$PIO_TORCH_HOME``, else
``~/.pio_torch``. Writes to one file are serialised by a process-local lock;
the store is meant for one writer process at a time per root, as the CLI
uses it. Serving-time reads by entity (``find_by_entity``) go through an
in-memory index of each app's file by (entity type, entity id), built on
first use and extended from the file's new tail before every lookup, so an
event appended by another process after deploy is seen by the next read.
"""

from __future__ import annotations

import datetime as _dt
import json
import os
import threading
import uuid
from pathlib import Path
from typing import Any, Iterable, Iterator, Sequence

from predictionio_tpu_torch.data.aggregator import aggregate_properties
from predictionio_tpu_torch.data.columnar import ColumnarEvents, encode
from predictionio_tpu_torch.data.datamap import PropertyMap
from predictionio_tpu_torch.data.event import UTC, Event, SPECIAL_EVENTS, event_seq_key


class StoreError(RuntimeError):
    pass


def default_root() -> Path:
    return Path(os.environ.get("PIO_TORCH_HOME") or Path.home() / ".pio_torch")


def _aware(t: _dt.datetime | None) -> _dt.datetime | None:
    """A time bound without a zone is read as UTC, as the JAX package does."""
    return t.replace(tzinfo=UTC) if t is not None and t.tzinfo is None else t


def _matches(
    e: Event,
    start_time: _dt.datetime | None,
    until_time: _dt.datetime | None,
    event_names: Sequence[str] | None,
    target_entity_type,
    target_entity_id,
) -> bool:
    """The find filters (start inclusive, until exclusive); the target
    filters are tri-state: ``...`` no filter, ``None`` absent, a string equal."""
    if start_time is not None and e.event_time < start_time:
        return False
    if until_time is not None and e.event_time >= until_time:
        return False
    if event_names is not None and e.event not in event_names:
        return False
    if target_entity_type is not ... and e.target_entity_type != target_entity_type:
        return False
    if target_entity_id is not ... and e.target_entity_id != target_entity_id:
        return False
    return True


class _EntityIndex:
    """Byte offsets of an app file's lines by (entity type, entity id), in
    file order, and how far into the file the index has read."""

    def __init__(self):
        self.lock = threading.Lock()
        self.read_to = 0
        self.offsets: dict[tuple[str, str], list[int]] = {}

    def catch_up(self, path: Path) -> None:
        """Index the complete lines appended since the last call."""
        size = path.stat().st_size if path.exists() else 0
        if size <= self.read_to:
            return
        with open(path, "rb") as fh:
            fh.seek(self.read_to)
            chunk = fh.read(size - self.read_to)
        end = chunk.rfind(b"\n") + 1  # a line still being written waits
        pos = self.read_to
        for line in chunk[:end].split(b"\n")[:-1]:
            if line.strip():
                d = json.loads(line)
                self.offsets.setdefault((d["entityType"], d["entityId"]), []).append(pos)
            pos += len(line) + 1
        self.read_to += end


class LocalStore:
    def __init__(self, root: str | os.PathLike | None = None):
        self.root = Path(root) if root is not None else default_root()
        self._lock = threading.Lock()
        self._indexes: dict[str, _EntityIndex] = {}

    # -- apps ---------------------------------------------------------------
    def _apps(self) -> dict[str, int]:
        path = self.root / "apps.json"
        return json.loads(path.read_text()) if path.exists() else {}

    def create_app(self, name: str) -> int:
        if not name:
            raise StoreError("app name must not be empty")
        with self._lock:
            apps = self._apps()
            if name in apps:
                raise StoreError(f"app {name!r} already exists")
            app_id = max(apps.values(), default=0) + 1
            apps[name] = app_id
            self.root.mkdir(parents=True, exist_ok=True)
            _write_atomic(self.root / "apps.json", json.dumps(apps, sort_keys=True))
            return app_id

    def app_id(self, name: str) -> int:
        app_id = self._apps().get(name)
        if app_id is None:
            raise StoreError(f"app {name!r} does not exist")
        return app_id

    def _events_path(self, app_name: str) -> Path:
        return self.root / "events" / f"{self.app_id(app_name)}.jsonl"

    # -- events -------------------------------------------------------------
    def append(self, app_name: str, events: Iterable[Event]) -> int:
        """Append events; those without an id get a fresh one."""
        path = self._events_path(app_name)
        path.parent.mkdir(parents=True, exist_ok=True)
        n = 0
        with self._lock, open(path, "a") as fh:
            for e in events:
                d = e.to_json_dict(with_creation_time=True)
                if d["eventId"] is None:
                    d["eventId"] = uuid.uuid4().hex
                fh.write(json.dumps(d, sort_keys=True) + "\n")
                n += 1
        return n

    def import_file(self, app_name: str, input_path: str) -> int:
        """``pio import``: a JSON-lines file of wire events into the app.
        The whole file is validated before anything is written; a bad line
        raises ``ValueError("file:line: cause")``."""
        events = []
        with open(input_path) as fh:
            for line_no, line in enumerate(fh, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(Event.from_json_dict(json.loads(line)))
                except (ValueError, TypeError) as exc:
                    raise ValueError(f"{input_path}:{line_no}: {exc}") from exc
        return self.append(app_name, events)

    def scan(self, app_name: str) -> Iterator[Event]:
        path = self._events_path(app_name)
        if not path.exists():
            return
        with open(path) as fh:
            for line in fh:
                if line.strip():
                    yield Event.from_json_dict(json.loads(line))

    def find_by_entity(
        self,
        app_name: str,
        entity_type: str,
        entity_id: str,
        event_names: Sequence[str] | None = None,
        target_entity_type=...,
        target_entity_id=...,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        limit: int | None = None,
        latest: bool = True,
    ) -> list[Event]:
        """One entity's events, newest first by event time (oldest first
        with ``latest=False``; equal times keep file order), filtered, at
        most ``limit`` (None or negative: no cap). Port of
        ``LEventStore.find_by_entity``; reads through the entity index, so
        one lookup costs the entity's events, not the file."""
        path = self._events_path(app_name)
        with self._lock:
            index = self._indexes.setdefault(str(path), _EntityIndex())
        start_time, until_time = _aware(start_time), _aware(until_time)
        with index.lock:
            index.catch_up(path)
            offsets = list(index.offsets.get((entity_type, entity_id), ()))
        events = []
        if offsets:
            with open(path, "rb") as fh:
                for off in offsets:
                    fh.seek(off)
                    d = json.loads(fh.readline())
                    if event_names is not None and d["event"] not in event_names:
                        continue  # decoding an Event costs more than the JSON
                    e = Event.from_json_dict(d)
                    if _matches(e, start_time, until_time, event_names,
                                target_entity_type, target_entity_id):
                        events.append(e)
        events.sort(key=lambda e: e.event_time, reverse=latest)
        if limit is not None and limit >= 0:
            events = events[:limit]
        return events

    def aggregate_properties(
        self,
        app_name: str,
        entity_type: str,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        required: Sequence[str] | None = None,
    ) -> dict[str, PropertyMap]:
        """Replay the $set/$unset/$delete events of ``entity_type`` in the
        window into one PropertyMap per entity (deleted entities dropped),
        keeping only entities that hold every ``required`` property. Port of
        ``PEventStore.aggregate_properties``."""
        start_time, until_time = _aware(start_time), _aware(until_time)
        events = [
            e for e in self.scan(app_name)
            if e.entity_type == entity_type
            and _matches(e, start_time, until_time, SPECIAL_EVENTS, ..., ...)
        ]
        events.sort(key=lambda e: e.event_time)
        result = aggregate_properties(events)
        if required:
            req = set(required)
            result = {k: v for k, v in result.items() if req.issubset(v.keyset())}
        return result

    def iter_ordered(
        self, app_name: str, page: int = 2048, max_events: int = 500_000
    ) -> Iterator[Event]:
        """At most ``max_events`` events of the app in ``event_seq_key``
        order, up to the head taken at entry: events appended after this
        call returns are not read. ``page`` is the page size of the JAX
        package's paged reads; this store reads its snapshot whole, so it
        is only checked."""
        if page < 1 or max_events < 0:
            raise ValueError(f"page must be >= 1 and max_events >= 0, got {page}, {max_events}")
        events = sorted(self.scan(app_name), key=event_seq_key)  # the head, read now
        return iter(events[:max_events])

    def to_columnar(
        self,
        app_name: str,
        event_names: Sequence[str] | None = None,
        entity_type: str | None = None,
        target_entity_type: str | None = None,
        rating_key: str = "rating",
    ) -> ColumnarEvents:
        return encode(
            self.scan(app_name), event_names, entity_type, target_entity_type, rating_key
        )

    # -- engine instances and models ----------------------------------------
    def new_instance(self, record: dict[str, Any]) -> str:
        instance_id = uuid.uuid4().hex
        self.update_instance(instance_id, record)
        return instance_id

    def update_instance(self, instance_id: str, record: dict[str, Any]) -> None:
        path = self.root / "instances" / f"{instance_id}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        _write_atomic(path, json.dumps({**record, "id": instance_id}, sort_keys=True))

    def instances(self) -> list[dict[str, Any]]:
        d = self.root / "instances"
        if not d.exists():
            return []
        return [json.loads(p.read_text()) for p in sorted(d.glob("*.json"))]

    def latest_completed(self, engine_id: str) -> dict[str, Any] | None:
        done = [
            r for r in self.instances()
            if r.get("engine_id") == engine_id and r.get("status") == "COMPLETED"
        ]
        return max(done, key=lambda r: r["end_time"], default=None)

    def put_model(self, instance_id: str, blob: bytes) -> None:
        path = self.root / "models" / f"{instance_id}.bin"
        path.parent.mkdir(parents=True, exist_ok=True)
        _write_atomic(path, blob)

    def get_model(self, instance_id: str) -> bytes:
        path = self.root / "models" / f"{instance_id}.bin"
        if not path.exists():
            raise StoreError(f"no model stored for engine instance {instance_id}")
        return path.read_bytes()


def _write_atomic(path: Path, data: str | bytes) -> None:
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    tmp.write_bytes(data.encode() if isinstance(data, str) else data)
    os.replace(tmp, path)
