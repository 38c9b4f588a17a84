"""A local file store: apps, one JSON-lines event file per app, engine
instances and model blobs.

Layout under the root directory::

    apps.json                 {"<app name>": <app id>}
    events/<app id>.jsonl     one wire event per line (creationTime included)
    instances/<id>.json       engine-instance record of a train run
    models/<id>.bin           the run's model blob (PIOTPU02 framing)

The root is the ``root`` argument, else ``$PIO_TORCH_HOME``, else
``~/.pio_torch``. Writes to one file are serialised by a process-local lock;
the store is meant for one process at a time per root, as the CLI uses it.
"""

from __future__ import annotations

import json
import os
import threading
import uuid
from pathlib import Path
from typing import Any, Iterable, Iterator, Sequence

from predictionio_tpu_torch.data.columnar import ColumnarEvents, encode
from predictionio_tpu_torch.data.event import Event


class StoreError(RuntimeError):
    pass


def default_root() -> Path:
    return Path(os.environ.get("PIO_TORCH_HOME") or Path.home() / ".pio_torch")


class LocalStore:
    def __init__(self, root: str | os.PathLike | None = None):
        self.root = Path(root) if root is not None else default_root()
        self._lock = threading.Lock()

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
