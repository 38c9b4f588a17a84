"""Append-only JSONL file event store.

The training-feed-friendly file backend: one ``events_<app>[_<channel>].jsonl``
per app/channel. Plays the role of the reference's HDFS-resident event data
for bulk training scans (ref ``storage/hbase/.../HBPEvents.scala`` via
``TableInputFormat``): training jobs stream the file once, dictionary-encode
to columnar arrays (``PEvents.to_columnar``) and never touch a SQL store.
Row wire format = the event JSON contract plus ``creationTime`` and ``tags``.

The port's own copy of ``predictionio_tpu/data/storage/jsonl.py``.
``to_columnar`` scans the file with the host library
(``utils/native.scan_jsonl_columnar``) where its filters allow, as the JAX
package does, else with the shared python encoder of ``base.PEvents``. Both
stop at a last line another writer is still appending. Every read scans the
whole file: serving-time reads by entity belong on sqlite.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import json
import os
import threading
import uuid
from typing import Iterable, Iterator, Sequence

from predictionio_tpu_torch.data.event import Event, parse_event_time
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.memory import event_matches
from predictionio_tpu_torch.data.storage.registry import default_basedir
from predictionio_tpu_torch.utils import native


def _event_to_row(e: Event) -> dict:
    d = e.to_json_dict(with_creation_time=True)
    if e.tags:
        d["tags"] = list(e.tags)
    return d


def _row_to_event(d: dict) -> Event:
    return Event(
        event=d["event"],
        entity_type=d["entityType"],
        entity_id=d["entityId"],
        target_entity_type=d.get("targetEntityType"),
        target_entity_id=d.get("targetEntityId"),
        properties=dict(d.get("properties") or {}),
        event_time=parse_event_time(d["eventTime"]),
        event_id=d.get("eventId"),
        tags=tuple(d.get("tags") or ()),
        pr_id=d.get("prId"),
        creation_time=parse_event_time(d["creationTime"])
        if d.get("creationTime")
        else parse_event_time(d["eventTime"]),
    )


class JSONLEventFiles:
    def __init__(self, basedir: str):
        self.basedir = basedir
        os.makedirs(basedir, exist_ok=True)
        self._lock = threading.RLock()

    def path(self, app_id: int, channel_id: int | None) -> str:
        name = (
            f"events_{app_id}.jsonl"
            if channel_id is None
            else f"events_{app_id}_{channel_id}.jsonl"
        )
        return os.path.join(self.basedir, name)

    def append(self, events: Sequence[Event], app_id: int, channel_id: int | None) -> None:
        with self._lock, open(self.path(app_id, channel_id), "a") as f:
            for e in events:
                f.write(json.dumps(_event_to_row(e), sort_keys=True) + "\n")

    def scan(self, app_id: int, channel_id: int | None) -> Iterator[Event]:
        """Later rows win on duplicate event ids, giving append-only upsert
        semantics consistent with the memory/sqlite backends. A last line
        without its newline is a row still being appended (by another
        process) and is not read yet."""
        path = self.path(app_id, channel_id)
        if not os.path.exists(path):
            return iter(())
        by_id: dict[str, Event] = {}
        with open(path) as f:
            for line in f:
                if not line.endswith("\n"):
                    break  # a line another writer is still appending waits
                line = line.strip()
                if line:
                    e = _row_to_event(json.loads(line))
                    by_id[e.event_id or ""] = e
        return iter(by_id.values())

    def rewrite(
        self, events: Iterable[Event], app_id: int, channel_id: int | None
    ) -> None:
        path = self.path(app_id, channel_id)
        tmp = path + ".tmp"
        with self._lock:
            with open(tmp, "w") as f:
                for e in events:
                    f.write(json.dumps(_event_to_row(e), sort_keys=True) + "\n")
            os.replace(tmp, path)

    def remove_ids(
        self, drop: set[str], app_id: int, channel_id: int | None
    ) -> int:
        """Atomically scan + rewrite without the dropped ids, holding the
        lock throughout so concurrent appends are never lost."""
        with self._lock:
            kept, found = [], 0
            for e in self.scan(app_id, channel_id):
                if e.event_id in drop:
                    found += 1
                else:
                    kept.append(e)
            if found:
                path = self.path(app_id, channel_id)
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    for e in kept:
                        f.write(json.dumps(_event_to_row(e), sort_keys=True) + "\n")
                os.replace(tmp, path)
            return found

    def drop(self, app_id: int, channel_id: int | None) -> None:
        with self._lock:
            try:
                os.remove(self.path(app_id, channel_id))
            except FileNotFoundError:
                pass


class JSONLLEvents(base.LEvents):
    """Row API over the JSONL files. get/delete are O(file) — this backend
    is meant for bulk training feeds; use sqlite for servers that need row
    lookups."""

    def __init__(self, files: JSONLEventFiles):
        self._files = files

    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        open(self._files.path(app_id, channel_id), "a").close()
        return True

    def remove(self, app_id: int, channel_id: int | None = None) -> bool:
        self._files.drop(app_id, channel_id)
        return True

    def close(self) -> None:
        pass

    def insert(self, event: Event, app_id: int, channel_id: int | None = None) -> str:
        return self.insert_batch([event], app_id, channel_id)[0]

    def insert_batch(
        self, events: Sequence[Event], app_id: int, channel_id: int | None = None
    ) -> list[str]:
        stamped = [
            e if e.event_id else dataclasses.replace(e, event_id=uuid.uuid4().hex)
            for e in events
        ]
        self._files.append(stamped, app_id, channel_id)
        return [e.event_id for e in stamped]  # type: ignore[misc]

    def get(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> Event | None:
        for e in self._files.scan(app_id, channel_id):
            if e.event_id == event_id:
                return e
        return None

    def delete(self, event_id: str, app_id: int, channel_id: int | None = None) -> bool:
        return self._files.remove_ids({event_id}, app_id, channel_id) > 0

    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        entity_type: str | None = None,
        entity_id: str | None = None,
        event_names: Sequence[str] | None = None,
        target_entity_type=...,
        target_entity_id=...,
        limit: int | None = None,
        reversed: bool = False,
    ) -> Iterator[Event]:
        events = [
            e
            for e in self._files.scan(app_id, channel_id)
            if event_matches(
                e,
                start_time,
                until_time,
                entity_type,
                entity_id,
                event_names,
                target_entity_type,
                target_entity_id,
            )
        ]
        events.sort(key=lambda e: e.event_time, reverse=reversed)
        if limit is not None and limit >= 0:
            events = events[:limit]
        return iter(events)

    def find_after(
        self,
        app_id: int,
        channel_id: int | None = None,
        cursor: tuple[int, str] | None = None,
        limit: int = 100,
    ) -> list[Event]:
        """Scan-based tail read; the dedup-by-id scan keeps upsert
        semantics (a re-appended event tails at its NEW creation time)."""
        return base.scan_find_after(
            self._files.scan(app_id, channel_id), cursor, limit
        )


class JSONLPEvents(base.PEvents):
    def __init__(self, files: JSONLEventFiles):
        self._files = files
        self._l = JSONLLEvents(files)

    def find(self, app_id: int, channel_id: int | None = None, **kw) -> Iterator[Event]:
        return self._l.find(app_id, channel_id, **kw)

    def write(
        self, events: Iterable[Event], app_id: int, channel_id: int | None = None
    ) -> None:
        self._l.insert_batch(list(events), app_id, channel_id)

    def delete(
        self, event_ids: Iterable[str], app_id: int, channel_id: int | None = None
    ) -> None:
        self._files.remove_ids(set(event_ids), app_id, channel_id)

    def version_stamp(self, app_id: int, channel_id: int | None = None) -> str | None:
        path = self._files.path(app_id, channel_id)
        try:
            st = os.stat(path)
        except FileNotFoundError:
            return "empty"
        return f"{st.st_size}:{st.st_mtime_ns}"

    def store_identity(self) -> str | None:
        # abs path of this app/store root: two jsonl stores sharing one
        # snapshot root must not alias or GC each other's snapshots
        return os.path.abspath(self._files.basedir)

    def to_columnar(
        self,
        app_id: int,
        channel_id: int | None = None,
        event_names: Sequence[str] | None = None,
        rating_key: str = "rating",
        entity_vocab: Sequence[str] | None = None,
        target_vocab: Sequence[str] | None = None,
        events: Iterable[Event] | None = None,
        **find_kwargs,
    ) -> base.ColumnarEvents:
        """The host library's scan of the file when its filters can say what
        is asked (event names, entity and target types; no time window, no
        frozen vocabulary, no events passed in), else the python encoder."""
        if event_names is not None:
            event_names = list(event_names)
        # ``...`` is the find() "don't care" sentinel: the same as no filter
        native_kwargs = {k: v for k, v in find_kwargs.items() if v is not ...}
        path = self._files.path(app_id, channel_id)
        native_ok = (
            events is None
            and entity_vocab is None
            and target_vocab is None
            and set(native_kwargs) <= {"entity_type", "target_entity_type"}
            # an explicit None filter means "must be absent", which the scan
            # does not express; event_names=[] means "match nothing"
            and native_kwargs.get("entity_type", "") is not None
            and native_kwargs.get("target_entity_type", "") is not None
            and event_names != []
            and os.path.exists(path)  # no file: no events, the encoder's empty block
        )
        if not native_ok:
            return super().to_columnar(
                app_id, channel_id, event_names=event_names, rating_key=rating_key,
                entity_vocab=entity_vocab, target_vocab=target_vocab, events=events,
                **find_kwargs,
            )
        raw = native.scan_jsonl_columnar(
            path,
            event_names=event_names or None,
            rating_key=rating_key,
            entity_type=native_kwargs.get("entity_type"),
            target_entity_type=native_kwargs.get("target_entity_type"),
        )
        return base.ColumnarEvents(
            event_ids=raw["event_ids"],
            event_names=[raw["event_vocab"][c] for c in raw["event_codes"]],
            entity_ids=raw["entity_ids"],
            target_ids=raw["target_ids"],
            event_codes=raw["event_codes"],
            timestamps=raw["timestamps"],
            ratings=raw["ratings"],
            entity_vocab=raw["entity_vocab"],
            target_vocab=raw["target_vocab"],
            event_vocab=raw["event_vocab"],
        )


class JSONLStorageClient:
    """Backend entry point (type name: ``jsonl``). Config key ``PATH``
    selects the directory. Event data only."""

    def __init__(self, config: dict | None = None):
        self.config = config or {}
        path = self.config.get("PATH") or self.config.get("path")
        if not path:
            path = os.path.join(default_basedir(), "events")
        self._files = JSONLEventFiles(path)

    def l_events(self) -> JSONLLEvents:
        return JSONLLEvents(self._files)

    def p_events(self) -> JSONLPEvents:
        return JSONLPEvents(self._files)
