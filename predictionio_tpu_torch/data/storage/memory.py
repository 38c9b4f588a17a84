"""In-memory storage backend — the unit-test default (the port's own copy
of ``predictionio_tpu/data/storage/memory.py``).

Plays the role the reference's H2-in-MySQL-mode test database plays in
``data/src/test/scala/.../storage/StorageMockContext.scala:22-62``: a fully
functional implementation of every DAO with zero external dependencies.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import threading
import uuid
from typing import Iterable, Iterator, Sequence

from predictionio_tpu_torch.data.event import Event, ensure_aware
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EvaluationInstance,
    Model,
)


def event_matches(
    e: Event,
    start_time: _dt.datetime | None = None,
    until_time: _dt.datetime | None = None,
    entity_type: str | None = None,
    entity_id: str | None = None,
    event_names: Sequence[str] | None = None,
    target_entity_type=...,
    target_entity_id=...,
) -> bool:
    """The shared filter predicate for the 9 find dimensions
    (ref LEvents.scala:188-200). start inclusive, until exclusive."""
    start_time = ensure_aware(start_time)
    until_time = ensure_aware(until_time)
    if start_time is not None and e.event_time < start_time:
        return False
    if until_time is not None and e.event_time >= until_time:
        return False
    if entity_type is not None and e.entity_type != entity_type:
        return False
    if entity_id is not None and e.entity_id != entity_id:
        return False
    if event_names is not None and e.event not in event_names:
        return False
    if target_entity_type is not ... and e.target_entity_type != target_entity_type:
        return False
    if target_entity_id is not ... and e.target_entity_id != target_entity_id:
        return False
    return True


class MemoryEventStore:
    """Shared per-(app, channel) event table used by both L and P DAOs."""

    def __init__(self):
        self._lock = threading.RLock()
        self._tables: dict[tuple[int, int | None], dict[str, Event]] = {}
        self._versions: dict[tuple[int, int | None], int] = {}
        # snapshot-cache stamps must never collide with a *different*
        # in-memory store (another process, or another instance in this one)
        # whose counter happens to match — see version_stamp
        self.nonce = uuid.uuid4().hex[:12]

    def table(self, app_id: int, channel_id: int | None) -> dict[str, Event]:
        with self._lock:
            return self._tables.setdefault((app_id, channel_id), {})

    def bump(self, app_id: int, channel_id: int | None) -> None:
        with self._lock:
            key = (app_id, channel_id)
            self._versions[key] = self._versions.get(key, 0) + 1

    def version(self, app_id: int, channel_id: int | None) -> int:
        with self._lock:
            return self._versions.get((app_id, channel_id), 0)

    def drop(self, app_id: int, channel_id: int | None) -> None:
        with self._lock:
            self._tables.pop((app_id, channel_id), None)
            self.bump(app_id, channel_id)


class MemoryLEvents(base.LEvents):
    def __init__(self, store: MemoryEventStore | None = None):
        self._store = store or MemoryEventStore()

    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        self._store.table(app_id, channel_id)
        return True

    def remove(self, app_id: int, channel_id: int | None = None) -> bool:
        self._store.drop(app_id, channel_id)
        return True

    def close(self) -> None:
        pass

    def insert(self, event: Event, app_id: int, channel_id: int | None = None) -> str:
        event_id = event.event_id or uuid.uuid4().hex
        stored = (
            event
            if event.event_id == event_id
            else dataclasses.replace(event, event_id=event_id)
        )
        with self._store._lock:
            self._store.table(app_id, channel_id)[event_id] = stored
            self._store.bump(app_id, channel_id)
        return event_id

    def get(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> Event | None:
        return self._store.table(app_id, channel_id).get(event_id)

    def delete(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> bool:
        with self._store._lock:
            removed = self._store.table(app_id, channel_id).pop(event_id, None)
            if removed is not None:
                self._store.bump(app_id, channel_id)
            return removed is not None

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
        with self._store._lock:
            events = list(self._store.table(app_id, channel_id).values())
        events = [
            e
            for e in events
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
    ) -> list[base.Event]:
        with self._store._lock:
            events = list(self._store.table(app_id, channel_id).values())
        return base.scan_find_after(events, cursor, limit)


class MemoryPEvents(base.PEvents):
    def __init__(self, store: MemoryEventStore, levents: MemoryLEvents | None = None):
        self._store = store
        self._l = levents or MemoryLEvents(store)

    def find(self, app_id: int, channel_id: int | None = None, **kw) -> Iterator[Event]:
        return self._l.find(app_id, channel_id, **kw)

    def write(
        self, events: Iterable[Event], app_id: int, channel_id: int | None = None
    ) -> None:
        for e in events:
            self._l.insert(e, app_id, channel_id)

    def delete(
        self, event_ids: Iterable[str], app_id: int, channel_id: int | None = None
    ) -> None:
        for eid in event_ids:
            self._l.delete(eid, app_id, channel_id)

    def version_stamp(self, app_id: int, channel_id: int | None = None) -> str | None:
        return f"mem:{self._store.version(app_id, channel_id)}"

    def store_identity(self) -> str | None:
        return f"mem:{self._store.nonce}"


class MemoryApps(base.Apps):
    def __init__(self):
        self._apps: dict[int, App] = {}
        self._next = 1
        self._lock = threading.RLock()

    def insert(self, app: App) -> int | None:
        with self._lock:
            app_id = app.id
            if app_id == 0:
                app_id = self._next
            if app_id in self._apps or any(
                a.name == app.name for a in self._apps.values()
            ):
                return None
            self._next = max(self._next, app_id) + 1
            self._apps[app_id] = App(app_id, app.name, app.description)
            return app_id

    def get(self, app_id: int) -> App | None:
        return self._apps.get(app_id)

    def get_by_name(self, name: str) -> App | None:
        return next((a for a in self._apps.values() if a.name == name), None)

    def get_all(self) -> list[App]:
        return sorted(self._apps.values(), key=lambda a: a.id)

    def update(self, app: App) -> None:
        with self._lock:
            if any(
                a.name == app.name and a.id != app.id
                for a in self._apps.values()
            ):
                raise ValueError(f"app name already in use: {app.name!r}")
            self._apps[app.id] = app

    def delete(self, app_id: int) -> None:
        with self._lock:
            self._apps.pop(app_id, None)


class MemoryAccessKeys(base.AccessKeys):
    def __init__(self):
        self._keys: dict[str, AccessKey] = {}
        self._lock = threading.RLock()

    def insert(self, k: AccessKey) -> str | None:
        with self._lock:
            key = k.key or base.generate_access_key()
            if key in self._keys:
                return None
            self._keys[key] = AccessKey(key, k.appid, tuple(k.events))
            return key

    def get(self, key: str) -> AccessKey | None:
        return self._keys.get(key)

    def get_all(self) -> list[AccessKey]:
        return list(self._keys.values())

    def get_by_app_id(self, app_id: int) -> list[AccessKey]:
        return [k for k in self._keys.values() if k.appid == app_id]

    def update(self, k: AccessKey) -> None:
        with self._lock:
            self._keys[k.key] = k

    def delete(self, key: str) -> None:
        with self._lock:
            self._keys.pop(key, None)


class MemoryChannels(base.Channels):
    def __init__(self):
        self._channels: dict[int, Channel] = {}
        self._next = 1
        self._lock = threading.RLock()

    def insert(self, channel: Channel) -> int | None:
        if not Channel.is_valid_name(channel.name):
            return None
        with self._lock:
            channel_id = channel.id or self._next
            if channel_id in self._channels:
                return None
            self._next = max(self._next, channel_id) + 1
            self._channels[channel_id] = Channel(channel_id, channel.name, channel.appid)
            return channel_id

    def get(self, channel_id: int) -> Channel | None:
        return self._channels.get(channel_id)

    def get_by_app_id(self, app_id: int) -> list[Channel]:
        return [c for c in self._channels.values() if c.appid == app_id]

    def delete(self, channel_id: int) -> None:
        with self._lock:
            self._channels.pop(channel_id, None)


class MemoryEngineInstances(base.EngineInstances):
    def __init__(self):
        self._instances: dict[str, EngineInstance] = {}
        self._lock = threading.RLock()

    def insert(self, instance: EngineInstance) -> str:
        with self._lock:
            iid = instance.id or uuid.uuid4().hex
            instance.id = iid
            self._instances[iid] = instance
            return iid

    def get(self, instance_id: str) -> EngineInstance | None:
        return self._instances.get(instance_id)

    def get_all(self) -> list[EngineInstance]:
        return list(self._instances.values())

    def get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> list[EngineInstance]:
        out = [
            i
            for i in self._instances.values()
            if i.status == base.EngineInstanceStatus.COMPLETED
            and i.engine_id == engine_id
            and i.engine_version == engine_version
            and i.engine_variant == engine_variant
        ]
        return sorted(out, key=lambda i: i.start_time, reverse=True)

    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> EngineInstance | None:
        completed = self.get_completed(engine_id, engine_version, engine_variant)
        return completed[0] if completed else None

    def update(self, instance: EngineInstance) -> None:
        with self._lock:
            self._instances[instance.id] = instance

    def delete(self, instance_id: str) -> None:
        with self._lock:
            self._instances.pop(instance_id, None)


class MemoryEvaluationInstances(base.EvaluationInstances):
    def __init__(self):
        self._instances: dict[str, EvaluationInstance] = {}
        self._lock = threading.RLock()

    def insert(self, instance: EvaluationInstance) -> str:
        with self._lock:
            iid = instance.id or uuid.uuid4().hex
            instance.id = iid
            self._instances[iid] = instance
            return iid

    def get(self, instance_id: str) -> EvaluationInstance | None:
        return self._instances.get(instance_id)

    def get_all(self) -> list[EvaluationInstance]:
        return list(self._instances.values())

    def get_completed(self) -> list[EvaluationInstance]:
        out = [
            i
            for i in self._instances.values()
            if i.status == base.EvaluationInstanceStatus.EVALCOMPLETED
        ]
        return sorted(out, key=lambda i: i.start_time, reverse=True)

    def update(self, instance: EvaluationInstance) -> None:
        with self._lock:
            self._instances[instance.id] = instance

    def delete(self, instance_id: str) -> None:
        with self._lock:
            self._instances.pop(instance_id, None)


class MemoryModels(base.Models):
    def __init__(self):
        self._models: dict[str, Model] = {}
        self._lock = threading.RLock()

    def insert(self, model: Model) -> None:
        with self._lock:
            self._models[model.id] = model

    def get(self, model_id: str) -> Model | None:
        return self._models.get(model_id)

    def delete(self, model_id: str) -> None:
        with self._lock:
            self._models.pop(model_id, None)


class MemoryStorageClient:
    """Backend entry point discovered by the registry (type name: ``memory``).

    One client instance = one isolated universe of DAOs (like one H2 database
    in the reference's tests)."""

    def __init__(self, config: dict | None = None):
        self.config = config or {}
        self._event_store = MemoryEventStore()
        self._levents = MemoryLEvents(self._event_store)
        self._pevents = MemoryPEvents(self._event_store, self._levents)
        self._apps = MemoryApps()
        self._access_keys = MemoryAccessKeys()
        self._channels = MemoryChannels()
        self._engine_instances = MemoryEngineInstances()
        self._evaluation_instances = MemoryEvaluationInstances()
        self._models = MemoryModels()

    # DAO accessors used by registry reflection
    def l_events(self) -> MemoryLEvents:
        return self._levents

    def p_events(self) -> MemoryPEvents:
        return self._pevents

    def apps(self) -> MemoryApps:
        return self._apps

    def access_keys(self) -> MemoryAccessKeys:
        return self._access_keys

    def channels(self) -> MemoryChannels:
        return self._channels

    def engine_instances(self) -> MemoryEngineInstances:
        return self._engine_instances

    def evaluation_instances(self) -> MemoryEvaluationInstances:
        return self._evaluation_instances

    def models(self) -> MemoryModels:
        return self._models
