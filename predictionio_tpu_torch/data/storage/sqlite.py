"""SQLite storage backend — the single-host development default.

Plays the role of the reference's JDBC driver
(``storage/jdbc/.../JDBCLEvents.scala`` / ``JDBCPEvents.scala`` /
``JDBCApps.scala`` etc., 2,051 LoC of scalikejdbc): a full implementation of
every DAO on one embedded SQL database. The event-column layout mirrors the
reference's JDBC DDL (``JDBCLEvents.scala:54-68``) — id, event, entityType,
entityId, targetEntityType, targetEntityId, properties JSON, eventTime +
zone, tags, prId, creationTime + zone — with timestamps stored as UTC epoch
micros plus the original offset, which preserves the wire-format round trip.

The port's own copy of ``predictionio_tpu/data/storage/sqlite.py``: the same
schema, WAL mode and indexes, so a database file written by either package
reads the same in the other. One connection is shared by every thread of a
process and each call holds the client's lock, so the event server's
handler threads are serialised here; another process (a train run reading
while the server writes) goes through WAL.
"""

from __future__ import annotations

import datetime as _dt
import json
import os
import sqlite3
import threading
import uuid

import numpy as np
from typing import Iterable, Iterator, Sequence

from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import UTC, Event
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EvaluationInstance,
    Model,
)

_SCHEMA = """
CREATE TABLE IF NOT EXISTS event_versions (
  tbl TEXT PRIMARY KEY,
  version INTEGER NOT NULL DEFAULT 0
);
CREATE TABLE IF NOT EXISTS apps (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT NOT NULL UNIQUE,
  description TEXT
);
CREATE TABLE IF NOT EXISTS accesskeys (
  accesskey TEXT PRIMARY KEY,
  appid INTEGER NOT NULL,
  events TEXT NOT NULL DEFAULT ''
);
CREATE TABLE IF NOT EXISTS channels (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT NOT NULL,
  appid INTEGER NOT NULL
);
CREATE TABLE IF NOT EXISTS engineinstances (
  id TEXT PRIMARY KEY,
  status TEXT NOT NULL,
  startTime INTEGER NOT NULL,
  endTime INTEGER NOT NULL,
  engineId TEXT NOT NULL,
  engineVersion TEXT NOT NULL,
  engineVariant TEXT NOT NULL,
  engineFactory TEXT NOT NULL,
  batch TEXT NOT NULL DEFAULT '',
  env TEXT NOT NULL DEFAULT '{}',
  sparkConf TEXT NOT NULL DEFAULT '{}',
  dataSourceParams TEXT NOT NULL DEFAULT '{}',
  preparatorParams TEXT NOT NULL DEFAULT '{}',
  algorithmsParams TEXT NOT NULL DEFAULT '[]',
  servingParams TEXT NOT NULL DEFAULT '{}'
);
CREATE TABLE IF NOT EXISTS evaluationinstances (
  id TEXT PRIMARY KEY,
  status TEXT NOT NULL,
  startTime INTEGER NOT NULL,
  endTime INTEGER NOT NULL,
  evaluationClass TEXT NOT NULL DEFAULT '',
  engineParamsGeneratorClass TEXT NOT NULL DEFAULT '',
  batch TEXT NOT NULL DEFAULT '',
  env TEXT NOT NULL DEFAULT '{}',
  sparkConf TEXT NOT NULL DEFAULT '{}',
  evaluatorResults TEXT NOT NULL DEFAULT '',
  evaluatorResultsHTML TEXT NOT NULL DEFAULT '',
  evaluatorResultsJSON TEXT NOT NULL DEFAULT ''
);
CREATE TABLE IF NOT EXISTS models (
  id TEXT PRIMARY KEY,
  models BLOB NOT NULL
);
"""

_EVENT_TABLE_DDL = """
CREATE TABLE IF NOT EXISTS {table} (
  id TEXT PRIMARY KEY,
  event TEXT NOT NULL,
  entityType TEXT NOT NULL,
  entityId TEXT NOT NULL,
  targetEntityType TEXT,
  targetEntityId TEXT,
  properties TEXT,
  eventTime INTEGER NOT NULL,
  eventTimeZone TEXT NOT NULL,
  tags TEXT,
  prId TEXT,
  creationTime INTEGER NOT NULL,
  creationTimeZone TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS {table}_time ON {table} (eventTime);
CREATE INDEX IF NOT EXISTS {table}_entity ON {table} (entityType, entityId);
CREATE INDEX IF NOT EXISTS {table}_ctime ON {table} (creationTime, id);
"""


def _micros(t: _dt.datetime) -> int:
    if t.tzinfo is None:  # naive filters/timestamps are interpreted as UTC
        t = t.replace(tzinfo=_dt.timezone.utc)
    return int(t.timestamp() * 1_000_000)


def _from_micros(us: int, offset: str) -> _dt.datetime:
    t = _dt.datetime.fromtimestamp(us / 1_000_000, tz=UTC)
    if offset and offset != "Z":
        hh, _, mm = offset.lstrip("+-").partition(":")
        delta = _dt.timedelta(hours=int(hh), minutes=int(mm or 0))
        if offset.startswith("-"):
            delta = -delta
        t = t.astimezone(_dt.timezone(delta))
    return t


def _offset_of(t: _dt.datetime) -> str:
    off = t.utcoffset() or _dt.timedelta(0)
    if not off:
        return "Z"
    total = int(off.total_seconds())
    sign = "+" if total >= 0 else "-"
    total = abs(total)
    return f"{sign}{total // 3600:02d}:{(total % 3600) // 60:02d}"


def _event_table(app_id: int, channel_id: int | None) -> str:
    return f"events_{app_id}" if channel_id is None else f"events_{app_id}_{channel_id}"


def _is_missing_table(exc: sqlite3.OperationalError) -> bool:
    """Only 'no such table' means 'no events yet'; other operational errors
    (locked, I/O) must propagate instead of reading as empty data."""
    return "no such table" in str(exc)


# atomic per-table write counter bump, run inside data-write transactions
_BUMP_SQL = (
    "INSERT INTO event_versions (tbl, version) VALUES (?, 1) "
    "ON CONFLICT(tbl) DO UPDATE SET version = version + 1"
)


class SQLiteStorageClient:
    """Backend entry point (type name: ``sqlite``). Config key ``path``
    selects the database file; ``:memory:`` works for tests but is
    per-connection, so a shared connection is used throughout."""

    def __init__(self, config: dict | None = None):
        self.config = config or {}
        self.path = self.config.get("PATH") or self.config.get("path") or ":memory:"
        # snapshot-cache stamp disambiguator: two databases sharing one
        # snapshot root must not alias on equal (version, count); an
        # in-memory db is additionally unique per client instance
        if self.path == ":memory:":
            self.store_identity = f"sqlite:{uuid.uuid4().hex[:12]}"
        else:
            self.store_identity = f"sqlite:{os.path.abspath(self.path)}"
        self._conn = sqlite3.connect(self.path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._lock = threading.RLock()
        self._initialized_event_tables: set[str] = set()
        with self._lock, self._conn:
            self._conn.executescript(_SCHEMA)

    # -- connection helpers -------------------------------------------------
    def execute(self, sql: str, params: Sequence = ()) -> sqlite3.Cursor:
        with self._lock, self._conn:
            return self._conn.execute(sql, params)

    def query(self, sql: str, params: Sequence = ()) -> list[tuple]:
        with self._lock:
            return self._conn.execute(sql, params).fetchall()

    def close(self) -> None:
        self._conn.close()

    def bump_event_version(self, table: str) -> None:
        """Monotonic write counter per event table — the snapshot-cache
        stamp. Rowid/count/max-time are NOT sufficient (sqlite reuses a
        freed max rowid, so delete+reinsert could leave them unchanged)."""
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT INTO event_versions (tbl, version) VALUES (?, 1) "
                "ON CONFLICT(tbl) DO UPDATE SET version = version + 1",
                (table,),
            )

    def event_version(self, table: str) -> int:
        rows = self.query(
            "SELECT version FROM event_versions WHERE tbl = ?", (table,)
        )
        return rows[0][0] if rows else 0

    # DAO accessors used by registry reflection
    def l_events(self) -> "SQLiteLEvents":
        return SQLiteLEvents(self)

    def p_events(self) -> "SQLitePEvents":
        return SQLitePEvents(self)

    def apps(self) -> "SQLiteApps":
        return SQLiteApps(self)

    def access_keys(self) -> "SQLiteAccessKeys":
        return SQLiteAccessKeys(self)

    def channels(self) -> "SQLiteChannels":
        return SQLiteChannels(self)

    def engine_instances(self) -> "SQLiteEngineInstances":
        return SQLiteEngineInstances(self)

    def evaluation_instances(self) -> "SQLiteEvaluationInstances":
        return SQLiteEvaluationInstances(self)

    def models(self) -> "SQLiteModels":
        return SQLiteModels(self)


def _event_where(
    *,
    start_time=None,
    until_time=None,
    entity_type=None,
    entity_id=None,
    event_names=None,
    target_entity_type=...,
    target_entity_id=...,
) -> tuple[str, list]:
    """WHERE clause + params for the 9-filter event contract (shared by
    ``find`` and the raw-column columnar scan)."""
    clauses, params = [], []
    if start_time is not None:
        clauses.append("eventTime >= ?")
        params.append(_micros(start_time))
    if until_time is not None:
        clauses.append("eventTime < ?")
        params.append(_micros(until_time))
    if entity_type is not None:
        clauses.append("entityType = ?")
        params.append(entity_type)
    if entity_id is not None:
        clauses.append("entityId = ?")
        params.append(entity_id)
    if event_names is not None:
        placeholders = ",".join("?" for _ in event_names)
        clauses.append(f"event IN ({placeholders})")
        params.extend(event_names)
    if target_entity_type is not ...:
        if target_entity_type is None:
            clauses.append("targetEntityType IS NULL")
        else:
            clauses.append("targetEntityType = ?")
            params.append(target_entity_type)
    if target_entity_id is not ...:
        if target_entity_id is None:
            clauses.append("targetEntityId IS NULL")
        else:
            clauses.append("targetEntityId = ?")
            params.append(target_entity_id)
    return (f" WHERE {' AND '.join(clauses)}" if clauses else ""), params


class SQLiteLEvents(base.LEvents):
    def __init__(self, client: SQLiteStorageClient):
        self._c = client

    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        table = _event_table(app_id, channel_id)
        if table in self._c._initialized_event_tables:
            return True
        with self._c._lock, self._c._conn:
            self._c._conn.executescript(_EVENT_TABLE_DDL.format(table=table))
            self._c._initialized_event_tables.add(table)
        return True

    def remove(self, app_id: int, channel_id: int | None = None) -> bool:
        table = _event_table(app_id, channel_id)
        self._c.execute(f"DROP TABLE IF EXISTS {table}")
        self._c._initialized_event_tables.discard(table)
        self._c.bump_event_version(table)
        return True

    def close(self) -> None:
        pass

    def insert(self, event: Event, app_id: int, channel_id: int | None = None) -> str:
        return self.insert_batch([event], app_id, channel_id)[0]

    def insert_batch(
        self, events: Sequence[Event], app_id: int, channel_id: int | None = None
    ) -> list[str]:
        self.init(app_id, channel_id)
        table = _event_table(app_id, channel_id)
        ids, rows = [], []
        for event in events:
            event_id = event.event_id or uuid.uuid4().hex
            ids.append(event_id)
            rows.append(
                (
                    event_id,
                    event.event,
                    event.entity_type,
                    event.entity_id,
                    event.target_entity_type,
                    event.target_entity_id,
                    json.dumps(event.properties, sort_keys=True),
                    _micros(event.event_time),
                    _offset_of(event.event_time),
                    json.dumps(list(event.tags)) if event.tags else "[]",
                    event.pr_id,
                    _micros(event.creation_time),
                    _offset_of(event.creation_time),
                )
            )
        with self._c._lock, self._c._conn:
            self._c._conn.executemany(
                f"INSERT OR REPLACE INTO {table} VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?)",
                rows,
            )
            # stamp bump in the same transaction: a crash can never commit
            # data without invalidating cached snapshots
            self._c._conn.execute(_BUMP_SQL, (table,))
        return ids

    @staticmethod
    def _row_to_event(row: tuple) -> Event:
        (
            event_id,
            name,
            entity_type,
            entity_id,
            tet,
            tei,
            properties,
            event_time,
            event_tz,
            tags,
            pr_id,
            creation_time,
            creation_tz,
        ) = row
        return Event(
            event=name,
            entity_type=entity_type,
            entity_id=entity_id,
            target_entity_type=tet,
            target_entity_id=tei,
            properties=DataMap.from_json(properties or "{}").fields,
            event_time=_from_micros(event_time, event_tz),
            event_id=event_id,
            tags=tuple(json.loads(tags or "[]")),
            pr_id=pr_id,
            creation_time=_from_micros(creation_time, creation_tz),
        )

    def get(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> Event | None:
        table = _event_table(app_id, channel_id)
        try:
            rows = self._c.query(f"SELECT * FROM {table} WHERE id = ?", (event_id,))
        except sqlite3.OperationalError as exc:
            if _is_missing_table(exc):  # app has no events yet
                return None
            raise
        return self._row_to_event(rows[0]) if rows else None

    def delete(self, event_id: str, app_id: int, channel_id: int | None = None) -> bool:
        table = _event_table(app_id, channel_id)
        try:
            with self._c._lock, self._c._conn:
                cur = self._c._conn.execute(
                    f"DELETE FROM {table} WHERE id = ?", (event_id,)
                )
                if cur.rowcount > 0:  # stamp bump rides the delete txn
                    self._c._conn.execute(_BUMP_SQL, (table,))
        except sqlite3.OperationalError as exc:
            if _is_missing_table(exc):
                return False
            raise
        return cur.rowcount > 0

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
        table = _event_table(app_id, channel_id)
        where, params = _event_where(
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            entity_id=entity_id,
            event_names=event_names,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id,
        )
        order = "DESC" if reversed else "ASC"
        sql = f"SELECT * FROM {table}{where} ORDER BY eventTime {order}"
        if limit is not None and limit >= 0:
            sql += f" LIMIT {int(limit)}"
        try:
            rows = self._c.query(sql, params)
        except sqlite3.OperationalError as exc:
            if _is_missing_table(exc):  # table not yet created = no events
                return iter(())
            raise
        return (self._row_to_event(r) for r in rows)

    def find_after(
        self,
        app_id: int,
        channel_id: int | None = None,
        cursor: tuple[int, str] | None = None,
        limit: int = 100,
    ) -> list[Event]:
        """Indexed tail read on ``(creationTime, id)`` — the ordering
        contract of ``base.event_seq_key`` executed server-side. The id
        column is ASCII hex, so SQL text comparison and python string
        comparison agree on the tiebreak."""
        limit = base.check_tail_limit(limit)
        table = _event_table(app_id, channel_id)
        where, params = "", []
        if cursor is not None:
            where = " WHERE creationTime > ? OR (creationTime = ? AND id > ?)"
            params = [int(cursor[0]), int(cursor[0]), str(cursor[1])]
        sql = (
            f"SELECT * FROM {table}{where} "
            f"ORDER BY creationTime, id LIMIT {limit}"
        )
        try:
            rows = self._c.query(sql, params)
        except sqlite3.OperationalError as exc:
            if _is_missing_table(exc):
                return []
            raise
        return [self._row_to_event(r) for r in rows]

    def seq_head(
        self, app_id: int, channel_id: int | None = None
    ) -> tuple[int, str] | None:
        table = _event_table(app_id, channel_id)
        try:
            rows = self._c.query(
                f"SELECT creationTime, id FROM {table} "
                "ORDER BY creationTime DESC, id DESC LIMIT 1"
            )
        except sqlite3.OperationalError as exc:
            if _is_missing_table(exc):
                return None
            raise
        return (int(rows[0][0]), str(rows[0][1])) if rows else None


class SQLitePEvents(base.PEvents):
    def __init__(self, client: SQLiteStorageClient):
        self._c = client
        self._l = SQLiteLEvents(client)

    def find(self, app_id: int, channel_id: int | None = None, **kw) -> Iterator[Event]:
        return self._l.find(app_id, channel_id, **kw)

    _COLUMNAR_FAST_KW = frozenset(
        (
            "event_names", "rating_key", "entity_vocab", "target_vocab",
            "start_time", "until_time", "entity_type", "entity_id",
            "target_entity_type", "target_entity_id",
        )
    )

    def to_columnar(self, app_id: int, channel_id: int | None = None, **kw):
        """Raw-column columnar scan: selects only the five encoded columns
        and lets sqlite's ``json_extract`` pull the rating out of the
        properties JSON in C. The generic path builds an Event + DataMap +
        two tz-aware datetimes per row just to throw them away — measured
        ~5x slower at the snapshot-ingest bench's 200k rows. Output is
        identical (same vocab encounter order, same codes/timestamps);
        unsupported kwargs fall back to the generic encoder."""
        rating_key = kw.get("rating_key", "rating")
        if (
            "events" in kw
            or set(kw) - self._COLUMNAR_FAST_KW
            # JSON-path metacharacters would need escaping; rare keys take
            # the generic path instead of risking a wrong path expression
            or not rating_key.replace("_", "").isalnum()
        ):
            return super().to_columnar(app_id, channel_id, **kw)
        table = _event_table(app_id, channel_id)
        where, params = _event_where(
            start_time=kw.get("start_time"),
            until_time=kw.get("until_time"),
            entity_type=kw.get("entity_type"),
            entity_id=kw.get("entity_id"),
            event_names=kw.get("event_names"),
            target_entity_type=kw.get("target_entity_type", ...),
            target_entity_id=kw.get("target_entity_id", ...),
        )
        sql = (
            f"SELECT id, event, entityId, targetEntityId, eventTime, "
            f"json_extract(properties, ?) FROM {table}{where} "
            f"ORDER BY eventTime ASC"
        )
        try:
            rows = self._c.query(sql, [f"$.{rating_key}", *params])
        except sqlite3.OperationalError as exc:
            if _is_missing_table(exc):
                rows = []
            else:
                raise
        entity_vocab = kw.get("entity_vocab")
        target_vocab = kw.get("target_vocab")
        ent_index: dict[str, int] = (
            {v: i for i, v in enumerate(entity_vocab)} if entity_vocab else {}
        )
        tgt_index: dict[str, int] = (
            {v: i for i, v in enumerate(target_vocab)} if target_vocab else {}
        )
        frozen_ent = entity_vocab is not None
        frozen_tgt = target_vocab is not None
        ev_index: dict[str, int] = {}
        n = len(rows)
        event_ids: list[str] = [""] * n
        names: list[str] = [""] * n
        ent_col = np.empty(n, np.int32)
        tgt_col = np.empty(n, np.int32)
        ev_col = np.empty(n, np.int32)
        ts_col = np.empty(n, np.float64)
        rating_col = np.empty(n, np.float32)
        for i, (eid, name, ent, tgt, micros, rating) in enumerate(rows):
            event_ids[i] = eid or ""
            names[i] = name
            if frozen_ent:
                ent_col[i] = ent_index.get(ent, -1)
            else:
                ent_col[i] = ent_index.setdefault(ent, len(ent_index))
            if tgt is None:
                tgt_col[i] = -1
            elif frozen_tgt:
                tgt_col[i] = tgt_index.get(tgt, -1)
            else:
                tgt_col[i] = tgt_index.setdefault(tgt, len(tgt_index))
            ev_col[i] = ev_index.setdefault(name, len(ev_index))
            # micros/1e6 == Event.event_time.timestamp() (tz-independent)
            ts_col[i] = micros / 1e6
            # json_extract: numbers arrive as int/float (bool as 0/1, like
            # DataMap's isinstance(int) rule); TEXT/NULL/objects -> NaN
            rating_col[i] = (
                float(rating) if isinstance(rating, (int, float)) else float("nan")
            )
        return base.ColumnarEvents(
            event_ids=event_ids,
            event_names=names,
            entity_ids=ent_col,
            target_ids=tgt_col,
            event_codes=ev_col,
            timestamps=ts_col,
            ratings=rating_col,
            entity_vocab=list(entity_vocab) if frozen_ent else list(ent_index),
            target_vocab=list(target_vocab) if frozen_tgt else list(tgt_index),
            event_vocab=list(ev_index),
        )

    def write(
        self, events: Iterable[Event], app_id: int, channel_id: int | None = None
    ) -> None:
        self._l.insert_batch(list(events), app_id, channel_id)

    def delete(
        self, event_ids: Iterable[str], app_id: int, channel_id: int | None = None
    ) -> None:
        ids = list(event_ids)
        if not ids:
            return
        table = _event_table(app_id, channel_id)
        # chunked DELETE ... IN + the version bump in one transaction
        # (not one txn per id, and no data-without-stamp crash window)
        try:
            with self._c._lock, self._c._conn:
                for chunk_start in range(0, len(ids), 500):
                    chunk = ids[chunk_start : chunk_start + 500]
                    placeholders = ",".join("?" for _ in chunk)
                    self._c._conn.execute(
                        f"DELETE FROM {table} WHERE id IN ({placeholders})", chunk
                    )
                self._c._conn.execute(_BUMP_SQL, (table,))
        except sqlite3.OperationalError as exc:
            if _is_missing_table(exc):
                return
            raise

    def version_stamp(self, app_id: int, channel_id: int | None = None) -> str | None:
        table = _event_table(app_id, channel_id)
        version = self._c.event_version(table)
        try:
            rows = self._c.query(f"SELECT COUNT(*) FROM {table}")
            count = rows[0][0]
        except sqlite3.OperationalError as exc:
            if not _is_missing_table(exc):
                raise
            count = 0
        return f"v{version}:{count}"

    def store_identity(self) -> str | None:
        return self._c.store_identity


class SQLiteApps(base.Apps):
    def __init__(self, client: SQLiteStorageClient):
        self._c = client

    def insert(self, app: App) -> int | None:
        try:
            if app.id:
                self._c.execute(
                    "INSERT INTO apps (id, name, description) VALUES (?,?,?)",
                    (app.id, app.name, app.description),
                )
                return app.id
            cur = self._c.execute(
                "INSERT INTO apps (name, description) VALUES (?,?)",
                (app.name, app.description),
            )
            return cur.lastrowid
        except sqlite3.IntegrityError:
            return None

    def get(self, app_id: int) -> App | None:
        rows = self._c.query("SELECT id, name, description FROM apps WHERE id=?", (app_id,))
        return App(*rows[0]) if rows else None

    def get_by_name(self, name: str) -> App | None:
        rows = self._c.query(
            "SELECT id, name, description FROM apps WHERE name=?", (name,)
        )
        return App(*rows[0]) if rows else None

    def get_all(self) -> list[App]:
        return [App(*r) for r in self._c.query("SELECT id, name, description FROM apps ORDER BY id")]

    def update(self, app: App) -> None:
        self._c.execute(
            "UPDATE apps SET name=?, description=? WHERE id=?",
            (app.name, app.description, app.id),
        )

    def delete(self, app_id: int) -> None:
        self._c.execute("DELETE FROM apps WHERE id=?", (app_id,))


class SQLiteAccessKeys(base.AccessKeys):
    def __init__(self, client: SQLiteStorageClient):
        self._c = client

    def insert(self, k: AccessKey) -> str | None:
        key = k.key or base.generate_access_key()
        try:
            self._c.execute(
                "INSERT INTO accesskeys (accesskey, appid, events) VALUES (?,?,?)",
                (key, k.appid, json.dumps(list(k.events))),
            )
            return key
        except sqlite3.IntegrityError:
            return None

    @staticmethod
    def _row(r: tuple) -> AccessKey:
        # JSON list; event names may contain any non-reserved characters
        raw = r[2] or "[]"
        events = json.loads(raw) if raw.startswith("[") else [e for e in raw.split(",") if e]
        return AccessKey(r[0], r[1], tuple(events))

    def get(self, key: str) -> AccessKey | None:
        rows = self._c.query("SELECT * FROM accesskeys WHERE accesskey=?", (key,))
        return self._row(rows[0]) if rows else None

    def get_all(self) -> list[AccessKey]:
        return [self._row(r) for r in self._c.query("SELECT * FROM accesskeys")]

    def get_by_app_id(self, app_id: int) -> list[AccessKey]:
        return [
            self._row(r)
            for r in self._c.query("SELECT * FROM accesskeys WHERE appid=?", (app_id,))
        ]

    def update(self, k: AccessKey) -> None:
        self._c.execute(
            "UPDATE accesskeys SET appid=?, events=? WHERE accesskey=?",
            (k.appid, json.dumps(list(k.events)), k.key),
        )

    def delete(self, key: str) -> None:
        self._c.execute("DELETE FROM accesskeys WHERE accesskey=?", (key,))


class SQLiteChannels(base.Channels):
    def __init__(self, client: SQLiteStorageClient):
        self._c = client

    def insert(self, channel: Channel) -> int | None:
        if not Channel.is_valid_name(channel.name):
            return None
        try:
            if channel.id:
                self._c.execute(
                    "INSERT INTO channels (id, name, appid) VALUES (?,?,?)",
                    (channel.id, channel.name, channel.appid),
                )
                return channel.id
            cur = self._c.execute(
                "INSERT INTO channels (name, appid) VALUES (?,?)",
                (channel.name, channel.appid),
            )
            return cur.lastrowid
        except sqlite3.IntegrityError:
            return None

    def get(self, channel_id: int) -> Channel | None:
        rows = self._c.query(
            "SELECT id, name, appid FROM channels WHERE id=?", (channel_id,)
        )
        return Channel(*rows[0]) if rows else None

    def get_by_app_id(self, app_id: int) -> list[Channel]:
        return [
            Channel(*r)
            for r in self._c.query(
                "SELECT id, name, appid FROM channels WHERE appid=?", (app_id,)
            )
        ]

    def delete(self, channel_id: int) -> None:
        self._c.execute("DELETE FROM channels WHERE id=?", (channel_id,))


_EI_COLS = (
    "id, status, startTime, endTime, engineId, engineVersion, engineVariant, "
    "engineFactory, batch, env, sparkConf, dataSourceParams, preparatorParams, "
    "algorithmsParams, servingParams"
)


class SQLiteEngineInstances(base.EngineInstances):
    def __init__(self, client: SQLiteStorageClient):
        self._c = client

    def insert(self, i: EngineInstance) -> str:
        iid = i.id or uuid.uuid4().hex
        i.id = iid
        self._c.execute(
            f"INSERT OR REPLACE INTO engineinstances ({_EI_COLS}) "
            "VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
            (
                iid,
                i.status,
                _micros(i.start_time),
                _micros(i.end_time),
                i.engine_id,
                i.engine_version,
                i.engine_variant,
                i.engine_factory,
                i.batch,
                json.dumps(i.env),
                json.dumps(i.spark_conf),
                i.data_source_params,
                i.preparator_params,
                i.algorithms_params,
                i.serving_params,
            ),
        )
        return iid

    @staticmethod
    def _row(r: tuple) -> EngineInstance:
        return EngineInstance(
            id=r[0],
            status=r[1],
            start_time=_from_micros(r[2], "Z"),
            end_time=_from_micros(r[3], "Z"),
            engine_id=r[4],
            engine_version=r[5],
            engine_variant=r[6],
            engine_factory=r[7],
            batch=r[8],
            env=json.loads(r[9]),
            spark_conf=json.loads(r[10]),
            data_source_params=r[11],
            preparator_params=r[12],
            algorithms_params=r[13],
            serving_params=r[14],
        )

    def get(self, instance_id: str) -> EngineInstance | None:
        rows = self._c.query(
            f"SELECT {_EI_COLS} FROM engineinstances WHERE id=?", (instance_id,)
        )
        return self._row(rows[0]) if rows else None

    def get_all(self) -> list[EngineInstance]:
        return [self._row(r) for r in self._c.query(f"SELECT {_EI_COLS} FROM engineinstances")]

    def get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> list[EngineInstance]:
        rows = self._c.query(
            f"SELECT {_EI_COLS} FROM engineinstances WHERE status=? AND engineId=? "
            "AND engineVersion=? AND engineVariant=? ORDER BY startTime DESC",
            (
                base.EngineInstanceStatus.COMPLETED,
                engine_id,
                engine_version,
                engine_variant,
            ),
        )
        return [self._row(r) for r in rows]

    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> EngineInstance | None:
        completed = self.get_completed(engine_id, engine_version, engine_variant)
        return completed[0] if completed else None

    def update(self, i: EngineInstance) -> None:
        self.insert(i)

    def delete(self, instance_id: str) -> None:
        self._c.execute("DELETE FROM engineinstances WHERE id=?", (instance_id,))


_EVI_COLS = (
    "id, status, startTime, endTime, evaluationClass, engineParamsGeneratorClass, "
    "batch, env, sparkConf, evaluatorResults, evaluatorResultsHTML, evaluatorResultsJSON"
)


class SQLiteEvaluationInstances(base.EvaluationInstances):
    def __init__(self, client: SQLiteStorageClient):
        self._c = client

    def insert(self, i: EvaluationInstance) -> str:
        iid = i.id or uuid.uuid4().hex
        i.id = iid
        self._c.execute(
            f"INSERT OR REPLACE INTO evaluationinstances ({_EVI_COLS}) "
            "VALUES (?,?,?,?,?,?,?,?,?,?,?,?)",
            (
                iid,
                i.status,
                _micros(i.start_time),
                _micros(i.end_time),
                i.evaluation_class,
                i.engine_params_generator_class,
                i.batch,
                json.dumps(i.env),
                json.dumps(i.spark_conf),
                i.evaluator_results,
                i.evaluator_results_html,
                i.evaluator_results_json,
            ),
        )
        return iid

    @staticmethod
    def _row(r: tuple) -> EvaluationInstance:
        return EvaluationInstance(
            id=r[0],
            status=r[1],
            start_time=_from_micros(r[2], "Z"),
            end_time=_from_micros(r[3], "Z"),
            evaluation_class=r[4],
            engine_params_generator_class=r[5],
            batch=r[6],
            env=json.loads(r[7]),
            spark_conf=json.loads(r[8]),
            evaluator_results=r[9],
            evaluator_results_html=r[10],
            evaluator_results_json=r[11],
        )

    def get(self, instance_id: str) -> EvaluationInstance | None:
        rows = self._c.query(
            f"SELECT {_EVI_COLS} FROM evaluationinstances WHERE id=?", (instance_id,)
        )
        return self._row(rows[0]) if rows else None

    def get_all(self) -> list[EvaluationInstance]:
        return [
            self._row(r)
            for r in self._c.query(f"SELECT {_EVI_COLS} FROM evaluationinstances")
        ]

    def get_completed(self) -> list[EvaluationInstance]:
        rows = self._c.query(
            f"SELECT {_EVI_COLS} FROM evaluationinstances WHERE status=? "
            "ORDER BY startTime DESC",
            (base.EvaluationInstanceStatus.EVALCOMPLETED,),
        )
        return [self._row(r) for r in rows]

    def update(self, i: EvaluationInstance) -> None:
        self.insert(i)

    def delete(self, instance_id: str) -> None:
        self._c.execute("DELETE FROM evaluationinstances WHERE id=?", (instance_id,))


class SQLiteModels(base.Models):
    def __init__(self, client: SQLiteStorageClient):
        self._c = client

    def insert(self, model: Model) -> None:
        self._c.execute(
            "INSERT OR REPLACE INTO models (id, models) VALUES (?,?)",
            (model.id, model.models),
        )

    def get(self, model_id: str) -> Model | None:
        rows = self._c.query("SELECT id, models FROM models WHERE id=?", (model_id,))
        return Model(rows[0][0], rows[0][1]) if rows else None

    def delete(self, model_id: str) -> None:
        self._c.execute("DELETE FROM models WHERE id=?", (model_id,))
