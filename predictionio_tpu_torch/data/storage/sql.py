"""Client/server SQL storage backend over any DB-API 2.0 driver.

Plays the role of the reference's JDBC driver for *external* databases
(``storage/jdbc/`` — scalikejdbc against PostgreSQL/MySQL, implementing every
DAO: ``JDBCApps/AccessKeys/Channels/EngineInstances/EvaluationInstances/
JDBCLEvents/JDBCPEvents/JDBCModels``; discovery contract
``Storage.scala:310-337``). Where the reference binds to JDBC URLs, this
driver binds to any Python DB-API 2.0 module — ``psycopg2``/``psycopg``
(PostgreSQL), ``pymysql``/``MySQLdb`` (MySQL/MariaDB) — selected by backend
type name ``postgres`` / ``mysql``, or any other module via the generic
``sql`` type with ``MODULE=<dbapi module>``. Driver imports are gated: the
module is imported at connect time, with a clear error naming the missing
dependency (nothing is ever auto-installed).

SQL is written once against a small dialect table (placeholder style,
auto-increment PK clause, blob column type); statements are portable across
SQLite, PostgreSQL and MySQL. Upserts are DELETE+INSERT inside one
transaction rather than per-dialect ``ON CONFLICT``/``ON DUPLICATE KEY``.
The event-table column layout matches the reference's JDBC DDL
(``storage/jdbc/.../JDBCLEvents.scala:54-68``) and the sqlite backend:
timestamps as UTC epoch micros + original offset.

The port's own copy of ``predictionio_tpu/data/storage/sql.py``: the same
statements, schema and partitioned scan, so a database written by either
package reads the same in the other. Event properties are a plain dict here.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import importlib
import json
import logging
import threading
import uuid
from typing import Iterable, Iterator, Sequence

from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EvaluationInstance,
    Model,
)
from predictionio_tpu_torch.data.storage.registry import StorageError
from predictionio_tpu_torch.data.storage.sqlite import (
    _event_table,
    _from_micros,
    _micros,
    _offset_of,
)
from predictionio_tpu_torch.resilience import RetryPolicy

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class SQLDialect:
    """The portable subset of DDL/DML that differs across engines."""

    paramstyle: str  # qmark | format | pyformat | numeric
    serial_pk: str  # auto-increment integer primary key clause
    blob_type: str
    # psycopg2 cursors have no useful lastrowid; use INSERT .. RETURNING id
    use_returning: bool = False

    def sql(self, statement: str) -> str:
        """Statements are written with ``?`` placeholders; rewrite for the
        driver's paramstyle. None of our SQL contains literal '?'."""
        if self.paramstyle == "qmark":
            return statement
        if self.paramstyle in ("format", "pyformat"):
            return statement.replace("?", "%s")
        if self.paramstyle == "numeric":
            out, n = [], 0
            for ch in statement:
                if ch == "?":
                    n += 1
                    out.append(f":{n}")
                else:
                    out.append(ch)
            return "".join(out)
        raise StorageError(f"unsupported DB-API paramstyle {self.paramstyle!r}")


_DIALECTS = {
    "sqlite": SQLDialect("qmark", "INTEGER PRIMARY KEY AUTOINCREMENT", "BLOB"),
    "postgres": SQLDialect("pyformat", "SERIAL PRIMARY KEY", "BYTEA", use_returning=True),
    "mysql": SQLDialect("format", "INTEGER PRIMARY KEY AUTO_INCREMENT", "LONGBLOB"),
}

# backend type name -> (candidate DB-API modules, dialect)
_DRIVERS = {
    "postgres": (("psycopg2", "psycopg"), "postgres"),
    "mysql": (("pymysql", "MySQLdb"), "mysql"),
}


def _load_driver(type_name: str, config: dict):
    """Resolve (dbapi module, dialect name) from config. Gated imports."""
    module_name = config.get("MODULE") or config.get("module")
    if module_name:
        try:
            mod = importlib.import_module(module_name)
        except ImportError as exc:
            raise StorageError(
                f"DB-API module {module_name!r} is not installed; install it or "
                f"switch PIO_STORAGE_SOURCES_*_TYPE to sqlite/jsonl/memory"
            ) from exc
        dialect = config.get("DIALECT") or config.get("dialect")
        if not dialect:
            lowered = module_name.lower()
            if module_name == "sqlite3":
                dialect = "sqlite"
            elif lowered.startswith("psycopg") or "postgres" in lowered:
                dialect = "postgres"
            elif "mysql" in lowered or lowered == "mariadb":
                dialect = "mysql"
            else:
                raise StorageError(
                    f"cannot infer SQL dialect from module {module_name!r}; set "
                    f"DIALECT to one of {sorted(_DIALECTS)}"
                )
        if dialect not in _DIALECTS:
            raise StorageError(
                f"unknown SQL dialect {dialect!r}; known: {sorted(_DIALECTS)}"
            )
        return mod, dialect
    candidates, dialect = _DRIVERS.get(type_name, ((), ""))
    for name in candidates:
        try:
            return importlib.import_module(name), dialect
        except ImportError:
            continue
    raise StorageError(
        f"storage type {type_name!r} needs one of {list(candidates)} installed "
        f"(none found); use sqlite/jsonl/memory for a dependency-free setup"
    )


class SQLStorageClient:
    """Backend entry point (type names ``postgres``, ``mysql``, ``sql``).

    Config keys (reference ``conf/pio-env.sh.template`` JDBC block:
    ``PIO_STORAGE_SOURCES_PGSQL_{TYPE,URL,USERNAME,PASSWORD}``):
    ``HOST/PORT/DATABASE/USERNAME/PASSWORD`` or ``CONNECT_ARGS`` (JSON dict
    passed to ``connect``), plus ``MODULE``/``DIALECT`` for the generic type.
    """

    def __init__(self, config: dict | None = None, type_name: str = "postgres"):
        self.config = {k.upper(): v for k, v in (config or {}).items()}
        self._mod, dialect_name = _load_driver(
            self.config.get("TYPE", type_name).lower(), self.config
        )
        self.dialect = _DIALECTS[dialect_name]
        self._lock = threading.RLock()
        self._initialized_event_tables: set[str] = set()
        # reconnect-and-retry for dropped connections (see docs/resilience.md):
        # reads retry by default; writes only with RETRY_WRITES=true, because
        # a connection that died after the server applied the commit makes a
        # replayed INSERT a duplicate (the ES driver documents the same
        # ambiguity; idempotent callers can opt in)
        self._retry = RetryPolicy(
            max_attempts=max(1, int(self.config.get("RETRIES", 3))),
            backoff_base_s=float(self.config.get("RETRY_BACKOFF_S", 0.1)),
            retry_on=self._is_transient_db_error,
        )
        self._retry_writes = str(self.config.get("RETRY_WRITES", "")).lower() in (
            "1",
            "true",
            "yes",
        )
        self._conn = self._connect()
        self._init_schema()

    @property
    def store_identity(self) -> str:
        """Disambiguates snapshot-cache stamps across distinct databases
        sharing one snapshot root (same counts on two DBs must not alias)."""
        import hashlib

        ident = json.dumps(
            {
                k: v
                for k, v in sorted(self.config.items())
                if k not in ("PASSWORD",)
            },
            sort_keys=True,
            default=str,
        )
        return hashlib.sha1(ident.encode()).hexdigest()[:12]

    def _connect(self):
        raw = self.config.get("CONNECT_ARGS")
        if raw is not None:
            kwargs = json.loads(raw) if isinstance(raw, str) else dict(raw)
        else:
            kwargs = {}
            for cfg_key, arg in (
                ("HOST", "host"),
                ("PORT", "port"),
                ("DATABASE", "database"),
                ("USERNAME", "user"),
                ("PASSWORD", "password"),
            ):
                if self.config.get(cfg_key) is not None:
                    kwargs[arg] = self.config[cfg_key]
            if "port" in kwargs:
                kwargs["port"] = int(kwargs["port"])
        if self._mod.__name__ == "sqlite3":
            kwargs.setdefault("check_same_thread", False)
        return self._mod.connect(**kwargs)

    # -- resilience helpers -------------------------------------------------
    # OperationalError is a grab-bag: it covers dropped connections AND
    # permanent programming errors ('no such table', unknown column). Only
    # messages matching these markers (the SQLAlchemy is_disconnect
    # approach) are treated as transient — a schema mismatch must surface
    # immediately, not become a retry + reconnect storm.
    _DISCONNECT_MARKERS = (
        "database is locked",  # sqlite busy: clears on retry
        "server closed the connection",
        "connection already closed",
        "connection is closed",
        "could not connect",
        "connection refused",
        "connection reset",
        "connection timed out",
        "broken pipe",
        "lost connection",
        "gone away",
        "ssl connection has been closed",
        "terminating connection",
    )

    def _is_transient_db_error(self, exc: BaseException) -> bool:
        """Driver-level connection trouble worth a reconnect + replay."""
        if isinstance(exc, (ConnectionError, TimeoutError)):
            return True
        iface = getattr(self._mod, "InterfaceError", None)
        if iface is not None and isinstance(exc, iface):
            return True  # interface errors are connection-level by contract
        oper = getattr(self._mod, "OperationalError", None)
        if oper is not None and isinstance(exc, oper):
            msg = str(exc).lower()
            return any(marker in msg for marker in self._DISCONNECT_MARKERS)
        return False

    def _reset_connection(self) -> None:
        """Drop and rebuild the connection before a retry. Skipped for
        sqlite3: its transient error (locked db) clears on the SAME
        connection, and reconnecting would wipe a ``:memory:`` database."""
        if self._mod.__name__ == "sqlite3":
            return
        with self._lock:
            try:
                self._conn.close()
            except Exception:
                pass
            try:
                self._conn = self._connect()
            except Exception:
                logger.warning("reconnect failed; next attempt will retry")

    def _resilient(self, fn, write: bool):
        if write and not self._retry_writes:
            # no replay (ambiguous-commit risk) — but still heal a dead
            # connection so the NEXT call works; otherwise a write-dominated
            # workload never recovers from a server restart
            try:
                return fn()
            except Exception as exc:
                if self._is_transient_db_error(exc):
                    self._reset_connection()
                raise

        def attempt():
            try:
                return fn()
            except Exception as exc:
                if self._is_transient_db_error(exc):
                    self._reset_connection()
                raise

        return self._retry.call(attempt)

    # -- low-level helpers --------------------------------------------------
    def execute(self, statement: str, params: Sequence = ()):
        """One write statement in its own transaction; returns the cursor."""
        return self._resilient(lambda: self._execute_once(statement, params), write=True)

    def _execute_once(self, statement: str, params: Sequence = ()):
        with self._lock:
            cur = self._conn.cursor()
            try:
                cur.execute(self.dialect.sql(statement), tuple(params))
                self._conn.commit()
            except Exception:
                self._conn.rollback()
                raise
            return cur

    def executemany(self, statement: str, rows: Sequence[Sequence]) -> None:
        self._resilient(lambda: self._executemany_once(statement, rows), write=True)

    def _executemany_once(self, statement: str, rows: Sequence[Sequence]) -> None:
        with self._lock:
            cur = self._conn.cursor()
            try:
                cur.executemany(self.dialect.sql(statement), [tuple(r) for r in rows])
                self._conn.commit()
            except Exception:
                self._conn.rollback()
                raise

    def query(self, statement: str, params: Sequence = ()) -> list[tuple]:
        return self._resilient(lambda: self._query_once(statement, params), write=False)

    def _query_once(self, statement: str, params: Sequence = ()) -> list[tuple]:
        with self._lock:
            cur = self._conn.cursor()
            try:
                cur.execute(self.dialect.sql(statement), tuple(params))
                rows = cur.fetchall()
                self._conn.commit()  # close PG's implicit read transaction
            except Exception:
                # without this, one failed read leaves a PG connection in an
                # aborted transaction and every later statement fails
                self._conn.rollback()
                raise
            return [tuple(r) for r in rows]

    def query_iter(
        self, statement: str, params: Sequence = (), chunk_rows: int = 10_000
    ) -> Iterator[tuple]:
        """Streaming read: rows are yielded in ``chunk_rows`` fetches instead
        of materialized with one fetchall — the difference between scanning a
        20M-event table in bounded memory and OOMing the train job. On
        PostgreSQL a server-side (named) cursor keeps the result set on the
        server; sqlite3 streams natively via fetchmany."""
        cur = None
        with self._lock:
            if self.dialect.use_returning:  # postgres: server-side cursor
                try:
                    cur = self._conn.cursor(name=f"pio_scan_{uuid.uuid4().hex[:8]}")
                except TypeError:
                    cur = None
            if cur is None:
                cur = self._conn.cursor()
            try:
                cur.execute(self.dialect.sql(statement), tuple(params))
            except Exception:
                self._conn.rollback()
                raise
        try:
            while True:
                with self._lock:
                    try:
                        rows = cur.fetchmany(chunk_rows)
                    except Exception:
                        self._conn.rollback()
                        raise
                if not rows:
                    break
                for r in rows:
                    yield tuple(r)
        finally:
            with self._lock:
                try:
                    cur.close()
                    self._conn.commit()
                except Exception:
                    try:
                        self._conn.rollback()
                    except Exception:
                        pass

    def insert_returning_id(self, statement: str, params: Sequence) -> int:
        """INSERT into a serial-PK table, returning the generated id."""
        with self._lock:
            cur = self._conn.cursor()
            try:
                if self.dialect.use_returning:
                    cur.execute(
                        self.dialect.sql(statement + " RETURNING id"), tuple(params)
                    )
                    new_id = cur.fetchone()[0]
                else:
                    cur.execute(self.dialect.sql(statement), tuple(params))
                    new_id = cur.lastrowid
                self._conn.commit()
            except Exception:
                self._conn.rollback()
                raise
            return int(new_id)

    def upsert(self, table: str, id_col: str, id_val, statement: str, params: Sequence):
        """Portable REPLACE: delete-then-insert in one transaction."""
        with self._lock:
            cur = self._conn.cursor()
            try:
                cur.execute(
                    self.dialect.sql(f"DELETE FROM {table} WHERE {id_col} = ?"),
                    (id_val,),
                )
                cur.execute(self.dialect.sql(statement), tuple(params))
                self._conn.commit()
            except Exception:
                self._conn.rollback()
                raise

    def is_integrity_error(self, exc: Exception) -> bool:
        ie = getattr(self._mod, "IntegrityError", None)
        return ie is not None and isinstance(exc, ie)

    def close(self) -> None:
        self._conn.close()

    # -- schema -------------------------------------------------------------
    def _init_schema(self) -> None:
        d = self.dialect
        statements = [
            """CREATE TABLE IF NOT EXISTS event_versions (
                 tbl VARCHAR(255) PRIMARY KEY, version BIGINT NOT NULL DEFAULT 0)""",
            f"""CREATE TABLE IF NOT EXISTS apps (
                 id {d.serial_pk}, name VARCHAR(255) NOT NULL UNIQUE, description TEXT)""",
            """CREATE TABLE IF NOT EXISTS accesskeys (
                 accesskey VARCHAR(64) PRIMARY KEY, appid INTEGER NOT NULL,
                 events TEXT NOT NULL)""",
            f"""CREATE TABLE IF NOT EXISTS channels (
                 id {d.serial_pk}, name VARCHAR(16) NOT NULL, appid INTEGER NOT NULL)""",
            """CREATE TABLE IF NOT EXISTS engineinstances (
                 id VARCHAR(64) PRIMARY KEY, status VARCHAR(32) NOT NULL,
                 startTime BIGINT NOT NULL, endTime BIGINT NOT NULL,
                 engineId TEXT NOT NULL, engineVersion TEXT NOT NULL,
                 engineVariant TEXT NOT NULL, engineFactory TEXT NOT NULL,
                 batch TEXT NOT NULL, env TEXT NOT NULL, sparkConf TEXT NOT NULL,
                 dataSourceParams TEXT NOT NULL, preparatorParams TEXT NOT NULL,
                 algorithmsParams TEXT NOT NULL, servingParams TEXT NOT NULL)""",
            """CREATE TABLE IF NOT EXISTS evaluationinstances (
                 id VARCHAR(64) PRIMARY KEY, status VARCHAR(32) NOT NULL,
                 startTime BIGINT NOT NULL, endTime BIGINT NOT NULL,
                 evaluationClass TEXT NOT NULL, engineParamsGeneratorClass TEXT NOT NULL,
                 batch TEXT NOT NULL, env TEXT NOT NULL, sparkConf TEXT NOT NULL,
                 evaluatorResults TEXT NOT NULL, evaluatorResultsHTML TEXT NOT NULL,
                 evaluatorResultsJSON TEXT NOT NULL)""",
            f"""CREATE TABLE IF NOT EXISTS models (
                 id VARCHAR(64) PRIMARY KEY, models {d.blob_type} NOT NULL)""",
        ]
        for statement in statements:
            self.execute(statement)

    def ensure_event_table(self, table: str) -> None:
        if table in self._initialized_event_tables:
            return
        self.execute(
            f"""CREATE TABLE IF NOT EXISTS {table} (
                 id VARCHAR(64) PRIMARY KEY, event TEXT NOT NULL,
                 entityType TEXT NOT NULL, entityId TEXT NOT NULL,
                 targetEntityType TEXT, targetEntityId TEXT, properties TEXT,
                 eventTime BIGINT NOT NULL, eventTimeZone VARCHAR(8) NOT NULL,
                 tags TEXT, prId TEXT,
                 creationTime BIGINT NOT NULL, creationTimeZone VARCHAR(8) NOT NULL)"""
        )
        try:
            self.execute(f"CREATE INDEX {table}_time ON {table} (eventTime)")
        except Exception:
            pass  # index exists (CREATE INDEX IF NOT EXISTS isn't MySQL-portable)
        try:
            # tail-read index: the (creationTime, id) ordering contract of
            # base.event_seq_key, served by a range scan (find_after)
            self.execute(
                f"CREATE INDEX {table}_ctime ON {table} (creationTime, id)"
            )
        except Exception:
            pass
        # seed the version row so later bumps are a single UPDATE that can
        # join the data-write transaction (atomic data+stamp commit)
        try:
            self.execute(
                "INSERT INTO event_versions (tbl, version) VALUES (?, 0)", (table,)
            )
        except Exception as exc:
            if not self.is_integrity_error(exc):
                raise
        self._initialized_event_tables.add(table)

    _BUMP_SQL = "UPDATE event_versions SET version = version + 1 WHERE tbl = ?"

    def bump_event_version(self, table: str) -> None:
        """Standalone bump (table drop etc.). Data writes instead run
        ``_BUMP_SQL`` inside their own transaction so a crash can never
        commit data without the stamp change (the version row is seeded by
        ``ensure_event_table``, making the bump a plain UPDATE)."""
        update = self.dialect.sql(self._BUMP_SQL)
        with self._lock:
            cur = self._conn.cursor()
            try:
                cur.execute(update, (table,))
                if not cur.rowcount:
                    try:
                        cur.execute(
                            self.dialect.sql(
                                "INSERT INTO event_versions (tbl, version) VALUES (?, 1)"
                            ),
                            (table,),
                        )
                    except Exception as exc:
                        # concurrent writer won the first-bump race; re-UPDATE
                        if not self.is_integrity_error(exc):
                            raise
                        self._conn.rollback()
                        cur = self._conn.cursor()
                        cur.execute(update, (table,))
                self._conn.commit()
            except Exception:
                self._conn.rollback()
                raise

    def event_version(self, table: str) -> int:
        rows = self.query("SELECT version FROM event_versions WHERE tbl = ?", (table,))
        return rows[0][0] if rows else 0

    # DAO accessors used by registry reflection
    def l_events(self) -> "SQLLEvents":
        return SQLLEvents(self)

    def p_events(self) -> "SQLPEvents":
        return SQLPEvents(self)

    def apps(self) -> "SQLApps":
        return SQLApps(self)

    def access_keys(self) -> "SQLAccessKeys":
        return SQLAccessKeys(self)

    def channels(self) -> "SQLChannels":
        return SQLChannels(self)

    def engine_instances(self) -> "SQLEngineInstances":
        return SQLEngineInstances(self)

    def evaluation_instances(self) -> "SQLEvaluationInstances":
        return SQLEvaluationInstances(self)

    def models(self) -> "SQLModels":
        return SQLModels(self)


class PostgresStorageClient(SQLStorageClient):
    """Type name ``postgres`` (ref jdbc driver with a PostgreSQL URL)."""

    def __init__(self, config: dict | None = None):
        super().__init__(config, type_name="postgres")


class MySQLStorageClient(SQLStorageClient):
    """Type name ``mysql`` (ref jdbc driver with a MySQL URL)."""

    def __init__(self, config: dict | None = None):
        super().__init__(config, type_name="mysql")


_EVENT_COLS = (
    "id, event, entityType, entityId, targetEntityType, targetEntityId, "
    "properties, eventTime, eventTimeZone, tags, prId, creationTime, creationTimeZone"
)


def _find_clauses(
    start_time,
    until_time,
    entity_type,
    entity_id,
    event_names,
    target_entity_type=...,
    target_entity_id=...,
) -> tuple[list[str], list]:
    """The 9-filter WHERE builder shared by the row scan and the
    partitioned bulk scan (``...`` = filter absent for the target fields,
    None = IS NULL — the reference's Option[Option[String]] semantics)."""
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
    return clauses, params


class SQLLEvents(base.LEvents):
    """Row-level event DAO (ref ``JDBCLEvents.scala``)."""

    def __init__(self, client: SQLStorageClient):
        self._c = client

    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        self._c.ensure_event_table(_event_table(app_id, channel_id))
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
        table = _event_table(app_id, channel_id)
        self._c.ensure_event_table(table)
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
                    json.dumps(list(event.tags)),
                    event.pr_id,
                    _micros(event.creation_time),
                    _offset_of(event.creation_time),
                )
            )
        # one transaction for the whole batch: bulk delete of colliding ids
        # then executemany insert — not a commit per event
        placeholders = ",".join("?" * 13)
        insert_sql = self._c.dialect.sql(
            f"INSERT INTO {table} ({_EVENT_COLS}) VALUES ({placeholders})"
        )
        with self._c._lock:
            cur = self._c._conn.cursor()
            try:
                for chunk_start in range(0, len(ids), 500):
                    chunk = ids[chunk_start : chunk_start + 500]
                    id_ph = ",".join("?" for _ in chunk)
                    cur.execute(
                        self._c.dialect.sql(
                            f"DELETE FROM {table} WHERE id IN ({id_ph})"
                        ),
                        tuple(chunk),
                    )
                cur.executemany(insert_sql, [tuple(r) for r in rows])
                # stamp bump rides the same commit: data can never land
                # without invalidating cached snapshots
                cur.execute(self._c.dialect.sql(self._c._BUMP_SQL), (table,))
                self._c._conn.commit()
            except Exception:
                self._c._conn.rollback()
                raise
        return ids

    @staticmethod
    def _row_to_event(row: tuple) -> Event:
        return Event(
            event=row[1],
            entity_type=row[2],
            entity_id=row[3],
            target_entity_type=row[4],
            target_entity_id=row[5],
            properties=DataMap.from_json(row[6] or "{}").fields,
            event_time=_from_micros(row[7], row[8]),
            event_id=row[0],
            tags=tuple(json.loads(row[9] or "[]")),
            pr_id=row[10],
            creation_time=_from_micros(row[11], row[12]),
        )

    def get(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> Event | None:
        table = _event_table(app_id, channel_id)
        self._c.ensure_event_table(table)
        rows = self._c.query(
            f"SELECT {_EVENT_COLS} FROM {table} WHERE id = ?", (event_id,)
        )
        return self._row_to_event(rows[0]) if rows else None

    def delete(self, event_id: str, app_id: int, channel_id: int | None = None) -> bool:
        table = _event_table(app_id, channel_id)
        self._c.ensure_event_table(table)
        with self._c._lock:
            cur = self._c._conn.cursor()
            try:
                cur.execute(
                    self._c.dialect.sql(f"DELETE FROM {table} WHERE id = ?"),
                    (event_id,),
                )
                deleted = cur.rowcount > 0
                if deleted:
                    cur.execute(self._c.dialect.sql(self._c._BUMP_SQL), (table,))
                self._c._conn.commit()
            except Exception:
                self._c._conn.rollback()
                raise
        return deleted

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
        self._c.ensure_event_table(table)
        clauses, params = _find_clauses(
            start_time,
            until_time,
            entity_type,
            entity_id,
            event_names,
            target_entity_type,
            target_entity_id,
        )
        where = f" WHERE {' AND '.join(clauses)}" if clauses else ""
        order = "DESC" if reversed else "ASC"
        statement = f"SELECT {_EVENT_COLS} FROM {table}{where} ORDER BY eventTime {order}"
        if limit is not None and limit >= 0:
            statement += f" LIMIT {int(limit)}"
        # streamed: bounded memory even on multi-million-row scans
        return (self._row_to_event(r) for r in self._c.query_iter(statement, params))

    def find_after(
        self,
        app_id: int,
        channel_id: int | None = None,
        cursor: tuple[int, str] | None = None,
        limit: int = 100,
    ) -> list[Event]:
        """Indexed tail read on ``(creationTime, id)`` (see
        ``ensure_event_table``'s ``_ctime`` index) — the ordering contract
        of ``base.event_seq_key`` executed server-side."""
        limit = base.check_tail_limit(limit)
        table = _event_table(app_id, channel_id)
        self._c.ensure_event_table(table)
        where, params = "", []
        if cursor is not None:
            where = " WHERE creationTime > ? OR (creationTime = ? AND id > ?)"
            params = [int(cursor[0]), int(cursor[0]), str(cursor[1])]
        statement = (
            f"SELECT {_EVENT_COLS} FROM {table}{where} "
            f"ORDER BY creationTime, id LIMIT {limit}"
        )
        return [self._row_to_event(r) for r in self._c.query(statement, params)]

    def seq_head(
        self, app_id: int, channel_id: int | None = None
    ) -> tuple[int, str] | None:
        table = _event_table(app_id, channel_id)
        self._c.ensure_event_table(table)
        rows = self._c.query(
            f"SELECT creationTime, id FROM {table} "
            "ORDER BY creationTime DESC, id DESC LIMIT 1"
        )
        return (int(rows[0][0]), str(rows[0][1])) if rows else None


class SQLPEvents(base.PEvents):
    """Bulk/columnar event DAO (ref ``JDBCPEvents.scala``).

    The bulk path mirrors the reference's JdbcRDD time-range partitioning
    (``JDBCPEvents.scala:91-121``; default partition count 4, ``:53-55``):
    ``find_partitioned`` splits ``[min(eventTime), max(eventTime)]`` into N
    ranges and scans each on its OWN database connection — the reference
    opens one JDBC connection per Spark partition the same way. The
    columnar train feed reads through the threaded merge of those
    partitions; the snapshot cache canonicalizes row order + encoding
    afterward, so merge nondeterminism never leaks.

    Partition count: storage-source config ``PARTITIONS`` or env
    ``PIO_SQL_SCAN_PARTITIONS``, default 4. Single-connection stores that
    cannot open a second session to the same data (sqlite ``:memory:``)
    fall back to one partition automatically.
    """

    def __init__(self, client: SQLStorageClient):
        self._c = client
        self._l = SQLLEvents(client)
        import os

        raw = client.config.get("PARTITIONS") or os.environ.get(
            "PIO_SQL_SCAN_PARTITIONS", "4"
        )
        try:
            self._partitions = max(1, int(raw))
        except ValueError:
            self._partitions = 4

    def find(self, app_id: int, channel_id: int | None = None, **kw) -> Iterator[Event]:
        return self._l.find(app_id, channel_id, **kw)

    # -- partitioned bulk scan ---------------------------------------------

    def _can_partition(self, table: str) -> bool:
        """Partitioned scans need a SECOND connection that sees the same
        data — true for server databases and file-backed sqlite, false for
        ``:memory:`` stores where every connect() opens a fresh empty
        database. Probed once per table (a fresh connection must see the
        event table) rather than guessed from config. The configured
        default partition count is NOT consulted here: an explicit
        ``n_partitions`` argument must win over the config default, so
        count gating belongs to the callers."""
        cache = getattr(self._c, "_partition_probe", None)
        if cache is None:
            cache = self._c._partition_probe = {}
        if table not in cache:
            try:
                conn = self._c._connect()
                try:
                    cur = conn.cursor()
                    # existence probe, O(1) — COUNT(*) would full-scan a 20M
                    # row table on Postgres just to prove visibility
                    cur.execute(
                        self._c.dialect.sql(f"SELECT 1 FROM {table} LIMIT 1")
                    )
                    cur.fetchone()
                    cache[table] = True
                finally:
                    conn.close()
            except Exception as exc:
                # do NOT cache: a transient failure (server blip, connection
                # limit) must not silently downgrade every later bulk scan
                # of this table to serial for the process lifetime — the
                # next scan re-probes. Only a successful probe is sticky.
                logger.warning(
                    "partition probe for %s failed (scanning serial this "
                    "time): %s", table, exc
                )
                return False
        return cache[table]

    def find_partitioned(
        self,
        app_id: int,
        channel_id: int | None = None,
        n_partitions: int | None = None,
        **filters,
    ) -> list[Iterator[Event]]:
        """N iterators over disjoint eventTime ranges whose union is exactly
        the serial scan's row set (ref ``JDBCPEvents.scala:91-121``)."""
        table = _event_table(app_id, channel_id)
        self._c.ensure_event_table(table)
        n = n_partitions or self._partitions
        unknown = set(filters) - self._PARTITION_FILTERS
        if unknown:
            # a silently-dropped limit/reversed would return a DIFFERENT row
            # set than the serial scan honoring it — refuse loudly instead
            raise TypeError(
                f"find_partitioned cannot honor filters {sorted(unknown)}; "
                f"supported: {sorted(self._PARTITION_FILTERS)} (use find() for "
                "limit/reversed)"
            )
        clauses, params = _find_clauses(**{
            "start_time": filters.get("start_time"),
            "until_time": filters.get("until_time"),
            "entity_type": filters.get("entity_type"),
            "entity_id": filters.get("entity_id"),
            "event_names": filters.get("event_names"),
            "target_entity_type": filters.get("target_entity_type", ...),
            "target_entity_id": filters.get("target_entity_id", ...),
        })
        where = f" WHERE {' AND '.join(clauses)}" if clauses else ""
        bounds = self._c.query(
            f"SELECT MIN(eventTime), MAX(eventTime) FROM {table}{where}", params
        )[0]
        if bounds[0] is None or n <= 1 or not self._can_partition(table):
            return [self._l.find(app_id, channel_id, **filters)]
        lo, hi = int(bounds[0]), int(bounds[1]) + 1  # [lo, hi) covers all
        edges = [lo + (hi - lo) * i // n for i in range(n + 1)]
        sql = self._c.dialect.sql(
            f"SELECT {_EVENT_COLS} FROM {table}{where}"
            f"{' AND' if clauses else ' WHERE'} eventTime >= ? AND eventTime < ?"
            " ORDER BY eventTime ASC"
        )

        def scan_range(p_lo: int, p_hi: int) -> Iterator[Event]:
            # fresh connection per partition: concurrent range scans must
            # not serialize on the client's shared-connection lock
            conn = self._c._connect()
            try:
                # server-side (named) cursor where the dialect has one
                # (postgres): a client-side cursor materializes the WHOLE
                # partition at execute() — at ML-20M / 4 partitions that is
                # ~5M rows held per partition, the exact OOM query_iter's
                # streaming exists to avoid (same rationale, :233-240)
                cur = None
                if self._c.dialect.use_returning:
                    try:
                        cur = conn.cursor(name=f"pio_part_{uuid.uuid4().hex[:8]}")
                    except TypeError:
                        cur = None
                if cur is None:
                    cur = conn.cursor()
                cur.execute(sql, tuple(params) + (p_lo, p_hi))
                while True:
                    rows = cur.fetchmany(10_000)
                    if not rows:
                        break
                    for r in rows:
                        yield SQLLEvents._row_to_event(tuple(r))
            finally:
                conn.close()

        return [
            scan_range(edges[i], edges[i + 1])
            for i in range(n)
            if edges[i] < edges[i + 1]
        ]

    def find_parallel(
        self,
        app_id: int,
        channel_id: int | None = None,
        n_partitions: int | None = None,
        **filters,
    ) -> Iterator[Event]:
        """Threaded merge of the time-range partitions (nondeterministic
        order; bulk consumers are order-free)."""
        return base.merge_parallel_scans(
            self.find_partitioned(app_id, channel_id, n_partitions, **filters)
        )

    _PARTITION_FILTERS = frozenset(
        (
            "start_time",
            "until_time",
            "entity_type",
            "entity_id",
            "event_names",
            "target_entity_type",
            "target_entity_id",
        )
    )
    _COLUMNAR_OWN_KW = frozenset(
        ("rating_key", "entity_vocab", "target_vocab", "events")
    )

    def to_columnar(self, app_id: int, channel_id: int | None = None, **kw):
        """Columnar ingest through the partitioned parallel scan when the
        filters allow it; serial otherwise (limit/reversed can't partition
        without changing semantics). The merged stream's nondeterministic
        order is erased by ``canonical_order`` before returning, so every
        consumer (exports, multi-host ingest, golden tests) sees the same
        rows, codes, and vocabs run-to-run."""
        filters = {k: v for k, v in kw.items() if k in self._PARTITION_FILTERS}
        unpartitionable = set(kw) - self._PARTITION_FILTERS - self._COLUMNAR_OWN_KW
        table = _event_table(app_id, channel_id)
        self._c.ensure_event_table(table)
        # cheap gates first; the second-connection probe involves a real
        # connect and only matters when partitioning is otherwise possible
        if (
            "events" not in kw
            and not unpartitionable
            and self._partitions > 1
            and self._can_partition(table)
        ):
            kw = {k: v for k, v in kw.items() if k not in self._PARTITION_FILTERS}
            kw["events"] = self.find_parallel(app_id, channel_id, **filters)
            return base.canonical_order(
                super().to_columnar(app_id, channel_id, **kw),
                frozen_entity_vocab=kw.get("entity_vocab") is not None,
                frozen_target_vocab=kw.get("target_vocab") is not None,
            )
        return super().to_columnar(app_id, channel_id, **kw)

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
        self._c.ensure_event_table(table)
        # chunked DELETE ... IN plus the stamp bump in ONE transaction — not
        # a round trip per event, and no crash window between data and stamp
        with self._c._lock:
            cur = self._c._conn.cursor()
            try:
                for chunk_start in range(0, len(ids), 500):
                    chunk = ids[chunk_start : chunk_start + 500]
                    placeholders = ",".join("?" for _ in chunk)
                    cur.execute(
                        self._c.dialect.sql(
                            f"DELETE FROM {table} WHERE id IN ({placeholders})"
                        ),
                        tuple(chunk),
                    )
                cur.execute(self._c.dialect.sql(self._c._BUMP_SQL), (table,))
                self._c._conn.commit()
            except Exception:
                self._c._conn.rollback()
                raise

    def version_stamp(self, app_id: int, channel_id: int | None = None) -> str | None:
        table = _event_table(app_id, channel_id)
        self._c.ensure_event_table(table)
        version = self._c.event_version(table)
        count = self._c.query(f"SELECT COUNT(*) FROM {table}")[0][0]
        return f"v{version}:{count}"

    def store_identity(self) -> str | None:
        return self._c.store_identity


class SQLApps(base.Apps):
    def __init__(self, client: SQLStorageClient):
        self._c = client

    def insert(self, app: App) -> int | None:
        try:
            if app.id:
                self._c.execute(
                    "INSERT INTO apps (id, name, description) VALUES (?,?,?)",
                    (app.id, app.name, app.description),
                )
                return app.id
            return self._c.insert_returning_id(
                "INSERT INTO apps (name, description) VALUES (?,?)",
                (app.name, app.description),
            )
        except Exception as exc:
            if self._c.is_integrity_error(exc):
                return None
            raise

    def get(self, app_id: int) -> App | None:
        rows = self._c.query(
            "SELECT id, name, description FROM apps WHERE id=?", (app_id,)
        )
        return App(*rows[0]) if rows else None

    def get_by_name(self, name: str) -> App | None:
        rows = self._c.query(
            "SELECT id, name, description FROM apps WHERE name=?", (name,)
        )
        return App(*rows[0]) if rows else None

    def get_all(self) -> list[App]:
        return [
            App(*r)
            for r in self._c.query("SELECT id, name, description FROM apps ORDER BY id")
        ]

    def update(self, app: App) -> None:
        self._c.execute(
            "UPDATE apps SET name=?, description=? WHERE id=?",
            (app.name, app.description, app.id),
        )

    def delete(self, app_id: int) -> None:
        self._c.execute("DELETE FROM apps WHERE id=?", (app_id,))


class SQLAccessKeys(base.AccessKeys):
    def __init__(self, client: SQLStorageClient):
        self._c = client

    def insert(self, k: AccessKey) -> str | None:
        key = k.key or base.generate_access_key()
        try:
            self._c.execute(
                "INSERT INTO accesskeys (accesskey, appid, events) VALUES (?,?,?)",
                (key, k.appid, json.dumps(list(k.events))),
            )
            return key
        except Exception as exc:
            if self._c.is_integrity_error(exc):
                return None
            raise

    @staticmethod
    def _row(r: tuple) -> AccessKey:
        return AccessKey(r[0], r[1], tuple(json.loads(r[2] or "[]")))

    def get(self, key: str) -> AccessKey | None:
        rows = self._c.query(
            "SELECT accesskey, appid, events FROM accesskeys WHERE accesskey=?", (key,)
        )
        return self._row(rows[0]) if rows else None

    def get_all(self) -> list[AccessKey]:
        return [
            self._row(r)
            for r in self._c.query("SELECT accesskey, appid, events FROM accesskeys")
        ]

    def get_by_app_id(self, app_id: int) -> list[AccessKey]:
        return [
            self._row(r)
            for r in self._c.query(
                "SELECT accesskey, appid, events FROM accesskeys WHERE appid=?",
                (app_id,),
            )
        ]

    def update(self, k: AccessKey) -> None:
        self._c.execute(
            "UPDATE accesskeys SET appid=?, events=? WHERE accesskey=?",
            (k.appid, json.dumps(list(k.events)), k.key),
        )

    def delete(self, key: str) -> None:
        self._c.execute("DELETE FROM accesskeys WHERE accesskey=?", (key,))


class SQLChannels(base.Channels):
    def __init__(self, client: SQLStorageClient):
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
            return self._c.insert_returning_id(
                "INSERT INTO channels (name, appid) VALUES (?,?)",
                (channel.name, channel.appid),
            )
        except Exception as exc:
            if self._c.is_integrity_error(exc):
                return None
            raise

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


class SQLEngineInstances(base.EngineInstances):
    def __init__(self, client: SQLStorageClient):
        self._c = client

    def insert(self, i: EngineInstance) -> str:
        iid = i.id or uuid.uuid4().hex
        i.id = iid
        self._c.upsert(
            "engineinstances",
            "id",
            iid,
            f"INSERT INTO engineinstances ({_EI_COLS}) "
            f"VALUES ({','.join('?' * 15)})",
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
        return [
            self._row(r)
            for r in self._c.query(f"SELECT {_EI_COLS} FROM engineinstances")
        ]

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


class SQLEvaluationInstances(base.EvaluationInstances):
    def __init__(self, client: SQLStorageClient):
        self._c = client

    def insert(self, i: EvaluationInstance) -> str:
        iid = i.id or uuid.uuid4().hex
        i.id = iid
        self._c.upsert(
            "evaluationinstances",
            "id",
            iid,
            f"INSERT INTO evaluationinstances ({_EVI_COLS}) "
            f"VALUES ({','.join('?' * 12)})",
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


class SQLModels(base.Models):
    def __init__(self, client: SQLStorageClient):
        self._c = client

    def insert(self, model: Model) -> None:
        blob = model.models
        binary = getattr(self._c._mod, "Binary", None)
        if binary is not None:
            blob = binary(blob)
        self._c.upsert(
            "models",
            "id",
            model.id,
            "INSERT INTO models (id, models) VALUES (?,?)",
            (model.id, blob),
        )

    def get(self, model_id: str) -> Model | None:
        rows = self._c.query("SELECT id, models FROM models WHERE id=?", (model_id,))
        if not rows:
            return None
        blob = rows[0][1]
        return Model(rows[0][0], bytes(blob))

    def delete(self, model_id: str) -> None:
        self._c.execute("DELETE FROM models WHERE id=?", (model_id,))
