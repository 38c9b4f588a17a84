"""The port's storage layer (``predictionio_tpu_torch/data/storage``,
``data/store``): the JAX package's DAO contract tests (tests/test_storage.py,
ref per-backend LEventsSpec/PEventsSpec and the metadata DAO specs) run
against the port's memory, sqlite and jsonl backends; then the parts that
bind the two packages: a sqlite file written by either package reads the
same in the other (columnar reads, entity reads, event-time offsets), the
registry's port-only rules, sqlite under threads with another process
reading, and the columnar snapshot cache."""

import datetime as dt
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

pytest.importorskip("torch")

from predictionio_tpu_torch.data.event import Event  # noqa: E402
from predictionio_tpu_torch.data.storage.base import (  # noqa: E402
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EngineInstanceStatus,
    EvaluationInstance,
    EvaluationInstanceStatus,
    Model,
)
from predictionio_tpu_torch.data.storage.jsonl import JSONLStorageClient  # noqa: E402
from predictionio_tpu_torch.data.storage.memory import MemoryStorageClient  # noqa: E402
from predictionio_tpu_torch.data.storage.registry import Storage, StorageError  # noqa: E402
from predictionio_tpu_torch.data.storage.sqlite import SQLiteStorageClient  # noqa: E402

UTC = dt.timezone.utc
APP = 7
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sql_client(tmp_path):
    """The generic DB-API driver through sqlite3's module: the code path
    postgres and mysql take, without a server."""
    from predictionio_tpu_torch.data.storage.sql import SQLStorageClient

    return SQLStorageClient({"MODULE": "sqlite3", "CONNECT_ARGS": {"database": str(tmp_path / "s.db")}})


def _fake_dialect_client(tmp_path, module_name):
    """The postgres / mysql dialects (placeholder rewriting, RETURNING id,
    named cursors, their DDL types) over tests/fake_dbapi.py's shims."""
    from predictionio_tpu_torch.data.storage.sql import SQLStorageClient
    from tests.fake_dbapi import install

    install()
    return SQLStorageClient({
        "MODULE": module_name,
        "DIALECT": "postgres" if "psycopg" in module_name else "mysql",
        "CONNECT_ARGS": {"database": str(tmp_path / f"{module_name}.db")},
    })


def _es_client():
    """The REST driver against tests/es_mock.py served in this process."""
    from predictionio_tpu_torch.data.storage.elasticsearch import ESStorageClient
    from tests.es_mock import make_server

    server, url = make_server()
    client = ESStorageClient({"URL": url})
    client._mock_server = server
    return client


def _make_client(param, tmp_path):
    if param == "memory":
        return MemoryStorageClient()
    if param == "sqlite":
        return SQLiteStorageClient({"PATH": str(tmp_path / "t.db")})
    if param == "jsonl":
        return JSONLStorageClient({"PATH": str(tmp_path / "events")})
    if param == "sql":
        return _sql_client(tmp_path)
    if param == "sql_postgres":
        return _fake_dialect_client(tmp_path, "fake_psycopg2")
    if param == "sql_mysql":
        return _fake_dialect_client(tmp_path, "fake_pymysql")
    if param == "elasticsearch":
        return _es_client()
    raise ValueError(param)


def _cleanup_client(c):
    server = getattr(c, "_mock_server", None)
    if server is not None:
        server.shutdown()
        server.server_close()


EVENT_BACKENDS = ["memory", "sqlite", "jsonl", "sql", "sql_postgres", "sql_mysql", "elasticsearch"]
META_BACKENDS = ["memory", "sqlite", "sql", "sql_postgres", "sql_mysql", "elasticsearch"]


@pytest.fixture(params=EVENT_BACKENDS)
def client(request, tmp_path):
    c = _make_client(request.param, tmp_path)
    yield c
    _cleanup_client(c)


@pytest.fixture(params=META_BACKENDS)
def meta_client(request, tmp_path):
    c = _make_client(request.param, tmp_path)
    yield c
    _cleanup_client(c)


def t(n):
    return dt.datetime(2024, 1, 1, 0, 0, n, tzinfo=UTC)


def ev(name="rate", eid="u1", target=None, n=0, props=None):
    return Event(
        event=name,
        entity_type="user",
        entity_id=eid,
        target_entity_type="item" if target else None,
        target_entity_id=target,
        properties=dict(props or {}),
        event_time=t(n),
    )


# ---------------------------------------------------------------------------
# LEvents contract
# ---------------------------------------------------------------------------


class TestLEvents:
    def test_insert_get_delete(self, client):
        l = client.l_events()
        l.init(APP)
        eid = l.insert(ev(), APP)
        got = l.get(eid, APP)
        assert got is not None and got.event == "rate" and got.event_id == eid
        assert l.delete(eid, APP) is True
        assert l.get(eid, APP) is None
        assert l.delete(eid, APP) is False

    def test_find_ordering_and_reverse(self, client):
        l = client.l_events()
        l.init(APP)
        for n in (3, 1, 2):
            l.insert(ev(n=n, eid=f"u{n}"), APP)
        found = list(l.find(APP))
        assert [e.entity_id for e in found] == ["u1", "u2", "u3"]
        rev = list(l.find(APP, reversed=True))
        assert [e.entity_id for e in rev] == ["u3", "u2", "u1"]

    def test_find_time_window(self, client):
        l = client.l_events()
        l.init(APP)
        for n in range(5):
            l.insert(ev(n=n, eid=f"u{n}"), APP)
        found = list(l.find(APP, start_time=t(1), until_time=t(3)))
        assert [e.entity_id for e in found] == ["u1", "u2"]  # until exclusive

    def test_find_filters(self, client):
        l = client.l_events()
        l.init(APP)
        l.insert(ev("view", "u1", target="i1", n=1), APP)
        l.insert(ev("buy", "u1", target="i2", n=2), APP)
        l.insert(ev("view", "u2", target="i1", n=3), APP)
        l.insert(ev("$set", "u2", n=4, props={"a": 1}), APP)
        assert len(list(l.find(APP, event_names=["view"]))) == 2
        assert len(list(l.find(APP, entity_id="u1"))) == 2
        assert len(list(l.find(APP, target_entity_id="i1"))) == 2
        # tri-state: None means target must be absent
        assert len(list(l.find(APP, target_entity_id=None))) == 1
        assert len(list(l.find(APP, limit=2))) == 2

    def test_channels_isolated(self, client):
        l = client.l_events()
        l.init(APP)
        l.init(APP, 5)
        l.insert(ev(eid="main"), APP)
        l.insert(ev(eid="chan"), APP, 5)
        assert [e.entity_id for e in l.find(APP)] == ["main"]
        assert [e.entity_id for e in l.find(APP, 5)] == ["chan"]

    def test_apps_isolated(self, client):
        l = client.l_events()
        l.init(APP)
        l.init(APP + 1)
        l.insert(ev(), APP)
        assert list(l.find(APP + 1)) == []

    def test_properties_roundtrip(self, client):
        l = client.l_events()
        l.init(APP)
        props = {"rating": 4.5, "tags": ["a", "b"], "nested": {"x": 1}}
        eid = l.insert(ev(props=props), APP)
        got = l.get(eid, APP)
        assert got.properties == props

    def test_aggregate_properties(self, client):
        l = client.l_events()
        l.init(APP)
        l.insert(ev("$set", "u1", n=1, props={"a": 1}), APP)
        l.insert(ev("$set", "u1", n=2, props={"b": 2}), APP)
        l.insert(ev("$delete", "u2", n=1), APP)
        result = l.aggregate_properties(APP, entity_type="user")
        assert result["u1"].fields == {"a": 1, "b": 2}
        assert "u2" not in result

    def test_insert_batch(self, client):
        l = client.l_events()
        l.init(APP)
        ids = l.insert_batch([ev(eid=f"u{i}", n=i) for i in range(10)], APP)
        assert len(ids) == len(set(ids)) == 10
        assert len(list(l.find(APP))) == 10

    def test_remove(self, client):
        l = client.l_events()
        l.init(APP)
        l.insert(ev(), APP)
        l.remove(APP)
        assert list(l.find(APP)) == []


# ---------------------------------------------------------------------------
# find_after: the (creation_time, id) tail-read ordering contract
# ---------------------------------------------------------------------------


def _cev(eid: str, *, n: int = 0, ct: dt.datetime):
    """Event with a controlled creation_time + event id (the tiebreak)."""
    return Event(
        event="rate",
        entity_type="user",
        entity_id="u1",
        event_time=t(n),
        event_id=eid,
        creation_time=ct,
    )


class TestFindAfter:
    """Every backend must honor base.event_seq_key's total order: creation
    time micros, event id as the tiebreak — a resumed tail never skips or
    double-reads an event that landed with an equal timestamp."""

    def test_equal_timestamp_paging_never_skips_or_dupes(self, client):
        from predictionio_tpu_torch.data.storage.base import event_seq_key

        l = client.l_events()
        l.init(APP)
        tie = t(5)
        # inserted in shuffled order; ids decide the order within the tie
        for eid, n in (("cb", 1), ("ca", 2), ("cd", 3), ("cc", 4)):
            l.insert(_cev(eid, n=n, ct=tie), APP)
        l.insert(_cev("za", n=9, ct=t(7)), APP)  # strictly later row
        seen: list[str] = []
        cursor = None
        while True:
            batch = l.find_after(APP, cursor=cursor, limit=1)
            if not batch:
                break
            assert len(batch) == 1
            seen.append(batch[0].event_id)
            cursor = event_seq_key(batch[0])
        assert seen == ["ca", "cb", "cc", "cd", "za"]

    def test_cursor_is_exclusive_and_limit_bounds(self, client):
        from predictionio_tpu_torch.data.storage.base import event_seq_key

        l = client.l_events()
        l.init(APP)
        tie = t(3)
        for eid in ("aa", "ab", "ac"):
            l.insert(_cev(eid, ct=tie), APP)
        first = l.find_after(APP, cursor=None, limit=2)
        assert [e.event_id for e in first] == ["aa", "ab"]
        rest = l.find_after(APP, cursor=event_seq_key(first[-1]), limit=50)
        assert [e.event_id for e in rest] == ["ac"]
        # an event landing LATER with the same creation timestamp but a
        # higher id is still picked up by the same cursor
        l.insert(_cev("zz", ct=tie), APP)
        more = l.find_after(APP, cursor=event_seq_key(rest[-1]), limit=50)
        assert [e.event_id for e in more] == ["zz"]
        assert l.find_after(APP, cursor=event_seq_key(more[-1]), limit=50) == []

    def test_negative_limit_rejected_on_every_backend(self, client):
        """find's 'negative = no cap' convention must NOT leak into the
        tail read: it would mean 'everything' on scan backends and
        LIMIT 0 (nothing, forever) on SQL — so it is an error everywhere."""
        l = client.l_events()
        l.init(APP)
        l.insert(_cev("aa", ct=t(1)), APP)
        with pytest.raises(ValueError):
            l.find_after(APP, cursor=None, limit=-1)

    def test_seq_head_matches_tail_order(self, client):
        from predictionio_tpu_torch.data.storage.base import event_seq_key

        l = client.l_events()
        l.init(APP)
        assert l.seq_head(APP) is None
        tie = t(4)
        for eid in ("ba", "bz", "bm"):
            l.insert(_cev(eid, ct=tie), APP)
        # head = max (creation, id): the id tiebreak decides within the tie
        head = l.seq_head(APP)
        assert head == (event_seq_key(_cev("bz", ct=tie))[0], "bz")
        assert l.find_after(APP, cursor=head, limit=10) == []


# ---------------------------------------------------------------------------
# PEvents contract + columnar export
# ---------------------------------------------------------------------------


class TestPEvents:
    def test_write_find(self, client):
        p = client.p_events()
        p.write([ev(eid=f"u{i}", n=i) for i in range(4)], APP)
        assert len(list(p.find(APP))) == 4

    def test_to_columnar(self, client):
        p = client.p_events()
        p.write(
            [
                ev("rate", "u1", target="i1", n=1, props={"rating": 4.0}),
                ev("rate", "u2", target="i1", n=2, props={"rating": 3.0}),
                ev("rate", "u1", target="i2", n=3, props={"rating": 5.0}),
                ev("view", "u2", target="i2", n=4),
            ],
            APP,
        )
        col = p.to_columnar(APP, event_names=["rate", "view"])
        assert len(col) == 4
        # vocab ORDER is driver-dependent (parallel bulk scans — ES sliced
        # scroll — merge nondeterministically); the contract is the decoded
        # (entity, target, event, rating) tuples
        assert sorted(col.entity_vocab) == ["u1", "u2"]
        assert sorted(col.target_vocab) == ["i1", "i2"]
        decoded = {
            (
                col.entity_vocab[col.entity_ids[i]],
                col.target_vocab[col.target_ids[i]],
                col.event_names[i],
                None if np.isnan(col.ratings[i]) else float(col.ratings[i]),
            )
            for i in range(4)
        }
        assert decoded == {
            ("u1", "i1", "rate", 4.0),
            ("u2", "i1", "rate", 3.0),
            ("u1", "i2", "rate", 5.0),
            ("u2", "i2", "view", None),
        }

    def test_to_columnar_frozen_vocab(self, client):
        p = client.p_events()
        p.write([ev("rate", "u1", target="i9", n=1, props={"rating": 1.0})], APP)
        col = p.to_columnar(
            APP, entity_vocab=["u0", "u1"], target_vocab=["i1"]
        )
        np.testing.assert_array_equal(col.entity_ids, [1])
        np.testing.assert_array_equal(col.target_ids, [-1])  # unknown item


# ---------------------------------------------------------------------------
# Metadata DAO contracts
# ---------------------------------------------------------------------------


class TestMetadata:
    def test_apps(self, meta_client):
        apps = meta_client.apps()
        aid = apps.insert(App(0, "myapp", "desc"))
        assert aid and apps.get(aid).name == "myapp"
        assert apps.get_by_name("myapp").id == aid
        assert apps.insert(App(0, "myapp")) is None  # duplicate name
        apps.update(App(aid, "myapp", "newdesc"))
        assert apps.get(aid).description == "newdesc"
        aid2 = apps.insert(App(0, "other"))
        assert aid2 != aid
        assert len(apps.get_all()) == 2
        apps.delete(aid)
        assert apps.get(aid) is None

    def test_access_keys(self, meta_client):
        keys = meta_client.access_keys()
        k = keys.insert(AccessKey("", 1, ("buy", "view")))
        assert k and len(k) > 20
        got = keys.get(k)
        assert got.appid == 1 and got.events == ("buy", "view")
        k2 = keys.insert(AccessKey("explicit", 2, ()))
        assert k2 == "explicit"
        assert {x.key for x in keys.get_by_app_id(1)} == {k}
        keys.delete(k)
        assert keys.get(k) is None

    def test_generated_key_is_cli_safe(self):
        # a key starting with "-" would be parsed as a flag by every CLI
        # that takes it as a positional (pio accesskey delete <key>); the
        # generator must never emit one (flaked ~1.6% of runs before)
        from predictionio_tpu_torch.data.storage.base import generate_access_key

        for _ in range(300):
            assert not generate_access_key().startswith("-")

    def test_channels(self, meta_client):
        ch = meta_client.channels()
        cid = ch.insert(Channel(0, "mobile", 1))
        assert cid and ch.get(cid).name == "mobile"
        assert ch.insert(Channel(0, "bad name!", 1)) is None
        assert ch.insert(Channel(0, "x" * 17, 1)) is None
        assert [c.id for c in ch.get_by_app_id(1)] == [cid]
        ch.delete(cid)
        assert ch.get(cid) is None

    def test_engine_instances(self, meta_client):
        eis = meta_client.engine_instances()

        def make(status, n):
            return EngineInstance(
                id="",
                status=status,
                start_time=t(n),
                end_time=t(n),
                engine_id="e1",
                engine_version="1",
                engine_variant="default",
                engine_factory="f",
            )

        i1 = eis.insert(make(EngineInstanceStatus.COMPLETED, 1))
        i2 = eis.insert(make(EngineInstanceStatus.COMPLETED, 5))
        eis.insert(make(EngineInstanceStatus.TRAINING, 9))
        latest = eis.get_latest_completed("e1", "1", "default")
        assert latest.id == i2
        assert eis.get_latest_completed("e1", "1", "other") is None
        inst = eis.get(i1)
        inst.status = EngineInstanceStatus.FAILED
        eis.update(inst)
        assert eis.get(i1).status == EngineInstanceStatus.FAILED
        assert len(eis.get_all()) == 3

    def test_evaluation_instances(self, meta_client):
        evis = meta_client.evaluation_instances()
        i1 = evis.insert(
            EvaluationInstance(
                id="",
                status=EvaluationInstanceStatus.EVALCOMPLETED,
                start_time=t(1),
                end_time=t(2),
                evaluator_results="ok",
            )
        )
        assert evis.get(i1).evaluator_results == "ok"
        assert [i.id for i in evis.get_completed()] == [i1]

    def test_models(self, meta_client):
        models = meta_client.models()
        models.insert(Model("abc", b"\x00\x01binary"))
        assert models.get("abc").models == b"\x00\x01binary"
        models.delete("abc")
        assert models.get("abc") is None


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


class TestRegistry:
    def test_env_wiring(self, tmp_path):
        storage = Storage(
            env={
                "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
                "PIO_STORAGE_SOURCES_SQL_PATH": str(tmp_path / "pio.db"),
                "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
                "PIO_STORAGE_SOURCES_FS_PATH": str(tmp_path / "models"),
                "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
                "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQL",
                "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS",
            }
        )
        storage.get_meta_data_apps().insert(App(0, "a"))
        storage.get_model_data_models().insert(Model("m1", b"blob"))
        assert (tmp_path / "models" / "pio_model_m1").exists()
        assert storage.verify_all_data_objects() == []

    def test_default_zero_config(self, tmp_path):
        storage = Storage(env={"PIO_FS_BASEDIR": str(tmp_path / "store")})
        assert storage.verify_all_data_objects() == []
        assert (tmp_path / "store" / "pio.db").exists()

    def test_missing_type_raises(self):
        with pytest.raises(StorageError):
            Storage(env={"PIO_STORAGE_SOURCES_X_PATH": "/tmp/x"})

    def test_undeclared_source_raises(self):
        with pytest.raises(StorageError):
            Storage(
                env={
                    "PIO_STORAGE_SOURCES_A_TYPE": "memory",
                    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "NOPE",
                }
            )



# ---------------------------------------------------------------------------
# Regressions from review/verification
# ---------------------------------------------------------------------------


class TestRegressions:
    def test_upsert_by_event_id_consistent(self, client):
        """Re-inserting an event with the same id must upsert, not duplicate."""
        l = client.l_events()
        l.init(APP)
        e = ev(props={"v": 1})
        eid = l.insert(e, APP)
        import dataclasses as dc

        l.insert(dc.replace(e, event_id=eid, properties={"v": 2}), APP)
        events = list(l.find(APP))
        assert len(events) == 1
        assert events[0].properties.get("v") == 2

    def test_naive_datetime_filters_mean_utc(self, client):
        l = client.l_events()
        l.init(APP)
        for n in range(4):
            l.insert(ev(n=n, eid=f"u{n}"), APP)
        naive_start = dt.datetime(2024, 1, 1, 0, 0, 2)  # no tzinfo
        found = list(l.find(APP, start_time=naive_start))
        assert [e.entity_id for e in found] == ["u2", "u3"]

    def test_duplicate_channel_id_returns_none(self, meta_client):
        ch = meta_client.channels()
        cid = ch.insert(Channel(0, "first", 1))
        assert ch.insert(Channel(cid, "second", 1)) is None




# ---------------------------------------------------------------------------
# the port's registry rules
# ---------------------------------------------------------------------------


def _backend_env(type_name, tmp_path):
    """A PIO_STORAGE_SOURCES_* environment naming ``type_name`` for source
    X: every repository on X, or only MODELDATA for the blob stores (s3,
    hdfs), whose events and metadata sit on memory."""
    cfg = {
        "postgres": {"MODULE": "fake_psycopg2", "DIALECT": "postgres", "CONNECT_ARGS": json.dumps({"database": str(tmp_path / "pg.db")})},
        "mysql": {"MODULE": "fake_pymysql", "DIALECT": "mysql", "CONNECT_ARGS": json.dumps({"database": str(tmp_path / "my.db")})},
        "sql": {"MODULE": "sqlite3", "CONNECT_ARGS": json.dumps({"database": str(tmp_path / "s.db")})},
        "s3": {"BUCKET_NAME": "b", "REGION": "eu-test-1", "ENDPOINT": "http://127.0.0.1:9",
               "ACCESS_KEY_ID": "AKID", "SECRET_ACCESS_KEY": "sk"},
        "hdfs": {"URL": "http://127.0.0.1:9", "PATH": "/pio_models"},
    }.get(type_name, {})
    env = {"PIO_STORAGE_SOURCES_X_TYPE": type_name, "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
           **{f"PIO_STORAGE_SOURCES_X_{k}": v for k, v in cfg.items()}}
    blob_only = type_name in ("s3", "hdfs")
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE"] = "MEM" if blob_only and repo != "MODELDATA" else "X"
    return env


@pytest.mark.parametrize("type_name", ["postgres", "mysql", "sql", "elasticsearch", "s3", "hdfs"])
def test_every_backend_type_of_the_jax_registry_resolves_to_a_port_client(type_name, tmp_path):
    """Each type the JAX registry knows resolves, through Storage and a
    PIO_STORAGE_SOURCES_* environment, to a client of the port under the
    JAX registry's class name, and its repositories hand out the port's
    DAOs."""
    from predictionio_tpu.data.storage.registry import _BACKENDS as JAX_BACKENDS
    from predictionio_tpu_torch.data.storage import base
    from tests.fake_dbapi import install

    install()
    env = _backend_env(type_name, tmp_path)
    server = None
    if type_name == "elasticsearch":
        from tests.es_mock import make_server

        server, env["PIO_STORAGE_SOURCES_X_URL"] = make_server()
    try:
        storage = Storage(env=env)
        models = storage.get_model_data_models()
        client = storage._client("X")
        assert type(client).__name__ == JAX_BACKENDS[type_name][1]
        assert type(client).__module__ == JAX_BACKENDS[type_name][0].replace(
            "predictionio_tpu.", "predictionio_tpu_torch.")
        assert isinstance(models, base.Models)
        if type_name not in ("s3", "hdfs"):
            app_id = storage.get_meta_data_apps().insert(App(0, f"{type_name}app"))
            levents = storage.get_l_events()
            levents.init(app_id)
            eid = levents.insert(ev(), app_id)
            assert levents.get(eid, app_id).event == "rate"
            models.insert(Model("m1", b"\x00blob"))
            assert models.get("m1").models == b"\x00blob"
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()


def test_a_missing_postgres_driver_is_a_storage_error_naming_it(monkeypatch):
    """Without psycopg2 (and psycopg), the postgres type fails at connect
    with a StorageError that names the driver; nothing is installed."""
    for mod in ("psycopg2", "psycopg"):
        monkeypatch.setitem(sys.modules, mod, None)  # importing it raises ImportError
    storage = Storage(env={
        "PIO_STORAGE_SOURCES_PGSQL_TYPE": "postgres",
        **{f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "PGSQL" for r in ("METADATA", "EVENTDATA", "MODELDATA")},
    })
    with pytest.raises(StorageError, match="psycopg2"):
        storage.get_meta_data_apps()


def test_default_basedir_is_the_ports_own(tmp_path):
    """Zero-config sqlite lands under $PIO_TORCH_HOME (or ~/.pio_torch),
    never in the JAX package's ~/.pio_store; $PIO_FS_BASEDIR wins."""
    Storage(env={"PIO_TORCH_HOME": str(tmp_path / "torch_home")}).get_meta_data_apps()
    assert (tmp_path / "torch_home" / "pio.db").exists()
    Storage(env={"PIO_TORCH_HOME": str(tmp_path / "torch_home"),
                 "PIO_FS_BASEDIR": str(tmp_path / "fs")}).get_meta_data_apps()
    assert (tmp_path / "fs" / "pio.db").exists()
    from predictionio_tpu_torch.data.storage.registry import default_basedir

    home = default_basedir({})
    assert home.endswith(".pio_torch") and ".pio_store" not in home


# ---------------------------------------------------------------------------
# one sqlite file, two packages
# ---------------------------------------------------------------------------


def _sqlite_env(path):
    return {
        "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_DB_PATH": str(path),
        **{f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "DB" for r in ("METADATA", "EVENTDATA", "MODELDATA")},
    }


def _wire_events(seed=0, n=300):
    """Seeded rate/buy/view/$set events with several time zones, ties in
    event time, and ratings that are ints, floats, strings and absent."""
    rng = np.random.default_rng(seed)
    zones = ["Z", "+08:00", "-05:30", "+00:00"]
    out = []
    for k in range(n):
        name = str(rng.choice(["rate", "rate", "buy", "view", "$set"]))
        t = dt.datetime(2024, 2, 1, tzinfo=UTC) + dt.timedelta(seconds=int(k // 3 * 7))
        zone = zones[k % len(zones)]
        tz = UTC if zone in ("Z", "+00:00") else dt.timezone(
            dt.timedelta(hours=int(zone[1:3]), minutes=int(zone[4:6])) * (1 if zone[0] == "+" else -1))
        ev = {"event": name, "entityType": "user", "entityId": f"u{int(rng.integers(25))}",
              "eventTime": t.astimezone(tz).isoformat(timespec="milliseconds")}
        if name == "$set":
            ev["properties"] = {"a": int(rng.integers(9))}
        else:
            ev.update(targetEntityType="item", targetEntityId=f"i{int(rng.integers(40))}")
            r = rng.integers(4)
            if name == "rate":
                ev["properties"] = {"rating": [1, 2.5, "4", None][r]} if r < 3 else {}
        out.append(ev)
    return out


def _write_with(package, path, wire):
    """Write ``wire`` into a sqlite file through ``package``'s Storage and
    import_events; returns the app id."""
    if package == "jax":
        from predictionio_tpu.data.storage.base import App as A
        from predictionio_tpu.data.storage.registry import Storage as S
        from predictionio_tpu.tools.import_export import import_events
    else:
        from predictionio_tpu_torch.data.storage.base import App as A
        from predictionio_tpu_torch.data.storage.registry import Storage as S
        from predictionio_tpu_torch.tools.import_export import import_events
    storage = S(env=_sqlite_env(path))
    app_id = storage.get_meta_data_apps().insert(A(0, "xapp"))
    src = path.parent / "wire.jsonl"
    src.write_text("".join(json.dumps(d) + "\n" for d in wire))
    import_events(str(src), "xapp", storage=storage)
    return app_id


def _columnar_fields(cols):
    return (cols.event_ids, cols.event_names, cols.entity_vocab, cols.target_vocab,
            cols.event_vocab, cols.entity_ids.tolist(), cols.target_ids.tolist(),
            cols.event_codes.tolist(), cols.timestamps.tolist(),
            np.nan_to_num(cols.ratings, nan=-7.0).tolist())


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kw", [
    {}, {"event_names": ["rate", "buy"], "entity_type": "user", "target_entity_type": "item"},
    {"event_names": ["rate"], "rating_key": "rating"},
], ids=["all", "template-read", "rate-only"])
def test_sqlite_written_by_either_package_gives_identical_columnar_reads(tmp_path, writer, kw):
    from predictionio_tpu.data.storage.registry import Storage as JaxStorage
    from predictionio_tpu.data.store.event_store import PEventStore as JaxPEventStore
    from predictionio_tpu_torch.data.store.event_store import PEventStore

    path = tmp_path / "shared.db"
    _write_with(writer, path, _wire_events(seed=1))
    want = JaxPEventStore(JaxStorage(env=_sqlite_env(path))).to_columnar("xapp", **kw)
    got = PEventStore(Storage(env=_sqlite_env(path))).to_columnar("xapp", **kw)
    assert len(got) > 100
    assert _columnar_fields(got) == _columnar_fields(want)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sqlite_written_by_either_package_gives_identical_entity_reads(tmp_path, writer):
    from predictionio_tpu.data.storage.registry import Storage as JaxStorage
    from predictionio_tpu.data.store.event_store import LEventStore as JaxLEventStore
    from predictionio_tpu_torch.data.store.event_store import LEventStore

    path = tmp_path / "shared.db"
    _write_with(writer, path, _wire_events(seed=2))
    jax_store = JaxLEventStore(JaxStorage(env=_sqlite_env(path)))
    port_store = LEventStore(Storage(env=_sqlite_env(path)))
    for user in ("u0", "u3", "u17", "nobody"):
        for kw in ({}, {"event_names": ["rate"], "limit": 3}, {"latest": False},
                   {"target_entity_type": None}):
            want = [e.to_json_dict() for e in jax_store.find_by_entity("xapp", "user", user, **kw)]
            got = [e.to_json_dict() for e in port_store.find_by_entity("xapp", "user", user, **kw)]
            assert got == want


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"), ("port", "port")])
def test_event_time_offset_round_trips(tmp_path, writer, reader):
    """An event posted at +08:00 (or -05:30) comes back at that offset."""
    from predictionio_tpu.data.storage.registry import Storage as JaxStorage

    path = tmp_path / "tz.db"
    wire = [{"event": "view", "entityType": "user", "entityId": "u1", "targetEntityType": "item",
             "targetEntityId": f"i{k}", "eventTime": t}
            for k, t in enumerate(["2024-03-01T08:00:00.123+08:00", "2024-03-01T08:00:00.000-05:30",
                                   "2024-03-01T08:00:00.000Z"])]
    app_id = _write_with(writer, path, wire)
    storage = (JaxStorage if reader == "jax" else Storage)(env=_sqlite_env(path))
    got = sorted(e.to_json_dict()["eventTime"] for e in storage.get_l_events().find(app_id))
    assert got == sorted(d["eventTime"] for d in wire)


def test_sqlite_serialises_threads_while_another_process_reads(tmp_path):
    """Eight threads insert through one client (the event server's shape)
    while a second process counts through its own connection: no write is
    lost, nothing raises, and the reader sees a growing table."""
    path = tmp_path / "busy.db"
    storage = Storage(env=_sqlite_env(path))
    app_id = storage.get_meta_data_apps().insert(App(0, "busy"))
    levents = storage.get_l_events()
    levents.init(app_id)
    reader = subprocess.Popen(
        [sys.executable, "-c", f"""
import sys, time
sys.path.insert(0, {REPO!r})
from predictionio_tpu_torch.data.storage.registry import Storage
s = Storage(env={_sqlite_env(path)!r})
p = s.get_p_events()
counts = []
for _ in range(40):
    counts.append(sum(1 for _ in p.find({app_id})))
    time.sleep(0.02)
print(counts[0], counts[-1])
"""],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    errors = []

    def writer(w):
        try:
            for k in range(150):
                levents.insert(Event("view", "user", f"w{w}", "item", f"i{k}"), app_id)
        except Exception as exc:  # noqa: BLE001 - the assertion below reports it
            errors.append(exc)

    threads = [threading.Thread(target=writer, args=(w,)) for w in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    out, err = reader.communicate(timeout=120)
    assert reader.returncode == 0, err
    assert errors == []
    assert len(list(storage.get_p_events().find(app_id))) == 8 * 150
    first, last = map(int, out.split())
    assert 0 <= first <= last <= 8 * 150


@pytest.mark.parametrize("backend", ["memory", "sqlite", "jsonl"])
def test_snapshot_cache_is_canonical_and_invalidated_by_a_write(tmp_path, backend):
    from predictionio_tpu_torch.data.storage.base import canonical_order
    from predictionio_tpu_torch.data.store.event_store import PEventStore
    from predictionio_tpu_torch.tools.import_export import import_events
    from torch_template_helpers import port_storage

    storage = port_storage(tmp_path, backend)
    app_id = storage.get_meta_data_apps().insert(App(0, "snap"))
    src = tmp_path / "w.jsonl"
    src.write_text("".join(json.dumps(d) + "\n" for d in _wire_events(seed=3, n=120)))
    import_events(str(src), "snap", storage=storage)
    store = PEventStore(storage)
    snap = tmp_path / "snaps"
    kw = dict(event_names=["rate", "buy"], entity_type="user", target_entity_type="item")
    first = store.to_columnar_cached("snap", snapshot_dir=str(snap), **kw)
    assert _columnar_fields(first) == _columnar_fields(
        canonical_order(store.to_columnar("snap", **kw)))
    assert first.entity_vocab == sorted(first.entity_vocab)
    assert _columnar_fields(store.to_columnar_cached("snap", snapshot_dir=str(snap), **kw)) == \
        _columnar_fields(first)
    storage.get_l_events().insert(Event("buy", "user", "zz-new", "item", "i0"), app_id)
    after = store.to_columnar_cached("snap", snapshot_dir=str(snap), **kw)
    assert len(after) == len(first) + 1 and "zz-new" in after.entity_vocab
