"""The port's bulk import and export (``predictionio_tpu_torch/tools/
import_export.py``): the JAX package's round-trip tests (ref
FileToEvents.scala:45-120, EventsToFile.scala:85-95, the json-or-parquet
switch) run against the port; a JSON-lines export of either package imports
into the other with the same events; without pyarrow a parquet file fails
with an error that names it."""

import datetime as dt
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from predictionio_tpu_torch.data.event import Event  # noqa: E402
from predictionio_tpu_torch.data.storage.base import App  # noqa: E402
from predictionio_tpu_torch.data.storage.memory import MemoryStorageClient  # noqa: E402
from predictionio_tpu_torch.tools.import_export import export_events, import_events  # noqa: E402

UTC = dt.timezone.utc


def _mk_storage():
    client = MemoryStorageClient()

    class _S:
        def get_meta_data_apps(self):
            return client.apps()

        def get_meta_data_channels(self):
            return client.channels()

        def get_l_events(self):
            return client.l_events()

        def get_p_events(self):
            return client.p_events()

    s = _S()
    s.get_meta_data_apps().insert(App(0, "ioapp"))
    return s


def _seed(storage, n=25):
    app = storage.get_meta_data_apps().get_by_name("ioapp")
    lev = storage.get_l_events()
    for k in range(n):
        lev.insert(
            Event(
                event="rate" if k % 2 else "view",
                entity_type="user",
                entity_id=f"u{k % 5}",
                target_entity_type="item",
                target_entity_id=f"i{k % 7}",
                properties={"rating": float(k % 5 + 1)} if k % 2 else {},
                event_time=dt.datetime(2026, 1, 1, 0, 0, k, tzinfo=UTC),
            ),
            app.id,
        )
    return app


class TestJsonRoundTrip:
    def test_export_import(self, tmp_path):
        src = _mk_storage()
        _seed(src)
        out = tmp_path / "events.jsonl"
        n = export_events(str(out), "ioapp", storage=src, format="json")
        assert n == 25
        # wire rows parse as API events
        rows = [json.loads(line) for line in out.read_text().splitlines()]
        assert all("eventTime" in r for r in rows)

        dst = _mk_storage()
        n2 = import_events(str(out), "ioapp", storage=dst)
        assert n2 == 25
        src_events = sorted(
            src.get_p_events().find(1), key=lambda e: e.event_time
        )
        dst_events = sorted(
            dst.get_p_events().find(1), key=lambda e: e.event_time
        )
        for a, b in zip(src_events, dst_events):
            assert (a.event, a.entity_id, a.target_entity_id) == (
                b.event, b.entity_id, b.target_entity_id
            )
            assert dict(a.properties) == dict(b.properties)
            assert a.event_time == b.event_time


class TestParquetRoundTrip:
    def test_export_import(self, tmp_path):
        pytest.importorskip("pyarrow")
        src = _mk_storage()
        _seed(src)
        out = tmp_path / "events.parquet"
        n = export_events(str(out), "ioapp", storage=src, format="parquet")
        assert n == 25

        # the file is real parquet with wire-named columns
        import pyarrow.parquet as pq

        table = pq.read_table(out)
        assert {"event", "entityType", "entityId", "eventTime"} <= set(
            table.column_names
        )
        assert table.num_rows == 25

        dst = _mk_storage()
        n2 = import_events(str(out), "ioapp", storage=dst)
        assert n2 == 25
        src_events = sorted(
            src.get_p_events().find(1), key=lambda e: e.event_time
        )
        dst_events = sorted(
            dst.get_p_events().find(1), key=lambda e: e.event_time
        )
        for a, b in zip(src_events, dst_events):
            assert (a.event, a.entity_id, a.target_entity_id) == (
                b.event, b.entity_id, b.target_entity_id
            )
            assert dict(a.properties) == dict(b.properties)
            assert a.event_time == b.event_time

    def test_timestamp_columns_are_typed(self, tmp_path):
        """eventTime/creationTime must be real tz-aware timestamp columns
        (the reference's Spark schema uses TimestampType), not ISO strings
        (code-review r5)."""
        pytest.importorskip("pyarrow")
        import pyarrow as pa
        import pyarrow.parquet as pq

        src = _mk_storage()
        _seed(src, n=3)
        out = tmp_path / "t.parquet"
        export_events(str(out), "ioapp", storage=src, format="parquet")
        schema = pq.read_table(out).schema
        assert schema.field("eventTime").type == pa.timestamp("us", tz="UTC")
        assert schema.field("creationTime").type == pa.timestamp("us", tz="UTC")

    def test_properties_json_column(self, tmp_path):
        """Schema-free properties ride as a JSON string column (documented
        deviation from the reference's Spark struct)."""
        pytest.importorskip("pyarrow")
        src = _mk_storage()
        _seed(src, n=4)
        out = tmp_path / "p.parquet"
        export_events(str(out), "ioapp", storage=src, format="parquet")
        import pyarrow.parquet as pq

        col = pq.read_table(out).to_pylist()
        with_props = [r for r in col if r["properties"]]
        assert with_props
        assert all(
            isinstance(json.loads(r["properties"]), dict) for r in with_props
        )


class TestNpzExport:
    def test_columnar(self, tmp_path):
        src = _mk_storage()
        _seed(src)
        out = tmp_path / "cols.npz"
        n = export_events(str(out), "ioapp", storage=src, format="npz")
        assert n == 25
        with np.load(out, allow_pickle=True) as z:
            assert len(z["entity_ids"]) == 25
            assert len(z["entity_vocab"]) == 5


def test_unknown_format_rejected(tmp_path):
    src = _mk_storage()
    with pytest.raises(ValueError, match="json|parquet|npz"):
        export_events(str(tmp_path / "x"), "ioapp", storage=src, format="xml")


# ---------------------------------------------------------------------------
# the port beside the JAX package
# ---------------------------------------------------------------------------


def _jax_storage():
    from predictionio_tpu.data.storage.base import App as JaxApp
    from predictionio_tpu.data.storage.memory import MemoryStorageClient as JaxClient

    client = JaxClient()

    class _S:
        def get_meta_data_apps(self):
            return client.apps()

        def get_meta_data_channels(self):
            return client.channels()

        def get_l_events(self):
            return client.l_events()

        def get_p_events(self):
            return client.p_events()

    s = _S()
    s.get_meta_data_apps().insert(JaxApp(0, "ioapp"))
    return s


def _rows(path):
    """An export's rows without the store-made fields, in event order."""
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    for r in rows:
        r.pop("eventId"), r.pop("creationTime")
    return sorted(rows, key=lambda r: (r["eventTime"], r["entityId"], r.get("targetEntityId")))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_json_export_imports_into_the_other_package(tmp_path, direction):
    from predictionio_tpu.tools import import_export as jax_io

    seed_file = tmp_path / "seed.jsonl"
    src = _mk_storage()
    _seed(src, n=30)
    export_events(str(seed_file), "ioapp", storage=src, format="json")
    jax_src = _jax_storage()
    jax_io.import_events(str(seed_file), "ioapp", storage=jax_src)
    if direction == "jax_to_port":
        exporter, importer, dst = jax_io.export_events, import_events, _mk_storage()
        src = jax_src
    else:
        exporter, importer, dst = export_events, jax_io.import_events, _jax_storage()
    out, back = tmp_path / "out.jsonl", tmp_path / "back.jsonl"
    assert exporter(str(out), "ioapp", storage=src, format="json") == 30
    assert importer(str(out), "ioapp", storage=dst) == 30
    (export_events if direction == "jax_to_port" else jax_io.export_events)(
        str(back), "ioapp", storage=dst, format="json")
    assert _rows(back) == _rows(out) == _rows(seed_file)


def test_export_import_keeps_creation_time(tmp_path):
    """An export writes each row's creationTime (to the millisecond, the
    wire format's precision) and the port's import keeps it, so the store's
    tail order (creation time, id) survives the trip."""
    src = _mk_storage()
    _seed(src, n=6)
    out = tmp_path / "events.jsonl"
    export_events(str(out), "ioapp", storage=src, format="json")
    dst = _mk_storage()
    import_events(str(out), "ioapp", storage=dst)

    def seq(storage):
        return sorted((e.event_id, e.creation_time.replace(
            microsecond=e.creation_time.microsecond // 1000 * 1000))
            for e in storage.get_p_events().find(1))

    assert seq(dst) == seq(src)


def test_parquet_without_pyarrow_names_it(tmp_path, monkeypatch):
    import sys

    src = _mk_storage()
    _seed(src, n=3)
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    with pytest.raises(ValueError, match="pyarrow"):
        export_events(str(tmp_path / "e.parquet"), "ioapp", storage=src, format="parquet")
    (tmp_path / "in.parquet").write_bytes(b"PAR1")
    with pytest.raises(ValueError, match="pyarrow"):
        import_events(str(tmp_path / "in.parquet"), "ioapp", storage=src)


def test_cli_app_accesskey_channel_import_export_verbs(tmp_path, capsys):
    """The port's CLI verbs around the storage, in-process on one sqlite
    basedir: app new/list/show, accesskey new/list/delete, channel-new,
    import and export into a channel, data-delete, channel-delete, app
    delete (each destructive verb refuses without --force)."""
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.tools import cli

    home = str(tmp_path / "home")

    def run(*args):
        rc = cli.main(["--home", home, *args])
        return rc, capsys.readouterr()

    rc, out = run("app", "new", "cliapp", "--description", "a test app")
    assert rc == 0 and "Access Key:" in out.out
    assert run("app", "new", "cliapp")[0] == 1  # the name is taken
    rc, out = run("accesskey", "new", "cliapp", "--event", "rate", "--event", "buy")
    key = out.out.strip().rsplit(" ", 1)[-1]
    assert rc == 0 and key in run("accesskey", "list", "cliapp")[1].out
    assert "rate,buy" in run("app", "show", "cliapp")[1].out
    assert "cliapp" in run("app", "list")[1].out
    assert run("app", "channel-new", "cliapp", "mobile")[0] == 0
    assert run("app", "channel-new", "cliapp", "bad name!")[0] == 1
    src = _mk_storage()
    _seed(src, n=12)
    wire = tmp_path / "wire.jsonl"
    export_events(str(wire), "ioapp", storage=src, format="json")
    rc, out = run("import", "--appname", "cliapp", "--input", str(wire), "--channel", "mobile")
    assert rc == 0 and "Imported 12 events." in out.out
    rc, out = run("export", "--appname", "cliapp", "--output", str(tmp_path / "back.jsonl"),
                  "--channel", "mobile")
    assert rc == 0 and len((tmp_path / "back.jsonl").read_text().splitlines()) == 12
    assert run("export", "--appname", "cliapp", "--output", str(tmp_path / "main.jsonl"))[0] == 0
    assert (tmp_path / "main.jsonl").read_text() == ""  # the default channel is apart
    assert run("app", "data-delete", "cliapp", "--channel", "mobile")[0] == 1  # no --force
    assert run("app", "data-delete", "cliapp", "--channel", "mobile", "-f")[0] == 0
    run("export", "--appname", "cliapp", "--output", str(tmp_path / "gone.jsonl"), "--channel", "mobile")
    assert (tmp_path / "gone.jsonl").read_text() == ""
    assert run("app", "channel-delete", "cliapp", "mobile", "-f")[0] == 0
    assert run("accesskey", "delete", key)[0] == 0
    assert key not in run("accesskey", "list")[1].out
    assert run("app", "delete", "cliapp")[0] == 1  # no --force
    assert run("app", "delete", "cliapp", "-f")[0] == 0
    storage = Storage(env={"PIO_FS_BASEDIR": home})
    assert storage.get_meta_data_apps().get_all() == []
    assert storage.get_meta_data_access_keys().get_all() == []
    assert run("app", "show", "cliapp")[0] == 1
