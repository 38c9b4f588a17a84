"""The port's host library (``predictionio_tpu_torch/utils/native.py`` over
``ops/csrc/pio_scan.cpp``, built with g++) against the JAX package's
native module and against the python formulations, on the CPU.

Every case of ``tests/test_native.py`` (the JSONL scan, its edge
semantics, the cooccurrence top-N) and of
``test_als.py::test_host_group_by_native_matches_numpy`` is carried over.
Each input is made from a seed (or written out) once and goes three ways:
through the port's native routine and the port's python path (the base
encoder, the scipy and pair-expansion cooccurrence, numpy's stable
argsort), through the JAX package's native routine, and through the JAX
package's ``cooccurrence_top_n`` and ``to_columnar``. Columns, ids and
vocabularies must be equal (ratings NaN-equal), the group-by bit-equal,
the cooccurrence maps equal with their ties. Two differences are by
design and pinned: the port's scan does not read a last line without its
newline (the JAX native scan does, ROADMAP C5), and where the JAX loader
returns None (no library, an id out of range) the port raises.
"""

import dataclasses
import datetime as dt
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from predictionio_tpu.data.datamap import DataMap
from predictionio_tpu.data.storage.jsonl import JSONLStorageClient as JaxJSONLClient
from predictionio_tpu.ops import cooccurrence as jax_co
from predictionio_tpu.utils import native as jax_native
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import base as pt_base
from predictionio_tpu_torch.data.storage.jsonl import JSONLStorageClient
from predictionio_tpu_torch.ops import _build
from predictionio_tpu_torch.ops import als as pt_als
from predictionio_tpu_torch.ops import cooccurrence as pt_co
from predictionio_tpu_torch.utils import native

REPO = Path(__file__).resolve().parents[1]
APP = 3
UTC = dt.timezone.utc


@pytest.fixture(scope="module")
def jax_lib():
    lib = jax_native.get_library()
    assert lib is not None, "the JAX package's native library did not build (g++?)"
    return lib


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def seed_events(client, n_users=50, n_items=20, seed=0):
    rng = np.random.default_rng(seed)
    events = []
    for u in range(n_users):
        for _ in range(10):
            events.append(Event(
                event="rate" if rng.random() < 0.7 else "view",
                entity_type="user", entity_id=f"u{u}",
                target_entity_type="item", target_entity_id=f"i{int(rng.integers(0, n_items))}",
                properties={"rating": float(rng.integers(1, 6))},
                event_time=dt.datetime(2024, 1, 1, tzinfo=UTC),
            ))
    client.p_events().write(events, APP)
    return events


def assert_columnar_equal(got, want) -> None:
    assert got.event_ids == want.event_ids
    assert list(got.event_names) == list(want.event_names)
    for name in ("entity_vocab", "target_vocab", "event_vocab"):
        assert list(getattr(got, name)) == list(getattr(want, name)), name
    for name in ("entity_ids", "target_ids", "event_codes", "timestamps"):
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    np.testing.assert_array_equal(got.ratings, want.ratings)  # NaN-equal
    assert got.ratings.dtype == want.ratings.dtype


def assert_raw_equal(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert got[key] == value, key


def columnar_three_ways(tmp_path, name, **kw):
    """One port client of a fresh store (the events are written by the
    caller through it): the port's native to_columnar, held to the port's
    python encoder and to the JAX package's to_columnar of the same file."""
    client = JSONLStorageClient({"PATH": str(tmp_path / name)})

    def read():
        p = client.p_events()
        calls = native.calls["scan_jsonl_columnar"]
        got = p.to_columnar(APP, **kw)
        python = pt_base.PEvents.to_columnar(p, APP, **kw)
        theirs = JaxJSONLClient({"PATH": str(tmp_path / name)}).p_events().to_columnar(APP, **kw)
        assert_columnar_equal(got, python)
        assert_columnar_equal(got, theirs)
        return got, native.calls["scan_jsonl_columnar"] - calls

    return client, read


def scan_both(path: Path, **kw) -> dict:
    """The port's native scan of a file, equal to the JAX native scan's."""
    got = native.scan_jsonl_columnar(str(path), **kw)
    assert_raw_equal(got, jax_native.scan_jsonl_columnar(str(path), **kw))
    return got


def write_rows(path: Path, rows: list[dict]) -> Path:
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return path


# ---------------------------------------------------------------------------
# the JSONL scan (tests/test_native.py TestNativeScan)
# ---------------------------------------------------------------------------


class TestNativeScan:
    def test_parity_with_python_path(self, jax_lib, tmp_path):
        client, read = columnar_three_ways(tmp_path, "ev", event_names=["rate"], entity_type="user",
                                           target_entity_type="item")
        seed_events(client)
        cols, native_calls = read()
        assert native_calls == 1 and len(cols) > 0 and set(cols.event_names) == {"rate"}

    def test_event_name_filter(self, jax_lib, tmp_path):
        client, read = columnar_three_ways(tmp_path, "ev2", event_names=["view"])
        seed_events(client)
        cols, native_calls = read()
        assert native_calls == 1 and set(cols.event_names) == {"view"}

    def test_handles_escapes_and_missing_fields(self, jax_lib, tmp_path):
        rows = [
            {"event": "rate", "entityType": "user", "entityId": 'u"quoted"',
             "targetEntityType": "item", "targetEntityId": "i\\slash",
             "properties": {"rating": 2.5, "nested": {"rating": 99}},
             "eventTime": "2024-06-01T12:30:00.000+02:00", "eventId": "a"},
            {"event": "view", "entityType": "user", "entityId": "u2",
             "properties": {}, "eventTime": "2024-06-01T10:30:00.000Z", "eventId": "b"},
        ]
        out = scan_both(write_rows(tmp_path / "weird.jsonl", rows))
        assert out["entity_vocab"][0] == 'u"quoted"'
        assert out["target_vocab"][0] == "i\\slash"
        assert out["ratings"][0] == 2.5
        assert out["target_ids"][1] == -1
        assert np.isnan(out["ratings"][1])
        assert out["timestamps"][0] == out["timestamps"][1]  # 12:30+02:00 == 10:30Z

    def test_upsert_semantics_match(self, jax_lib, tmp_path):
        client, read = columnar_three_ways(tmp_path, "ev3")
        levents = client.l_events()
        e = Event(event="rate", entity_type="user", entity_id="u1", target_entity_type="item",
                  target_entity_id="i1", properties={"rating": 1.0})
        eid = levents.insert(e, APP)
        levents.insert(dataclasses.replace(e, event_id=eid, properties={"rating": 5.0}), APP)
        cols, _ = read()
        assert len(cols) == 1 and cols.ratings[0] == 5.0

    def test_a_larger_file_equals_the_python_encoder(self, jax_lib, tmp_path):
        """The reference's speed case at its size (4,000 events), held for
        equality only: a CPU time says nothing of the card host."""
        client, read = columnar_three_ways(tmp_path, "big", event_names=["rate", "view"])
        seed_events(client, n_users=400, n_items=100)
        cols, native_calls = read()
        assert native_calls == 1 and len(cols) == 4000


# ---------------------------------------------------------------------------
# edge semantics (tests/test_native.py TestNativeEdgeSemantics)
# ---------------------------------------------------------------------------


class TestNativeEdgeSemantics:
    def test_explicit_none_target_filter_uses_python_path(self, jax_lib, tmp_path):
        client, read = columnar_three_ways(tmp_path, "s1", target_entity_type=None)
        levents = client.l_events()
        levents.insert(Event(event="a", entity_type="u", entity_id="1"), APP)
        levents.insert(Event(event="a", entity_type="u", entity_id="2", target_entity_type="item",
                             target_entity_id="i1"), APP)
        cols, native_calls = read()
        assert len(cols) == 1 and native_calls == 0  # only the target-less event

    def test_empty_event_names_matches_nothing(self, jax_lib, tmp_path):
        client, read = columnar_three_ways(tmp_path, "s2", event_names=[])
        client.l_events().insert(Event(event="a", entity_type="u", entity_id="1"), APP)
        cols, native_calls = read()
        assert len(cols) == 0 and native_calls == 0

    @pytest.mark.parametrize("names,expected", [(["rate"], 0), (["view"], 1)])
    def test_upsert_changing_event_name_respects_filter(self, jax_lib, tmp_path, names, expected):
        client, read = columnar_three_ways(tmp_path, "s3", event_names=names)
        levents = client.l_events()
        e = Event(event="rate", entity_type="u", entity_id="1", target_entity_type="item",
                  target_entity_id="i1")
        eid = levents.insert(e, APP)
        levents.insert(dataclasses.replace(e, event_id=eid, event="view"), APP)
        cols, native_calls = read()  # the latest version is "view": "rate" must not resurrect it
        assert len(cols) == expected and native_calls == 1

    def test_unicode_ids_match_python_path(self, jax_lib, tmp_path):
        client, read = columnar_three_ways(tmp_path, "uni")
        for ent, tgt in (("müller", "商品1"), ("πθ", "🎬movie")):  # incl. astral
            client.l_events().insert(Event(event="rate", entity_type="user", entity_id=ent,
                                           target_entity_type="item", target_entity_id=tgt,
                                           properties={"rating": 3.0}), APP)
        cols, _ = read()
        assert cols.entity_vocab == ["müller", "πθ"]
        assert cols.target_vocab == ["商品1", "🎬movie"]

    def test_truncated_escape_does_not_crash(self, jax_lib, tmp_path):
        good = {"event": "rate", "entityType": "u", "entityId": "ok", "properties": {"rating": 1.0}}
        path = tmp_path / "trunc.jsonl"
        with open(path, "w") as f:
            f.write(json.dumps(good) + "\n")
            f.write('{"event": "rate", "entityType": "u", "entityId": "a\\u00\n')
            f.write('{"event": "rate", "entityType": "u", "entityId": "a\\u00')
        assert scan_both(path)["entity_vocab"] == ["ok"]

    def test_compact_timezone_offset(self, jax_lib, tmp_path):
        rows = [
            {"event": "a", "entityType": "u", "entityId": "x",
             "eventTime": "2026-07-30T12:00:00+0530", "eventId": "a"},
            {"event": "a", "entityType": "u", "entityId": "y",
             "eventTime": "2026-07-30T06:30:00Z", "eventId": "b"},  # same instant
        ]
        out = scan_both(write_rows(tmp_path / "tz.jsonl", rows))
        assert out["timestamps"][0] == out["timestamps"][1]

    def test_malformed_compact_offset_not_hours(self, jax_lib, tmp_path):
        rows = [
            {"event": "a", "entityType": "u", "entityId": "x",
             "eventTime": "2026-07-30T12:00:00+530", "eventId": "a"},
            {"event": "a", "entityType": "u", "entityId": "y",
             "eventTime": "2026-07-30T12:00:00+05a0", "eventId": "b"},
        ]
        assert list(scan_both(write_rows(tmp_path / "badtz.jsonl", rows))["timestamps"]) == [0.0, 0.0]

    def test_seconds_bearing_offsets_match_python(self, jax_lib, tmp_path):
        times = ["2026-07-30T12:00:00+053007", "2026-07-30T12:00:00+05:30:07"]
        rows = [{"event": "a", "entityType": "u", "entityId": f"e{n}", "eventTime": t, "eventId": f"id{n}"}
                for n, t in enumerate(times)]
        out = scan_both(write_rows(tmp_path / "sectz.jsonl", rows))
        expected = dt.datetime.fromisoformat(times[0]).timestamp()
        assert sorted(out["timestamps"]) == [expected, expected]

    def test_malformed_colon_offsets_rejected(self, jax_lib, tmp_path):
        rows = [
            {"event": "a", "entityType": "u", "entityId": "x",
             "eventTime": "2026-07-30T12:00:00+5:30", "eventId": "a"},
            {"event": "a", "entityType": "u", "entityId": "y",
             "eventTime": "2026-07-30T12:00:00+05:3", "eventId": "b"},
        ]
        assert list(scan_both(write_rows(tmp_path / "badcolon.jsonl", rows))["timestamps"]) == [0.0, 0.0]

    def test_idless_rows_collapse_like_python_path(self, jax_lib, tmp_path):
        rows = [{"event": "rate", "entityType": "u", "entityId": f"e{n}", "properties": {"rating": float(n)}}
                for n in range(3)]
        out = scan_both(write_rows(tmp_path / "noid.jsonl", rows))
        assert len(out["entity_ids"]) == 1
        assert out["entity_vocab"] == ["e2"]  # the last id-less row wins
        assert out["ratings"][0] == 2.0

    def test_time_sorted_with_real_ids(self, jax_lib, tmp_path):
        client, read = columnar_three_ways(tmp_path, "s4")
        ids = [client.l_events().insert(Event(event="a", entity_type="u", entity_id=f"e{n}",
                                              event_time=dt.datetime(2024, 1, n, tzinfo=UTC)), APP)
               for n in (3, 1, 2)]  # appended out of time order
        cols, _ = read()
        assert cols.entity_vocab == ["e1", "e2", "e3"]  # first use in time order
        assert list(cols.timestamps) == sorted(cols.timestamps)
        assert cols.event_ids == [ids[1], ids[2], ids[0]]

    def test_a_partial_last_line_is_not_read_by_the_port(self, jax_lib, tmp_path):
        """A line another writer is still appending: the port's native scan
        stops before it, as the port's python scan does (ROADMAP C5); the
        JAX native scan reads it (and the JAX python scan raises on it)."""
        client = JSONLStorageClient({"PATH": str(tmp_path / "partial")})
        seed_events(client, n_users=5, n_items=4)
        path = client.p_events()._files.path(APP, None)
        with open(path, "a") as f:
            f.write(json.dumps({"event": "rate", "entityType": "user", "entityId": "late",
                                "targetEntityType": "item", "targetEntityId": "i0",
                                "properties": {"rating": 5.0}, "eventId": "late",
                                "eventTime": "2024-01-02T00:00:00.000Z"}))  # no newline yet
        p = client.p_events()
        calls = native.calls["scan_jsonl_columnar"]
        got = p.to_columnar(APP)
        assert native.calls["scan_jsonl_columnar"] == calls + 1
        assert_columnar_equal(got, pt_base.PEvents.to_columnar(p, APP))
        assert "late" not in got.entity_vocab and len(got) == 50
        theirs = jax_native.scan_jsonl_columnar(path)
        assert "late" in theirs["entity_vocab"] and len(theirs["entity_ids"]) == 51
        with open(path, "a") as f:
            f.write("\n")  # the writer finishes the line: the next read has it
        assert "late" in p.to_columnar(APP).entity_vocab

    def test_a_missing_file_reads_as_an_empty_block(self, tmp_path):
        p = JSONLStorageClient({"PATH": str(tmp_path / "none")}).p_events()
        assert len(p.to_columnar(APP)) == 0
        with pytest.raises(OSError, match="cannot open file"):
            native.scan_jsonl_columnar(str(tmp_path / "none" / "missing.jsonl"))


# ---------------------------------------------------------------------------
# cooccurrence (tests/test_native.py TestNativeCooccurrence)
# ---------------------------------------------------------------------------


def _cooccurrence_three_ways(u, i, n_items, top_n):
    got = pt_co.cooccurrence_top_n(u, i, n_items, top_n)
    assert got == pt_co._cooccurrence_top_n_reference(u, i, n_items, top_n)
    assert got == jax_co.cooccurrence_top_n(u, i, n_items, top_n)
    codes = np.unique(np.asarray(u, np.int64) * n_items + np.asarray(i, np.int64))
    assert got == pt_co._cooccurrence_top_n_scipy(codes // n_items, codes % n_items, n_items, top_n)
    return got


class TestNativeCooccurrence:
    @pytest.mark.parametrize("seed,n_users,n_items,nnz,top_n", [(0, 40, 30, 2000, 5), (1, 7, 12, 300, 50)])
    def test_parity_with_oracle(self, jax_lib, seed, n_users, n_items, nnz, top_n):
        rng = np.random.default_rng(seed)
        u = rng.integers(0, n_users, nnz).astype(np.int32)
        i = rng.integers(0, n_items, nnz).astype(np.int32)
        calls = native.calls["cooccur_topn"]
        assert _cooccurrence_three_ways(u, i, n_items, top_n)
        assert native.calls["cooccur_topn"] == calls + 1

    def test_parity_zipf_ties(self, jax_lib):
        rng = np.random.default_rng(2)
        u = rng.integers(0, 60, 4000).astype(np.int32)
        i = (rng.zipf(1.3, 4000) % 25).astype(np.int32)
        _cooccurrence_three_ways(u, i, 25, 7)

    def test_native_wrapper_contract(self, jax_lib):
        users = np.array([0, 0, 1, 1], np.int32)
        items = np.array([1, 2, 1, 2], np.int32)
        out_items, out_counts = native.cooccur_topn(users, items, 4, 3)
        theirs = jax_native.cooccur_topn(users, items, 4, 3)
        np.testing.assert_array_equal(out_items, theirs[0])
        np.testing.assert_array_equal(out_counts, theirs[1])
        assert out_items.shape == (4, 3)
        assert list(out_items[1]) == [2, -1, -1]  # item 1 co-occurs with 2
        assert list(out_counts[1]) == [2, 0, 0]  # in both user baskets
        assert list(out_items[0]) == [-1, -1, -1]  # item 0 never seen
        assert list(out_items[3]) == [-1, -1, -1]

    def test_int32_count_path_above_uint16_users(self, jax_lib):
        rng = np.random.default_rng(4)
        u = rng.integers(65_530, 65_600, 800).astype(np.int32)  # past uint16's largest
        i = rng.integers(0, 12, 800).astype(np.int32)
        _cooccurrence_three_ways(u, i, 12, 5)

    @pytest.mark.parametrize("items,n_items,top_n,match", [
        ([1, 9], 4, 2, "an item id outside"), ([1, 2], 4, 0, "must be positive"),
        ([1, 2], 0, 2, "must be positive")])
    def test_a_refusal_raises_where_the_jax_loader_returns_none(self, jax_lib, items, n_items, top_n, match):
        users = np.zeros(2, np.int32)
        items = np.array(items, np.int32)
        assert jax_native.cooccur_topn(users, items, n_items, top_n) is None
        with pytest.raises(ValueError, match=match):
            native.cooccur_topn(users, items, n_items, top_n)

    def test_a_vocabulary_past_the_dense_matrix_takes_the_scipy_path(self, jax_lib):
        """16,385 items: the dense count matrix would pass 2^28 cells, so
        the library declines (code 2) in both packages and the scipy
        formulation serves, as the JAX package's fallback does."""
        rng = np.random.default_rng(3)
        n_items = 16_385
        u = rng.integers(0, 40, 2000).astype(np.int32)
        i = rng.choice(n_items, 30, replace=False)[rng.integers(0, 30, 2000)].astype(np.int32)
        assert native.cooccur_topn(np.sort(u), i, n_items, 5) is None
        assert jax_native.cooccur_topn(np.sort(u), i, n_items, 5) is None
        assert _cooccurrence_three_ways(u, i, n_items, 5)


# ---------------------------------------------------------------------------
# the ALS group-by (test_als.py::test_host_group_by_native_matches_numpy)
# ---------------------------------------------------------------------------


def _coo(seed, n_users=120, n_items=80, nnz=3000):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_users, nnz).astype(np.int32), rng.integers(0, n_items, nnz).astype(np.int32),
            rng.uniform(1, 5, nnz).astype(np.float32))


@pytest.mark.parametrize("seed,n_entities", [(7, 120), (8, 500), (9, 1)])
def test_host_group_by_native_matches_numpy(jax_lib, seed, n_entities):
    u, i, v = _coo(seed, n_users=n_entities)
    calls = native.calls["coo_group"]
    got = pt_als._host_group_by(u, i, v, n_entities)
    assert native.calls["coo_group"] == calls + 1
    plain = pt_als._host_group_by_plain(u, i, v, n_entities)
    theirs = jax_native.coo_group(u, i, v, n_entities)
    for g, p, t in zip(got, plain, theirs):
        assert g.dtype == p.dtype == t.dtype
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g, t)
    order = np.argsort(u, kind="stable")
    np.testing.assert_array_equal(got[0], i[order])
    np.testing.assert_array_equal(got[2], np.bincount(u, minlength=n_entities).astype(np.int32))
    empty = pt_als._host_group_by(u[:0], i[:0], v[:0], n_entities)
    assert [a.size for a in empty] == [0, 0, n_entities] and not empty[2].any()


@pytest.mark.parametrize("bad", [10_000, -1, 2**32 + 5])
def test_an_entity_id_out_of_range_raises_where_the_jax_loader_returns_none(jax_lib, bad):
    u, i, v = _coo(seed=7)
    u = u.astype(np.int64)
    u[0] = bad
    if bad < 2**31:
        assert jax_native.coo_group(u, i, v, 120) is None
    with pytest.raises(ValueError, match="out of range for 120 entities"):
        pt_als._host_group_by(u, i, v, 120)


# ---------------------------------------------------------------------------
# the build: no fallback, and processes building at once
# ---------------------------------------------------------------------------


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """The loader with nothing loaded and an empty build directory."""
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(_build, "_host_libs", {})
    monkeypatch.setattr(native, "_lib", None)
    return tmp_path / "native"


def test_a_failed_host_build_raises_with_the_compiler_output(fresh_build, monkeypatch, tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "pio_scan.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    with pytest.raises(_build.KernelBuildError, match=r"pio_scan\.cpp \(g\+\+ exit [1-9]") as err:
        native.get_library()
    assert "error" in str(err.value)
    assert not list(fresh_build.glob("*"))  # no library, no temporary left
    with pytest.raises(_build.KernelBuildError):
        native.coo_group(*_coo(seed=1), 120)


def test_a_missing_compiler_raises(fresh_build, monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(_build.KernelBuildError, match="g\\+\\+ not found"):
        native.get_library()


_BUILDER = """
import os, pathlib, sys, time
from predictionio_tpu_torch.ops import _build
_build.HOST_BUILD_DIR = pathlib.Path(sys.argv[1])
while not os.path.exists(sys.argv[2]):
    time.sleep(0.002)
from predictionio_tpu_torch.utils import native
import numpy as np
lib = native.get_library()
cols, vals, deg = native.coo_group(np.array([1, 0, 1]), np.array([5, 6, 7]), np.ones(3), 2)
print(lib._name, cols.tolist(), deg.tolist())
"""


def test_two_processes_build_into_an_empty_directory_at_once(tmp_path):
    out, go = tmp_path / "native", tmp_path / "go"
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILDER, str(out), str(go)], cwd=str(REPO),
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    time.sleep(0.5)
    go.touch()
    results = [p.communicate(timeout=300) for p in procs]
    for p, (stdout, stderr) in zip(procs, results):
        assert p.returncode == 0, stderr
    lines = [stdout.strip() for stdout, _ in results]
    assert lines[0] == lines[1] and lines[0].endswith("[6, 5, 7] [1, 2]"), lines
    built = sorted(out.iterdir())
    assert len(built) == 1 and built[0].suffix == ".so" and lines[0].startswith(str(built[0]))
