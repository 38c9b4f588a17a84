"""The port's library modules held to the JAX package's on the same seeded
inputs: ``data/bimap.py`` (``BiMap``), ``data/view.py`` (``EventSeq``,
``datamap_aggregator``, ``create``), ``controller/self_cleaning.py``
(``clean_events``, ``SelfCleaningDataSource``) and ``e2/vectorizer.py``
(``BinaryVectorizer``). Each scenario of tests/test_view.py,
tests/test_aux.py, tests/test_e2.py and tests/test_storage.py's TestBiMap
runs through both packages, and the outputs of the two are compared."""

from __future__ import annotations

import dataclasses
import datetime as dt
import os
import types
import warnings

import numpy as np
import pytest

pytest.importorskip("torch")

from tests.torch_serving_helpers import MEMORY_ENV, PACKAGES  # noqa: E402

UTC = dt.timezone.utc
T0 = dt.datetime(2024, 1, 1, tzinfo=UTC)


def pkg_modules(pkg: str) -> types.SimpleNamespace:
    if pkg == "jax":
        from predictionio_tpu.controller import self_cleaning
        from predictionio_tpu.data import BiMap, view
        from predictionio_tpu.data.datamap import DataMap
        from predictionio_tpu.data.event import Event
        from predictionio_tpu.data.storage.base import App, Channel
        from predictionio_tpu.data.storage.registry import Storage
        from predictionio_tpu.e2 import BinaryVectorizer
        from predictionio_tpu.workflow.context import WorkflowContext

        def context(storage, app_name):
            return WorkflowContext(_storage=storage, app_name=app_name)
    else:
        from predictionio_tpu_torch.controller import self_cleaning
        from predictionio_tpu_torch.data import BiMap, view
        from predictionio_tpu_torch.data.datamap import DataMap
        from predictionio_tpu_torch.data.event import Event
        from predictionio_tpu_torch.data.storage.base import App, Channel
        from predictionio_tpu_torch.data.storage.registry import Storage
        from predictionio_tpu_torch.e2 import BinaryVectorizer
        from predictionio_tpu_torch.workflow.context import WorkflowContext

        def context(storage, app_name):
            return WorkflowContext(_storage=storage, app_name=app_name, device="cpu")
    return types.SimpleNamespace(
        self_cleaning=self_cleaning, BiMap=BiMap, view=view, DataMap=DataMap, Event=Event, App=App,
        Channel=Channel, Storage=Storage, BinaryVectorizer=BinaryVectorizer, context=context)


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return pkg_modules(request.param)


def _ev(m, name, eid, day, props=None, target=None, t0=T0):
    return m.Event(event=name, entity_type="user", entity_id=eid,
                   target_entity_type="item" if target else None, target_entity_id=target,
                   properties=dict(props or {}), event_time=t0 + dt.timedelta(days=day))


def _seq(m, events):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return m.view.EventSeq(events)


def _props(p) -> dict:
    """A DataMap's fields or a dict, as a dict."""
    return dict(p.fields) if hasattr(p, "fields") else dict(p)


def _seeded_events(m, seed: int, n: int = 300, t0=T0):
    """Seeded property and rate events over 12 users: $set, $unset,
    $delete, rate, buy, with repeats (the same event twice)."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        name = str(rng.choice(["$set", "$set", "$unset", "$delete", "rate", "buy"], p=[.3, .1, .15, .05, .3, .1]))
        user = f"u{int(rng.integers(12))}"
        day = float(rng.integers(0, 60)) + float(rng.integers(0, 4)) / 4
        if name in ("$set", "$unset"):
            props = {f"p{int(j)}": int(rng.integers(5)) for j in rng.choice(6, int(rng.integers(1, 4)), replace=False)}
            out.append(_ev(m, name, user, day, props, t0=t0))
        elif name == "$delete":
            out.append(_ev(m, name, user, day, t0=t0))
        else:
            out.append(_ev(m, name, user, day, {"rating": float(rng.integers(1, 6))},
                           target=f"i{int(rng.integers(20))}", t0=t0))
        if rng.random() < 0.1:
            out.append(out[-1])
    return out


def _wire(e) -> dict:
    d = e.to_json_dict()
    d.pop("eventId", None)
    return d


# ---------------------------------------------------------------------------
# EventSeq and the DataMap aggregator (tests/test_view.py TestEventSeq)
# ---------------------------------------------------------------------------


class TestEventSeq:
    def test_deprecation_warned(self, pkg):
        with pytest.warns(DeprecationWarning):
            pkg.view.EventSeq([])

    def test_filter_event_and_entity_type(self, pkg):
        es = _seq(pkg, [_ev(pkg, "view", "u1", 0), _ev(pkg, "buy", "u1", 1), _ev(pkg, "view", "u2", 2)])
        assert len(es.filter(event="view")) == 2
        assert len(es.filter(event="buy", entity_type="user")) == 1

    def test_start_time_strictly_after(self, pkg):
        es = _seq(pkg, [_ev(pkg, "view", "u1", 0), _ev(pkg, "view", "u1", 1)])
        assert len(es.filter(start_time=T0)) == 1
        assert len(es.filter(until_time=T0 + dt.timedelta(days=1))) == 1

    def test_aggregate_by_entity_ordered(self, pkg):
        es = _seq(pkg, [_ev(pkg, "buy", "u1", 2, {"n": 3}), _ev(pkg, "buy", "u1", 0, {"n": 1}),
                        _ev(pkg, "buy", "u2", 1, {"n": 5})])
        folds = es.aggregate_by_entity_ordered(init=[], op=lambda acc, e: acc + [e.properties.get("n")])
        assert folds == {"u1": [1, 3], "u2": [5]}

    def test_datamap_aggregator_set_unset_delete(self, pkg):
        agg = pkg.view.datamap_aggregator()
        acc = None
        acc = agg(acc, _ev(pkg, "$set", "u1", 0, {"a": 1, "b": 2}))
        acc = agg(acc, _ev(pkg, "$set", "u1", 1, {"b": 3}))
        acc = agg(acc, _ev(pkg, "$unset", "u1", 2, {"a": 0}))
        assert isinstance(acc, pkg.DataMap) and acc.fields == {"b": 3}
        assert agg(acc, _ev(pkg, "$delete", "u1", 3)) is None
        assert agg(acc, _ev(pkg, "view", "u1", 4)).fields == {"b": 3}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_event_seq_filters_and_folds_equal_the_reference(seed):
    """Seeded events: every filter, the ordered per-entity fold and the
    DataMap aggregator's fold give the JAX package's answers."""
    out = {}
    for name in PACKAGES:
        m = pkg_modules(name)
        es = _seq(m, _seeded_events(m, seed))
        filters = [es.filter(event="rate"), es.filter(entity_type="user", start_time=T0 + dt.timedelta(days=20)),
                   es.filter(until_time=T0 + dt.timedelta(days=10, hours=6)),
                   es.filter(event="$set", start_time=T0 + dt.timedelta(days=5), until_time=T0 + dt.timedelta(days=40))]
        agg = m.view.datamap_aggregator()
        folded = es.aggregate_by_entity_ordered(None, agg)
        out[name] = (
            [[_wire(e) for e in f] for f in filters],
            es.aggregate_by_entity_ordered([], lambda acc, e: acc + [(e.event, e.event_time.isoformat())]),
            {k: (None if v is None else v.fields) for k, v in folded.items()},
            es.aggregate_by_entity_ordered(0, lambda acc, e: acc + 1, predicate=lambda e: e.event == "rate"),
        )
    assert out["port"] == out["jax"]
    assert any(v is None for v in out["port"][2].values()) and any(out["port"][2].values())


# ---------------------------------------------------------------------------
# DataView.create (tests/test_view.py TestDataView)
# ---------------------------------------------------------------------------


def _view_storage(m):
    storage = m.Storage(env=MEMORY_ENV)
    app_id = storage.get_meta_data_apps().insert(m.App(0, "viewapp"))
    lev = storage.get_l_events()
    for i in range(6):
        lev.insert(_ev(m, "rate", f"u{i % 2}", i, {"rating": float(i)}, target=f"i{i}"), app_id)
    return storage, app_id


class TestDataView:
    def test_create_and_cache(self, pkg, tmp_path):
        storage, _ = _view_storage(pkg)
        calls = []

        def convert(e):
            calls.append(1)
            if e.properties.get("rating", 0) < 1:
                return None
            return {"user": e.entity_id, "item": e.target_entity_id, "rating": e.properties["rating"]}

        kw = dict(until_time=T0 + dt.timedelta(days=30), name="ratings", base_dir=str(tmp_path), storage=storage)
        cols = pkg.view.create("viewapp", convert, version="v1", **kw)
        assert set(cols) == {"user", "item", "rating"}
        assert len(cols["rating"]) == 5 and cols["rating"].dtype == np.float64
        n_calls = len(calls)
        cols2 = pkg.view.create("viewapp", convert, version="v1", **kw)
        assert len(calls) == n_calls
        np.testing.assert_array_equal(cols2["rating"], cols["rating"])
        pkg.view.create("viewapp", convert, version="v2", **kw)
        assert len(calls) > n_calls

    def test_tuple_records_and_empty_channel(self, pkg, tmp_path):
        storage, app_id = _view_storage(pkg)
        until = T0 + dt.timedelta(days=30)
        cols = pkg.view.create("viewapp", lambda e: (e.entity_id, e.properties.get("rating", 0.0)),
                               until_time=until, name="tup", base_dir=str(tmp_path), storage=storage)
        assert set(cols) == {"c0", "c1"}
        storage.get_meta_data_channels().insert(pkg.Channel(0, "mobile", app_id))
        assert pkg.view.create("viewapp", lambda e: {"u": e.entity_id}, channel_name="mobile", until_time=until,
                               name="chan", base_dir=str(tmp_path), storage=storage) == {}

    def test_no_until_time_caches_on_version_stamp(self, pkg, tmp_path):
        storage, app_id = _view_storage(pkg)
        calls = []

        def convert(e):
            calls.append(1)
            return {"u": e.entity_id}

        kw = dict(name="nowless", base_dir=str(tmp_path), storage=storage)
        assert len(pkg.view.create("viewapp", convert, **kw)["u"]) == 6
        n1 = len(calls)
        assert len(pkg.view.create("viewapp", convert, **kw)["u"]) == 6 and len(calls) == n1
        storage.get_l_events().insert(_ev(pkg, "rate", "u9", 9, target="i9"), app_id)
        assert len(pkg.view.create("viewapp", convert, **kw)["u"]) == 7 and len(calls) > n1
        assert len([f for f in os.listdir(tmp_path / "view") if f.startswith("nowless-")]) <= 4

    def test_prune_spares_windows_and_other_views(self, pkg, tmp_path):
        storage, app_id = _view_storage(pkg)
        view_dir = tmp_path / "view"
        view_dir.mkdir()
        legacy = view_dir / ("win-viewapp-" + "ab" * 8 + ".npz")
        legacy.write_bytes(b"legacy")
        other = view_dir / ("win-viewapp-eu-stamp-" + "ef" * 8 + ".npz")
        other.write_bytes(b"other-view")
        calls = []

        def convert(e):
            calls.append(1)
            return {"u": e.entity_id}

        kw = dict(name="win", base_dir=str(tmp_path), storage=storage)
        windows = [T0 + dt.timedelta(days=d) for d in range(1, 8)]
        for w in windows:
            pkg.view.create("viewapp", convert, until_time=w, **kw)
        n1 = len(calls)
        for w in windows:
            pkg.view.create("viewapp", convert, until_time=w, **kw)
        assert len(calls) == n1
        for _ in range(6):
            storage.get_l_events().insert(_ev(pkg, "rate", "u8", 8, target="i8"), app_id)
            pkg.view.create("viewapp", convert, **kw)
        names = os.listdir(view_dir)
        assert 0 < len([f for f in names if f.startswith("win-viewapp-stamp-")]) <= 4
        assert legacy.name not in names and other.name in names


def test_data_view_columns_equal_the_reference(tmp_path):
    """Seeded events in each package's memory store: the same conversion
    (dict, tuple and dataclass records) gives the same columns."""

    @dataclasses.dataclass
    class Row:
        user: str
        rating: float

    conversions = {
        "dict": lambda e: ({"user": e.entity_id, "item": e.target_entity_id, "rating": e.properties["rating"]}
                           if e.event == "rate" else None),
        "tuple": lambda e: (e.entity_id, e.event, e.event_time.timestamp()),
        "dataclass": lambda e: Row(e.entity_id, float(e.properties.get("rating", -1.0))) if e.target_entity_id else None,
    }
    out = {}
    for name in PACKAGES:
        m = pkg_modules(name)
        storage = m.Storage(env=MEMORY_ENV)
        app_id = storage.get_meta_data_apps().insert(m.App(0, "viewapp"))
        storage.get_l_events().insert_batch(_seeded_events(m, 7), app_id)
        out[name] = {}
        for label, fn in conversions.items():
            for until in (None, T0 + dt.timedelta(days=30)):
                cols = m.view.create("viewapp", fn, until_time=until, name=label,
                                     base_dir=str(tmp_path / name), storage=storage)
                out[name][label, until] = {k: (v.dtype.str, v.tolist()) for k, v in cols.items()}
    assert out["port"] == out["jax"]
    assert len(out["port"]["dict", None]["rating"][1]) > 50


# ---------------------------------------------------------------------------
# SelfCleaningDataSource (tests/test_aux.py TestCleanEvents, TestSelfCleaningDataSource)
# ---------------------------------------------------------------------------


def _aux_ev(m, name, eid, n_days_ago=0, props=None, target=None):
    return _ev(m, name, eid, -n_days_ago, props, target, t0=m.self_cleaning.now_utc())


class TestCleanEvents:
    def test_parse_duration(self, pkg):
        W = pkg.self_cleaning.EventWindow
        assert W.parse_duration("30 days") == dt.timedelta(days=30)
        assert W.parse_duration("2 hours") == dt.timedelta(hours=2)
        assert W.parse_duration("1 week") == dt.timedelta(weeks=1)
        with pytest.raises(ValueError):
            W.parse_duration("5 fortnights")

    def test_window_and_dedup(self, pkg):
        sc = pkg.self_cleaning
        out = sc.clean_events([_aux_ev(pkg, "buy", "u1", 1), _aux_ev(pkg, "buy", "u2", 40)],
                              sc.EventWindow(duration=dt.timedelta(days=30)))
        assert [e.entity_id for e in out] == ["u1"]
        e = _aux_ev(pkg, "buy", "u1", 1, target="i1")
        assert len(sc.clean_events([e, e, _aux_ev(pkg, "buy", "u2", 1)], sc.EventWindow(remove_duplicates=True))) == 2

    def test_compress_set_chain(self, pkg):
        sc = pkg.self_cleaning
        events = [_aux_ev(pkg, "$set", "u1", 3, {"a": 1, "b": 2}), _aux_ev(pkg, "$unset", "u1", 2, {"a": 1}),
                  _aux_ev(pkg, "$set", "u1", 1, {"c": 3}), _aux_ev(pkg, "buy", "u1", 1, target="i1")]
        out = sc.clean_events(events, sc.EventWindow(compress_properties=True))
        sets = [e for e in out if e.event == "$set"]
        assert len(sets) == 1 and _props(sets[0].properties) == {"b": 2, "c": 3}
        assert len([e for e in out if e.event == "buy"]) == 1
        deleted = [_aux_ev(pkg, "$set", "u1", 3, {"a": 1}), _aux_ev(pkg, "$delete", "u1", 1)]
        assert sc.clean_events(deleted, sc.EventWindow(compress_properties=True)) == []

    def test_clean_persisted(self, pkg):
        storage = pkg.Storage(env=MEMORY_ENV)
        app_id = storage.get_meta_data_apps().insert(pkg.App(0, "cleanapp"))
        levents = storage.get_l_events()
        levents.insert_batch([_aux_ev(pkg, "$set", "u1", 3, {"a": 1}), _aux_ev(pkg, "$set", "u1", 2, {"b": 2}),
                              _aux_ev(pkg, "buy", "u1", 50, target="i1"), _aux_ev(pkg, "buy", "u1", 1, target="i2")],
                             app_id)

        class DS(pkg.self_cleaning.SelfCleaningDataSource):
            event_window = pkg.self_cleaning.EventWindow(duration=dt.timedelta(days=30), compress_properties=True)

        assert DS().clean_persisted_events(pkg.context(storage, "cleanapp")) == 2
        remaining = list(levents.find(app_id))
        assert len(remaining) == 2
        assert _props([e for e in remaining if e.event == "$set"][0].properties) == {"a": 1, "b": 2}


@pytest.mark.parametrize("window", [
    {"duration": dt.timedelta(days=30)},
    {"remove_duplicates": True},
    {"compress_properties": True},
    {"duration": dt.timedelta(days=45), "remove_duplicates": True, "compress_properties": True},
], ids=["window", "dedup", "compress", "all"])
def test_self_cleaning_equals_the_reference(window):
    """Seeded events (a chain of $set/$unset/$delete per user, repeats,
    rates up to 60 days old): ``clean_events`` and ``cleaned_events`` /
    ``clean_persisted_events`` on each package's memory store leave the
    same events."""
    out = {}
    # one clock reading for both packages: read per package, a second's
    # tick between them shifted every event time of the second one
    now = pkg_modules("port").self_cleaning.now_utc().replace(microsecond=0)
    for name in PACKAGES:
        m = pkg_modules(name)
        events = _seeded_events(m, 3, t0=now - dt.timedelta(days=60))
        w = m.self_cleaning.EventWindow(**window)
        cleaned = sorted(json_key(_wire(e)) for e in m.self_cleaning.clean_events(events, w))
        storage = m.Storage(env=MEMORY_ENV)
        app_id = storage.get_meta_data_apps().insert(m.App(0, "cleanapp"))
        storage.get_l_events().insert_batch(events, app_id)

        class DS(m.self_cleaning.SelfCleaningDataSource):
            event_window = w

        ctx = m.context(storage, "cleanapp")
        read = sorted(json_key(_wire(e)) for e in DS().cleaned_events(ctx))
        n = DS().clean_persisted_events(ctx)
        stored = sorted(json_key(_wire(e)) for e in storage.get_l_events().find(app_id))
        out[name] = (cleaned, read, n, stored)
    assert out["port"] == out["jax"]
    assert out["port"][2] == len(out["port"][3]) > 10


def json_key(d: dict) -> str:
    import json

    return json.dumps(d, sort_keys=True)


# ---------------------------------------------------------------------------
# BinaryVectorizer (tests/test_e2.py) and BiMap (tests/test_storage.py)
# ---------------------------------------------------------------------------


class TestBinaryVectorizer:
    def test_fit_transform(self, pkg):
        v = pkg.BinaryVectorizer.fit([{"color": "red", "size": "L"}, {"color": "blue"}])
        assert v.n_features == 3
        assert v.transform({"color": "red", "size": "L"}).sum() == 2.0
        assert v.transform({"color": "green"}).sum() == 0.0

    def test_property_filter(self, pkg):
        assert pkg.BinaryVectorizer.fit([{"a": "1", "b": "2"}], properties=["a"]).n_features == 1


@pytest.mark.parametrize("properties", [None, ["p0", "p2", "p5"]])
def test_binary_vectorizer_equals_the_reference(properties):
    rng = np.random.default_rng(4)
    maps = [{f"p{int(j)}": (str(int(rng.integers(4))) if rng.random() < 0.7 else int(rng.integers(4)))
             for j in rng.choice(8, int(rng.integers(0, 5)), replace=False)} for _ in range(200)]
    probes = maps[:50] + [{"p0": "9", "p1": "0"}, {}]
    out = {}
    for name in PACKAGES:
        v = pkg_modules(name).BinaryVectorizer.fit(maps, properties=properties)
        out[name] = (v.index, np.stack([v.transform(m) for m in probes]))
    assert out["port"][0] == out["jax"][0] and len(out["port"][0]) > 5
    np.testing.assert_array_equal(out["port"][1], out["jax"][1])
    assert out["port"][1].dtype == out["jax"][1].dtype == np.float32


class TestBiMap:
    def test_string_int_dense(self, pkg):
        bm = pkg.BiMap.string_int(["b", "a", "b", "c"])
        assert bm("b") == 0 and bm("a") == 1 and bm("c") == 2 and len(bm) == 3

    def test_inverse(self, pkg):
        inv = pkg.BiMap.string_int(["x", "y"]).inverse()
        assert inv(0) == "x" and inv(1) == "y"

    def test_unique_values_enforced(self, pkg):
        with pytest.raises(ValueError):
            pkg.BiMap({"a": 1, "b": 1})

    def test_misc(self, pkg):
        bm = pkg.BiMap.string_int(["a", "b", "c"])
        assert bm.contains("a") and not bm.contains("z")
        assert bm.get_or_else("z", -1) == -1
        assert bm.take(2).to_map() == {"a": 0, "b": 1}


def test_bimap_equals_the_reference():
    rng = np.random.default_rng(6)
    keys = [f"k{int(k)}" for k in rng.zipf(1.5, 2_000) % 700]
    out = {}
    for name in PACKAGES:
        bm = pkg_modules(name).BiMap.string_int(keys)
        inv = bm.inverse()
        out[name] = (bm.to_map(), inv.to_map(), bm.take(17).to_map(), [bm.get(k) for k in ("k1", "nope")],
                     [inv(i) for i in range(len(bm))], list(bm), bm == pkg_modules(name).BiMap(bm.to_map()))
    assert out["port"] == out["jax"]
