"""The port's property aggregation and by-entity reads against the JAX
package's, on the CPU.

One seeded JSON-lines file of events goes into the JAX package's memory
store (``import_events``) and the port's ``LocalStore``:
``aggregate_properties`` must give the same entities in the same order
with the same properties and update times, with and without ``required``
and time windows; ``find_by_entity`` the same events in the same order,
under every filter and limit. Also: the port's entity index sees an event
appended after its first read, and the DataMap copy keeps the reference's
getters.
"""

import datetime as dt
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from predictionio_tpu.data.storage.base import App  # noqa: E402
from predictionio_tpu.data.store.event_store import LEventStore, PEventStore  # noqa: E402
from predictionio_tpu.tools.import_export import import_events  # noqa: E402
from predictionio_tpu_torch.data.datamap import DataMap, DataMapError  # noqa: E402
from predictionio_tpu_torch.data.event import Event  # noqa: E402
from predictionio_tpu_torch.data.store import LocalStore  # noqa: E402

APP = "aggapp"
UTC = dt.timezone.utc
T0 = dt.datetime(2024, 5, 1, tzinfo=UTC)


def _time(sec: int) -> str:
    return (T0 + dt.timedelta(seconds=int(sec))).isoformat(timespec="milliseconds").replace(
        "+00:00", "Z")


def _events(seed=0, n=400):
    """A shuffled stream of $set/$unset/$delete on users and items (some at
    one shared time), constraint $sets, and user -> item events."""
    rng = np.random.default_rng(seed)
    keys = ["a", "b", "c", "categories"]
    out = []
    for k in range(n):
        kind = rng.choice(["$set", "$set", "$set", "$unset", "$delete", "view", "buy"])
        etype = str(rng.choice(["user", "item"]))
        eid = f"{etype[0]}{int(rng.integers(12))}"
        ev = {"eventId": f"e{k:04d}", "entityType": etype, "entityId": eid,
              # a tenth of the events share times with others
              "eventTime": _time(int(rng.integers(40)) if k % 10 == 0 else 100 + k * 7 + int(rng.integers(5)))}
        if kind == "$set":
            props = {str(key): int(rng.integers(100)) for key in rng.choice(keys, 2, replace=False)}
            if "categories" in props:
                props["categories"] = [f"c{int(x)}" for x in rng.integers(0, 5, 2)]
            ev.update(event="$set", properties=props)
        elif kind == "$unset":
            ev.update(event="$unset", properties={str(rng.choice(keys)): None})
        elif kind == "$delete":
            ev.update(event="$delete")
        else:
            ev.update(event=str(kind), entityType="user", entityId=f"u{int(rng.integers(12))}",
                      targetEntityType="item", targetEntityId=f"i{int(rng.integers(12))}")
        out.append(ev)
    for k, items in enumerate((["i1", "i2"], ["i3"])):
        out.append({"eventId": f"c{k}", "event": "$set", "entityType": "constraint",
                    "entityId": "unavailableItems", "properties": {"items": items},
                    "eventTime": _time(5000 + k)})
    rng.shuffle(out)
    return out


@pytest.fixture
def stores(memory_storage, tmp_path):
    path = tmp_path / "events.jsonl"
    path.write_text("".join(json.dumps(e) + "\n" for e in _events()))
    memory_storage.get_meta_data_apps().insert(App(0, APP))
    import_events(str(path), APP, storage=memory_storage)
    store = LocalStore(tmp_path / "home")
    store.create_app(APP)
    store.import_file(APP, str(path))
    return memory_storage, store


def _same_property_maps(got, want):
    assert list(got) == list(want)  # same entities, same order
    for key in want:
        assert got[key].fields == want[key].fields, key
        assert got[key].first_updated == want[key].first_updated, key
        assert got[key].last_updated == want[key].last_updated, key


@pytest.mark.parametrize(
    "entity_type,required,window",
    [("user", None, None), ("item", None, None), ("item", ["a"], None),
     ("user", ["a", "b"], None), ("item", None, (200, 1500)), ("user", ["c"], (0, 900)),
     ("constraint", None, None), ("nobody", None, None)],
)
def test_aggregate_properties_matches_jax(stores, entity_type, required, window):
    storage, store = stores
    start, until = ((T0 + dt.timedelta(seconds=s) for s in window) if window else (None, None))
    want = PEventStore(storage).aggregate_properties(
        APP, entity_type=entity_type, start_time=start, until_time=until, required=required)
    got = store.aggregate_properties(
        APP, entity_type=entity_type, start_time=start, until_time=until, required=required)
    _same_property_maps(got, want)
    if entity_type in ("user", "item") and window is None:
        assert len(got) >= 3  # the stream leaves some entities standing
    if required:
        assert all(set(required) <= pm.keyset() for pm in got.values())


@pytest.mark.parametrize(
    "kw",
    [{}, {"limit": 1}, {"limit": 3}, {"limit": -1}, {"latest": False},
     {"event_names": ["view"]}, {"event_names": ["$set", "$unset"], "limit": 2},
     {"target_entity_type": "item"}, {"target_entity_type": None},
     {"target_entity_id": "i3"}, {"start_time": 300, "until_time": 2000},
     {"event_names": ["buy", "view"], "latest": False, "limit": 4}],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "all",
)
@pytest.mark.parametrize("entity", [("user", "u3"), ("item", "i4"), ("user", "u11"),
                                    ("constraint", "unavailableItems"), ("user", "nobody")])
def test_find_by_entity_matches_jax(stores, entity, kw):
    storage, store = stores
    kw = dict(kw)
    for key in ("start_time", "until_time"):
        if key in kw:
            kw[key] = T0 + dt.timedelta(seconds=kw[key])
    want = list(LEventStore(storage).find_by_entity(APP, entity[0], entity[1], **kw))
    got = store.find_by_entity(APP, entity[0], entity[1], **kw)
    assert [e.to_json_dict() for e in got] == [e.to_json_dict() for e in want]


def test_find_by_entity_sees_events_appended_after_its_first_read(tmp_path):
    store = LocalStore(tmp_path)
    store.create_app(APP)
    first = Event("$set", "constraint", "unavailableItems", properties={"items": ["i1"]},
                  event_time=T0)
    store.append(APP, [first])
    assert store.find_by_entity(APP, "constraint", "unavailableItems", limit=1)[0].properties == {
        "items": ["i1"]}
    # another writer (a second store on the same root) appends; a half line
    # still being written is not read until it is whole
    other = LocalStore(tmp_path)
    other.append(APP, [Event("$set", "constraint", "unavailableItems",
                             properties={"items": ["i2"]}, event_time=T0 + dt.timedelta(1))])
    path = other._events_path(APP)
    with open(path, "a") as fh:
        fh.write('{"event": "view", "entityType": "user"')
    got = store.find_by_entity(APP, "constraint", "unavailableItems", limit=1)
    assert got[0].properties == {"items": ["i2"]}
    with open(path, "a") as fh:
        fh.write(', "entityId": "u1", "eventId": "x", "eventTime": "2024-05-02T00:00:00.000Z"}\n')
    assert [e.event_id for e in store.find_by_entity(APP, "user", "u1")] == ["x"]


def test_datamap_getters_follow_the_reference():
    dm = DataMap({"a": 1, "n": None, "l": [1, 2]})
    assert dm.get("a") == 1 and dm.get_opt("n") is None and dm.get_or_else("n", 5) == 5
    assert dm.get("missing", 7) == 7 and dm.get_list("l") == [1, 2]
    with pytest.raises(DataMapError):
        dm.get("n")
    with pytest.raises(DataMapError):
        dm.get("missing")
    assert dm.union({"a": 2}).get("a") == 2 and "a" not in dm.diff(["a"])
