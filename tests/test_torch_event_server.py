"""The port's event server (``predictionio_tpu_torch/data/api/
event_server.py``, standard library only) on the CPU.

The JAX package's REST contract tests (tests/test_event_server.py, ref
EventServiceSpec.scala + SegmentIOAuthSpec.scala) run against the port's
server on a memory store; one request sequence sent to the JAX aiohttp
server and to the port's server gets the same status codes and JSON bodies,
generated event ids and clock times aside; and the whole ingest path runs
through the port's CLI in subprocesses on sqlite: ``app new``,
``accesskey new``, ``eventserver``, ``POST /batch/events.json``, ``train``,
``deploy`` and ``POST /queries.json``, with neither JAX, the JAX package nor
aiohttp in any of those processes."""

import base64
import contextlib
import http.client
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.parse
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from predictionio_tpu_torch.data.api.event_server import (  # noqa: E402
    EventServer,
    EventServerConfig,
)
from predictionio_tpu_torch.data.storage.base import AccessKey, App, Channel  # noqa: E402
from predictionio_tpu_torch.data.storage.registry import Storage  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
MEMORY_ENV = {
    "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
}


def make_storage() -> tuple[Storage, str]:
    storage = Storage(env=MEMORY_ENV)
    app_id = storage.get_meta_data_apps().insert(App(0, "testapp"))
    key = storage.get_meta_data_access_keys().insert(AccessKey("", app_id, ()))
    return storage, key


class Client:
    """A keep-alive HTTP client of one server: ``call`` returns the status
    and the decoded body (JSON, else text)."""

    def __init__(self, port: int):
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)

    def call(self, method, path, json_body=None, form=None, headers=None, raw=None):
        headers = dict(headers or {})
        body = raw
        if json_body is not None:
            body = json.dumps(json_body).encode()
            headers["Content-Type"] = "application/json"
        elif form is not None:
            body = urllib.parse.urlencode(form).encode()
            headers["Content-Type"] = "application/x-www-form-urlencoded"
        self.conn.request(method, path, body=body, headers=headers)
        resp = self.conn.getresponse()
        data = resp.read()
        try:
            return resp.status, json.loads(data)
        except ValueError:
            return resp.status, data.decode()

    def get(self, path, **kw):
        return self.call("GET", path, **kw)

    def post(self, path, **kw):
        return self.call("POST", path, **kw)

    def delete(self, path, **kw):
        return self.call("DELETE", path, **kw)


@contextlib.contextmanager
def serving(stats: bool = False, storage_and_key=None):
    storage, key = storage_and_key or make_storage()
    server = EventServer(storage=storage, config=EventServerConfig(ip="127.0.0.1", port=0,
                                                                   stats=stats))
    port = server.start()
    try:
        yield Client(port), key, storage
    finally:
        server.shutdown()


EVENT = {"event": "rate", "entityType": "user", "entityId": "u1"}


# ---------------------------------------------------------------------------
# the JAX package's contract tests, against the port
# ---------------------------------------------------------------------------


def test_root_alive():
    with serving() as (client, key, storage):
        assert client.get("/") == (200, {"status": "alive"})


def test_post_event_created():
    with serving() as (client, key, storage):
        status, data = client.post(f"/events.json?accessKey={key}", json_body=EVENT)
        assert status == 201 and "eventId" in data
        app_id = storage.get_meta_data_apps().get_by_name("testapp").id
        stored = storage.get_l_events().get(data["eventId"], app_id)
        assert stored is not None and stored.event == "rate"


def test_post_event_missing_auth():
    with serving() as (client, key, storage):
        assert client.post("/events.json", json_body=EVENT) == (401, {"message": "Missing accessKey."})


def test_post_event_wrong_key():
    with serving() as (client, key, storage):
        assert client.post("/events.json?accessKey=WRONG", json_body=EVENT)[0] == 401


def test_post_event_basic_auth_header():
    with serving() as (client, key, storage):
        creds = base64.b64encode(f"{key}:".encode()).decode()
        status, _ = client.post("/events.json", json_body=EVENT,
                                headers={"Authorization": f"Basic {creds}"})
        assert status == 201


def test_post_event_invalid_payload():
    with serving() as (client, key, storage):
        status, _ = client.post(f"/events.json?accessKey={key}",
                                json_body={"event": "$custom", "entityType": "user", "entityId": "u1"})
        assert status == 400


def test_allowed_events_enforced():
    storage, _ = make_storage()
    app_id = storage.get_meta_data_apps().get_by_name("testapp").id
    restricted = storage.get_meta_data_access_keys().insert(AccessKey("", app_id, ("view",)))
    with serving(storage_and_key=(storage, restricted)) as (client, key, storage):
        assert client.post(f"/events.json?accessKey={restricted}", json_body=EVENT)[0] == 403
        ok, _ = client.post(f"/events.json?accessKey={restricted}", json_body={**EVENT, "event": "view"})
        assert ok == 201


def test_channel_routing():
    storage, key = make_storage()
    app_id = storage.get_meta_data_apps().get_by_name("testapp").id
    storage.get_meta_data_channels().insert(Channel(0, "mobile", app_id))
    with serving(storage_and_key=(storage, key)) as (client, key, storage):
        assert client.post(f"/events.json?accessKey={key}&channel=mobile", json_body=EVENT)[0] == 201
        assert client.post(f"/events.json?accessKey={key}&channel=nope", json_body=EVENT)[0] == 401
        # channel events are isolated from the default channel
        assert client.get(f"/events.json?accessKey={key}")[0] == 404
        assert client.get(f"/events.json?accessKey={key}&channel=mobile")[0] == 200


def test_get_events_filters_and_limit():
    with serving() as (client, key, storage):
        for i in range(25):
            client.post(f"/events.json?accessKey={key}",
                        json_body={"event": "rate", "entityType": "user", "entityId": f"u{i}"})
        status, data = client.get(f"/events.json?accessKey={key}")
        assert status == 200 and len(data) == 20  # default limit
        assert len(client.get(f"/events.json?accessKey={key}&limit=5")[1]) == 5
        data = client.get(f"/events.json?accessKey={key}&entityId=u3")[1]
        assert len(data) == 1 and data[0]["entityId"] == "u3"


def test_get_events_reversed_requires_entity():
    with serving() as (client, key, storage):
        client.post(f"/events.json?accessKey={key}", json_body=EVENT)
        assert client.get(f"/events.json?accessKey={key}&reversed=true")[0] == 400
        ok = client.get(f"/events.json?accessKey={key}&reversed=true&entityType=user&entityId=u1")
        assert ok[0] == 200


def test_get_delete_single_event():
    with serving() as (client, key, storage):
        eid = client.post(f"/events.json?accessKey={key}", json_body=EVENT)[1]["eventId"]
        status, got = client.get(f"/events/{eid}.json?accessKey={key}")
        assert status == 200 and got["entityId"] == "u1"
        assert client.delete(f"/events/{eid}.json?accessKey={key}") == (200, {"message": "Found"})
        assert client.get(f"/events/{eid}.json?accessKey={key}")[0] == 404
        assert client.delete(f"/events/{eid}.json?accessKey={key}")[0] == 404


def test_batch_events():
    with serving() as (client, key, storage):
        batch = [EVENT, {"event": "$custom", "entityType": "user", "entityId": "u2"},
                 {**EVENT, "entityId": "u3"}]
        status, results = client.post(f"/batch/events.json?accessKey={key}", json_body=batch)
        assert status == 200
        assert [r["status"] for r in results] == [201, 400, 201]
        assert "eventId" in results[0] and "message" in results[1]


def test_batch_cap_50():
    with serving() as (client, key, storage):
        assert client.post(f"/batch/events.json?accessKey={key}", json_body=[EVENT] * 51)[0] == 400
        status, results = client.post(f"/batch/events.json?accessKey={key}", json_body=[EVENT] * 50)
        assert status == 200 and len(results) == 50


def test_stats_disabled_and_enabled():
    with serving(stats=False) as (client, key, storage):
        assert client.get(f"/stats.json?accessKey={key}")[0] == 404
    with serving(stats=True) as (client, key, storage):
        client.post(f"/events.json?accessKey={key}", json_body=EVENT)
        status, data = client.get(f"/stats.json?accessKey={key}")
        assert status == 200
        assert data["longLive"]["statusCode"] == [{"status": 201, "count": 1}]
        assert data["longLive"]["basic"][0]["event"] == "rate"


def test_webhook_segmentio():
    with serving() as (client, key, storage):
        payload = {"version": "2", "type": "track", "userId": "seg-user", "event": "Signed Up",
                   "properties": {"plan": "Pro"}, "timestamp": "2024-01-01T00:00:00.000Z"}
        assert client.post(f"/webhooks/segmentio.json?accessKey={key}", json_body=payload)[0] == 201
        app_id = storage.get_meta_data_apps().get_by_name("testapp").id
        (e,) = list(storage.get_l_events().find(app_id))
        assert e.event == "track" and e.entity_id == "seg-user"
        assert e.properties.get("properties") == {"plan": "Pro"}


def test_webhook_unknown_connector():
    with serving() as (client, key, storage):
        assert client.post(f"/webhooks/nonexistent.json?accessKey={key}", json_body={})[0] == 404


def test_webhook_bad_payload():
    with serving() as (client, key, storage):
        status, _ = client.post(f"/webhooks/segmentio.json?accessKey={key}",
                                json_body={"type": "track"})
        assert status == 400


MAILCHIMP_SUBSCRIBE = {
    "type": "subscribe", "fired_at": "2009-03-26 21:35:57", "data[id]": "8a25ff1d98",
    "data[list_id]": "a6b5da1054", "data[email]": "api@mailchimp.com",
    "data[email_type]": "html", "data[merges][EMAIL]": "api@mailchimp.com",
    "data[merges][FNAME]": "MailChimp", "data[merges][LNAME]": "API",
    "data[ip_opt]": "10.20.10.30", "data[ip_signup]": "10.20.10.30",
}


def test_webhook_form_mailchimp():
    with serving() as (client, key, storage):
        assert client.post(f"/webhooks/mailchimp?accessKey={key}", form=MAILCHIMP_SUBSCRIBE)[0] == 201
        app_id = storage.get_meta_data_apps().get_by_name("testapp").id
        (e,) = list(storage.get_l_events().find(app_id))
        assert e.event == "subscribe"
        assert e.entity_id == "8a25ff1d98" and e.target_entity_id == "a6b5da1054"
        assert e.event_time.year == 2009


def test_plugins_json():
    with serving() as (client, key, storage):
        status, data = client.get("/plugins.json")
        assert status == 200 and "inputblockers" in data["plugins"]


def test_explicit_empty_plugin_list_disables_registry():
    from predictionio_tpu_torch.data.api.plugins import (
        _REGISTRY,
        INPUT_BLOCKER,
        EventServerPlugin,
        EventServerPluginContext,
    )

    class Blocker(EventServerPlugin):
        plugin_name = "global-blocker"
        plugin_type = INPUT_BLOCKER

        def process(self, event_info, context):
            raise RuntimeError("blocked")

    b = Blocker()
    _REGISTRY.append(b)
    try:
        assert EventServerPluginContext(plugins=[]).input_blockers == {}
        assert "global-blocker" in EventServerPluginContext().input_blockers
    finally:
        _REGISTRY.remove(b)


def test_input_blocker_rejects_and_sniffer_sees():
    from predictionio_tpu_torch.data.api.plugins import (
        INPUT_BLOCKER,
        EventServerPlugin,
        EventServerPluginContext,
    )

    seen = []

    class Blocker(EventServerPlugin):
        plugin_name, plugin_type = "no-buy", INPUT_BLOCKER

        def process(self, info, context):
            if info.event.event == "buy":
                raise RuntimeError("buy is blocked")

    class Sniffer(EventServerPlugin):
        plugin_name = "sniff"

        def process(self, info, context):
            seen.append(info.event.entity_id)

        def handle_rest(self, app_id, channel_id, args):
            return {"seen": len(seen), "args": args}

    storage, key = make_storage()
    server = EventServer(storage=storage, config=EventServerConfig(ip="127.0.0.1", port=0),
                         plugin_context=EventServerPluginContext([Blocker(), Sniffer()]))
    client = Client(server.start())
    try:
        assert client.post(f"/events.json?accessKey={key}",
                           json_body={**EVENT, "event": "buy"}) == (403, {"message": "buy is blocked"})
        status, results = client.post(f"/batch/events.json?accessKey={key}",
                                      json_body=[EVENT, {**EVENT, "event": "buy", "entityId": "u9"}])
        assert [r["status"] for r in results] == [201, 403]
        assert seen == ["u1"]
        assert client.get(f"/plugins/inputsniffer/sniff/a/b?accessKey={key}") == (
            200, {"seen": 1, "args": ["a", "b"]})
    finally:
        server.shutdown()


def test_batch_failure_mid_batch_stores_each_event_once():
    """A batch request inserts event by event, as the JAX server does: an
    insert that fails partway through the batch answers 500 for its event
    alone, the events before and after it answer 201, and every stored
    event is stored once, under the id its 201 reported."""
    storage, key = make_storage()
    server = EventServer(storage=storage, config=EventServerConfig(ip="127.0.0.1", port=0))
    real_insert = server.levents.insert

    def insert_some(event, *a):
        if event.entity_id == "u2":
            raise RuntimeError("disk full")
        return real_insert(event, *a)

    server.levents.insert = insert_some
    client = Client(server.start())
    try:
        batch = [{**EVENT, "entityId": f"u{k}"} for k in range(5)] + [{"event": "$x"}]
        status, results = client.post(f"/batch/events.json?accessKey={key}", json_body=batch)
        assert status == 200
        assert [r["status"] for r in results] == [201, 201, 500, 201, 201, 400]
        assert results[2]["message"] == "disk full"
        app_id = storage.get_meta_data_apps().get_by_name("testapp").id
        stored = list(storage.get_l_events().find(app_id))
        assert sorted(e.event_id for e in stored) == sorted(
            r["eventId"] for r in results if r["status"] == 201)
        assert sorted(e.entity_id for e in stored) == ["u0", "u1", "u3", "u4"]
    finally:
        server.shutdown()


def test_unknown_path_and_method():
    with serving() as (client, key, storage):
        assert client.get("/nope") == (404, "404: Not Found")
        assert client.post("/") == (405, "405: Method Not Allowed")
        assert client.delete(f"/events.json?accessKey={key}") == (405, "405: Method Not Allowed")


def test_tls(tmp_path):
    """The server speaks TLS with a cert and key, and refuses half a pair."""
    ssl = pytest.importorskip("ssl")
    cert, key_file = tmp_path / "c.pem", tmp_path / "k.pem"
    out = subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-days", "1",
                          "-subj", "/CN=127.0.0.1", "-keyout", str(key_file), "-out", str(cert)],
                         capture_output=True)
    if out.returncode != 0:
        pytest.skip("openssl cannot make a test certificate here")
    with pytest.raises(ValueError, match="TLS misconfigured"):
        EventServerConfig(ssl_certfile=str(cert)).ssl_context()
    storage, key = make_storage()
    server = EventServer(storage=storage, config=EventServerConfig(
        ip="127.0.0.1", port=0, ssl_certfile=str(cert), ssl_keyfile=str(key_file)))
    port = server.start()
    try:
        ctx = ssl.create_default_context(cafile=str(cert))
        ctx.check_hostname = False
        conn = http.client.HTTPSConnection("127.0.0.1", port, context=ctx, timeout=30)
        conn.request("GET", "/")
        assert json.loads(conn.getresponse().read()) == {"status": "alive"}
    finally:
        server.shutdown()


# ---------------------------------------------------------------------------
# the same request sequence against the JAX server and the port's
# ---------------------------------------------------------------------------


def _sequence(key, restricted):
    t = "2024-01-01T00:00:{:02d}.000Z".format
    ev = lambda k, **kw: {"event": "rate", "entityType": "user", "entityId": f"u{k % 3}",  # noqa: E731
                          "targetEntityType": "item", "targetEntityId": f"i{k}",
                          "properties": {"rating": k % 5 + 1}, "eventTime": t(k), **kw}
    basic = base64.b64encode(f"{key}:".encode()).decode()
    seg = {"version": "2", "type": "track", "userId": "seg", "event": "Signed Up",
           "properties": {"plan": "Pro"}, "timestamp": "2024-01-02T00:00:00.000Z"}
    return [
        ("GET", "/", {}),
        ("POST", "/events.json", {"json_body": ev(0)}),
        ("POST", "/events.json?accessKey=WRONG", {"json_body": ev(0)}),
        ("POST", f"/events.json?accessKey={key}", {"json_body": ev(1)}),
        ("POST", f"/events.json?accessKey={key}", {"json_body": ev(2, eventId="e-2")}),
        ("POST", f"/events.json?accessKey={key}", {"json_body": ev(3, eventTime="2024-01-01T08:00:03.500+08:00")}),
        ("POST", f"/events.json?accessKey={key}", {"json_body": {"event": "$custom", "entityType": "user", "entityId": "u"}}),
        ("POST", f"/events.json?accessKey={key}", {"json_body": {"event": "rate", "entityType": "user"}}),
        ("POST", f"/events.json?accessKey={key}", {"raw": b"not json"}),
        ("POST", f"/events.json?accessKey={restricted}", {"json_body": ev(4)}),
        ("POST", f"/events.json?accessKey={restricted}", {"json_body": ev(5, event="view")}),
        ("POST", "/events.json", {"json_body": ev(6), "headers": {"Authorization": f"Basic {basic}"}}),
        ("POST", f"/events.json?accessKey={key}&channel=mobile", {"json_body": ev(7)}),
        ("POST", f"/events.json?accessKey={key}&channel=nope", {"json_body": ev(8)}),
        ("POST", f"/batch/events.json?accessKey={key}", {"json_body": [
            ev(9), {"event": "$custom", "entityType": "user", "entityId": "u"}, ev(10, eventId="e-10"),
            ev(11, event="$set", targetEntityType=None, targetEntityId=None), "junk"]}),
        ("POST", f"/batch/events.json?accessKey={restricted}", {"json_body": [ev(12), ev(13, event="view")]}),
        ("POST", f"/batch/events.json?accessKey={key}", {"json_body": [ev(14)] * 51}),
        ("POST", f"/batch/events.json?accessKey={key}", {"json_body": {"not": "a list"}}),
        ("GET", f"/events.json?accessKey={key}", {}),
        ("GET", f"/events.json?accessKey={key}&limit=2&entityType=user&entityId=u1&reversed=true", {}),
        ("GET", f"/events.json?accessKey={key}&reversed=true", {}),
        ("GET", f"/events.json?accessKey={key}&startTime=bad", {}),
        ("GET", f"/events.json?accessKey={key}&limit=x", {}),
        ("GET", f"/events.json?accessKey={key}&startTime=2024-01-01T00:00:02.000Z&untilTime=2024-01-01T00:00:09.000Z", {}),
        ("GET", f"/events.json?accessKey={key}&event=view&targetEntityId=i13", {}),
        ("GET", f"/events.json?accessKey={key}&channel=mobile", {}),
        ("GET", f"/events.json?accessKey={key}&entityId=nobody", {}),
        ("GET", f"/events/e-2.json?accessKey={key}", {}),
        ("DELETE", f"/events/e-2.json?accessKey={key}", {}),
        ("GET", f"/events/e-2.json?accessKey={key}", {}),
        ("DELETE", f"/events/e-2.json?accessKey={key}", {}),
        ("GET", "/events/e-10.json", {}),
        ("POST", f"/webhooks/segmentio.json?accessKey={key}", {"json_body": seg}),
        ("GET", f"/webhooks/segmentio.json?accessKey={key}", {}),
        ("POST", f"/webhooks/segmentio.json?accessKey={key}", {"json_body": {"type": "track"}}),
        ("POST", f"/webhooks/nonexistent.json?accessKey={key}", {"json_body": {}}),
        ("POST", f"/webhooks/mailchimp?accessKey={key}", {"form": MAILCHIMP_SUBSCRIBE}),
        ("POST", f"/webhooks/mailchimp?accessKey={key}", {"form": {"type": "bogus"}}),
        ("GET", f"/webhooks/mailchimp?accessKey={key}", {}),
        ("GET", f"/webhooks/examplejson?accessKey={key}", {}),
        ("POST", f"/webhooks/exampleform?accessKey={restricted}", {"form": {"type": "userAction", "userId": "x"}}),
        ("GET", "/plugins.json", {}),
        ("GET", f"/plugins/inputblocker/none/x?accessKey={key}", {}),
        ("GET", f"/stats.json?accessKey={key}", {}),
        ("GET", f"/stats.json?accessKey={restricted}", {}),
    ]


def _seeded_storage(storage_cls, app_cls, key_cls, channel_cls):
    storage = storage_cls(env=MEMORY_ENV)
    app_id = storage.get_meta_data_apps().insert(app_cls(0, "testapp"))
    storage.get_meta_data_access_keys().insert(key_cls("key-all", app_id, ()))
    storage.get_meta_data_access_keys().insert(key_cls("key-view", app_id, ("view",)))
    storage.get_meta_data_channels().insert(channel_cls(0, "mobile", app_id))
    return storage


_GENERATED_ID = re.compile(r"^[0-9a-f]{32}$")


def _normalised(body):
    """Generated event ids and the stats windows' clock times masked."""
    if isinstance(body, list):
        return [_normalised(b) for b in body]
    if isinstance(body, dict):
        out = {}
        for k, v in body.items():
            if k == "eventId" and isinstance(v, str) and _GENERATED_ID.match(v):
                v = "<generated>"
            elif k in ("startTime", "endTime") and "basic" in body:
                v = "<clock>"
            out[k] = _normalised(v)
        return out
    return body


def test_same_requests_get_the_same_answers_from_the_jax_server():
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    from predictionio_tpu.data.api.event_server import EventServer as JaxServer
    from predictionio_tpu.data.api.event_server import EventServerConfig as JaxConfig
    from predictionio_tpu.data.storage import base as jax_base
    from predictionio_tpu.data.storage.registry import Storage as JaxStorage

    sequence = _sequence("key-all", "key-view")

    async def jax_answers():
        storage = _seeded_storage(JaxStorage, jax_base.App, jax_base.AccessKey, jax_base.Channel)
        server = JaxServer(storage=storage, config=JaxConfig(stats=True, sampler_period_s=0))
        client = TestClient(TestServer(server.make_app()))
        await client.start_server()
        out = []
        try:
            for method, path, kw in sequence:
                data = kw.get("raw")
                if "json_body" in kw:
                    data = json.dumps(kw["json_body"])
                elif "form" in kw:
                    data = kw["form"]
                resp = await client.request(method, path, data=data, headers=kw.get("headers"))
                text = await resp.text()
                try:
                    body = json.loads(text)
                except ValueError:
                    body = text
                out.append((resp.status, body))
        finally:
            await client.close()
        return out

    want = asyncio.run(jax_answers())
    storage = _seeded_storage(Storage, App, AccessKey, Channel)
    server = EventServer(storage=storage, config=EventServerConfig(ip="127.0.0.1", port=0, stats=True))
    client = Client(server.start())
    try:
        got = [client.call(method, path, **kw) for method, path, kw in sequence]
    finally:
        server.shutdown()
    statuses = [s for s, _ in want]
    assert {200, 201, 400, 401, 403, 404} <= set(statuses)
    for (method, path, _), g, w in zip(sequence, got, want):
        assert (g[0], _normalised(g[1])) == (w[0], _normalised(w[1])), (method, path)


# ---------------------------------------------------------------------------
# the ingest path through the port's CLI, on sqlite, in clean processes
# ---------------------------------------------------------------------------

_LAUNCH = """
import atexit, json, runpy, sys
OUT = sys.argv.pop(1)
def _modules():
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "aiohttp")
           or m == "predictionio_tpu" or m.startswith("predictionio_tpu.")]
    with open(OUT, "w") as fh:
        json.dump(bad, fh)
atexit.register(_modules)
sys.argv[0] = "pio-torch"
runpy.run_module("predictionio_tpu_torch.tools.cli", run_name="__main__")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_alive(proc, port, err_path, timeout=120):
    deadline = time.monotonic() + timeout
    while True:
        assert proc.poll() is None, Path(err_path).read_text()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=2)
            conn.request("GET", "/")
            if conn.getresponse().status == 200:
                return
        except OSError:
            pass
        assert time.monotonic() < deadline, "server never answered"
        time.sleep(0.2)


def _stop(proc):
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    return proc.returncode


def test_cli_ingest_train_deploy_query_on_sqlite_without_jax(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
           "PIO_FS_BASEDIR": str(tmp_path / "store")}
    for k in [k for k in env if k.startswith("PIO_STORAGE_")]:
        env.pop(k)
    modules = []

    def argv(*args):
        path = tmp_path / f"modules_{len(modules)}.json"
        modules.append(path)
        return [sys.executable, "-c", _LAUNCH, str(path), *args]

    def run(*args):
        out = subprocess.run(argv(*args), env=env, capture_output=True, text=True, timeout=180)
        assert out.returncode == 0, out.stderr
        return out.stdout

    assert "Created a new app" in run("app", "new", "restapp")
    key = re.search(r"Created new access key: (\S+)", run("accesskey", "new", "restapp")).group(1)
    assert key in run("accesskey", "list", "restapp")

    port = _free_port()
    err = tmp_path / "eventserver.err"
    with open(err, "w") as fh:
        server = subprocess.Popen(argv("eventserver", "--ip", "127.0.0.1", "--port", str(port), "--stats"),
                                  env=env, stdout=subprocess.DEVNULL, stderr=fh)
    try:
        _wait_alive(server, port, err)
        client = Client(port)
        rng = np.random.default_rng(5)
        events = [{"event": "rate", "entityType": "user", "entityId": f"u{int(rng.integers(30))}",
                   "targetEntityType": "item", "targetEntityId": f"i{int(rng.integers(20))}",
                   "properties": {"rating": float(rng.integers(1, 6))},
                   "eventTime": f"2024-04-01T00:{k // 60:02d}:{k % 60:02d}.000Z"} for k in range(400)]
        for i in range(0, len(events), 50):
            status, results = client.post(f"/batch/events.json?accessKey={key}", json_body=events[i:i + 50])
            assert status == 200 and [r["status"] for r in results] == [201] * len(results)
        status, got = client.get(f"/events.json?accessKey={key}&limit=-1")
        assert status == 200 and len(got) == 400
        stats = client.get(f"/stats.json?accessKey={key}")[1]
        assert stats["longLive"]["statusCode"] == [{"status": 201, "count": 400}]
    finally:
        assert _stop(server) == 0, err.read_text()

    engine_dir = tmp_path / "engine"
    engine_dir.mkdir()
    (engine_dir / "engine.json").write_text(json.dumps({
        "id": "rest-test",
        "engineFactory": "predictionio_tpu_torch.models.recommendation.engine.engine_factory",
        "datasource": {"params": {"appName": "restapp"}},
        "algorithms": [{"name": "als", "params": {"rank": 4, "numIterations": 4, "lambda": 0.05}}],
    }))
    assert "Training completed" in run("train", "--engine-dir", str(engine_dir), "--device", "cpu")
    port = _free_port()
    err = tmp_path / "deploy.err"
    with open(err, "w") as fh:
        deploy = subprocess.Popen(argv("deploy", "--engine-dir", str(engine_dir), "--device", "cpu",
                                       "--ip", "127.0.0.1", "--port", str(port)),
                                  env=env, stdout=subprocess.DEVNULL, stderr=fh)
    try:
        _wait_alive(deploy, port, err)
        client = Client(port)
        for u in range(30):
            status, body = client.post("/queries.json", json_body={"user": f"u{u}", "num": 3})
            assert status == 200 and len(body["itemScores"]) == 3
    finally:
        assert _stop(deploy) == 0, err.read_text()
    assert len(modules) == 6
    for path in modules:
        assert json.loads(path.read_text()) == [], path.name


def test_the_port_imports_no_aiohttp_and_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(aiohttp|jax|jaxlib|predictionio_tpu)(\s|\.|$)")
    offenders = []
    for path in [*sorted((REPO / "predictionio_tpu_torch").rglob("*.py")), REPO / "chip_smoke.py"]:
        for n, line in enumerate(path.read_text().splitlines(), 1):
            if pattern.match(line):
                offenders.append(f"{path.relative_to(REPO)}:{n}: {line.strip()}")
    assert offenders == []
