"""Request bodies on the port's standard-library servers
(``predictionio_tpu_torch/utils/httpbody.py``): the reader itself on chunk
extensions, trailers, a truncated chunk, a bad size and the limit; then the
same raw bytes over one socket to a JAX aiohttp server and to the port's
counterpart (the event server, the query server, the fleet gateway and the
admin server): a chunked POST followed by ``GET /`` on the same
connection, ``Content-Length: -1`` and ``Content-Length: abc``. Both must
give the same statuses, and the same JSON bodies where they answer JSON.
Every socket has a timeout of a few seconds, so a server that hangs fails
the test instead of stalling the suite."""

from __future__ import annotations

import contextlib
import io
import json
import socket

import pytest

pytest.importorskip("torch")

from predictionio_tpu_torch.utils.httpbody import (  # noqa: E402
    BodyError,
    BodyTooLarge,
    framing,
    read_body,
)
from tests.torch_serving_helpers import (  # noqa: E402
    MEMORY_ENV,
    PACKAGES,
    aiohttp_served,
    event_server,
    query_server,
)

SOCKET_TIMEOUT_S = 5.0


# ---------------------------------------------------------------------------
# the reader
# ---------------------------------------------------------------------------


def _read(raw: bytes, limit=None, **headers):
    rfile = io.BufferedReader(io.BytesIO(raw))
    body = read_body({k.replace("_", "-"): v for k, v in headers.items()}, rfile, limit)
    return body, rfile.read()


def test_chunk_extensions_and_trailers_are_read_past():
    raw = (b"5;name=value\r\nhello\r\n7 ; ext\r\n, world\r\n0;last\r\n"
           b"X-Checksum: abc\r\nX-Other: 1\r\n\r\nGET / HTTP/1.1\r\n")
    body, rest = _read(raw, Transfer_Encoding="chunked")
    assert body == b"hello, world"
    assert rest == b"GET / HTTP/1.1\r\n"  # the next request is left whole


def test_upper_case_hex_and_coding_name():
    body, rest = _read(b"A\r\n0123456789\r\n0\r\n\r\n", Transfer_Encoding=" Chunked")
    assert (body, rest) == (b"0123456789", b"")


def test_content_length_reads_exactly_its_bytes():
    assert _read(b"abcdefGET", Content_Length="6") == (b"abcdef", b"GET")
    assert _read(b"GET", Content_Length=" 0 ") == (b"", b"GET")
    assert _read(b"GET") == (b"", b"GET")


@pytest.mark.parametrize("raw, what", [
    (b"5\r\nhel", "truncated body"),
    (b"5\r\nhello\r\n", "truncated chunked body"),
    (b"5\r\nhelloXY0\r\n\r\n", "not followed by CRLF"),
    (b"5", "truncated chunked body"),
    (b"-5\r\nhello\r\n0\r\n\r\n", "invalid chunk size"),
    (b"0x5\r\nhello\r\n0\r\n\r\n", "invalid chunk size"),
    (b"\r\n", "invalid chunk size"),
    (b"5\r\nhello\r\n0\r\nX-Trailer: 1\r\n", "truncated chunked body"),
], ids=["cut-in-data", "cut-before-last-chunk", "no-crlf", "cut-in-size", "negative-size",
        "0x-size", "empty-size", "cut-in-trailers"])
def test_a_bad_or_truncated_chunked_body_is_a_400(raw, what):
    with pytest.raises(BodyError, match=what) as info:
        _read(raw, Transfer_Encoding="chunked")
    assert info.value.status == 400 and not isinstance(info.value, BodyTooLarge)


def test_an_overlong_chunk_size_line_is_a_400():
    with pytest.raises(BodyError, match="line too long"):
        _read(b"5" + b" " * 70_000 + b"\r\nhello\r\n0\r\n\r\n", Transfer_Encoding="chunked")


def test_an_oversized_chunked_body_is_a_413_before_the_chunk_past_the_limit_is_read():
    raw = b"8\r\n12345678\r\n8\r\nabcdefgh\r\n" + b"0\r\n\r\n"
    with pytest.raises(BodyTooLarge) as info:
        _read(raw, limit=12, Transfer_Encoding="chunked")
    assert (info.value.status, info.value.length, info.value.limit) == (413, 16, 12)
    assert _read(raw, limit=16, Transfer_Encoding="chunked")[0] == b"12345678abcdefgh"
    assert _read(raw, limit=0, Transfer_Encoding="chunked")[0] == b"12345678abcdefgh"  # 0: no limit


def test_an_oversized_content_length_is_a_413_without_reading():
    rfile = io.BufferedReader(io.BytesIO(b"x" * 100))
    with pytest.raises(BodyTooLarge) as info:
        read_body({"Content-Length": "100"}, rfile, 99)
    assert info.value.length == 100 and rfile.read() == b"x" * 100


@pytest.mark.parametrize("headers, what", [
    ({"Content-Length": "-1"}, "invalid Content-Length"),
    ({"Content-Length": "abc"}, "invalid Content-Length"),
    ({"Content-Length": "+5"}, "invalid Content-Length"),
    ({"Content-Length": "5.0"}, "invalid Content-Length"),
    ({"Content-Length": "٥"}, "invalid Content-Length"),  # a digit, not an ASCII one
    ({"Transfer-Encoding": "gzip"}, "unsupported Transfer-Encoding"),
    ({"Transfer-Encoding": "gzip, chunked"}, "unsupported Transfer-Encoding"),
    ({"Transfer-Encoding": "chunked", "Content-Length": "5"}, "beside Transfer-Encoding"),
], ids=["negative", "letters", "plus", "decimal", "arabic-digit", "gzip", "gzip-then-chunked", "both"])
def test_bad_framing_is_a_400_before_anything_is_read(headers, what):
    with pytest.raises(BodyError, match=what) as info:
        framing(headers)
    assert info.value.status == 400


# ---------------------------------------------------------------------------
# the same raw bytes to both packages' servers
# ---------------------------------------------------------------------------


def _responses(port: int, data: bytes, n: int) -> list:
    """Send ``data`` on one connection and read up to ``n`` responses:
    (status, content type, body) each, the body decoded when JSON. Fails
    if no answer comes within the socket timeout."""
    out = []
    with socket.create_connection(("127.0.0.1", port), timeout=SOCKET_TIMEOUT_S) as sock:
        sock.sendall(data)
        f = sock.makefile("rb")
        for _ in range(n):
            try:
                line = f.readline()
            except socket.timeout:
                pytest.fail(f"no answer within {SOCKET_TIMEOUT_S} s after {out}")
            if not line:
                break
            headers = {}
            while (h := f.readline()) not in (b"\r\n", b"\n", b""):
                k, v = h.decode("latin-1").split(":", 1)
                headers[k.strip().lower()] = v.strip()
            body = f.read(int(headers.get("content-length", "0")))
            ctype = headers.get("content-type", "").split(";")[0]
            out.append((int(line.split()[1]), ctype, json.loads(body) if ctype == "application/json" else None))
    return out


def _chunked(path: str, payload, chunk: int = 7) -> bytes:
    body = json.dumps(payload).encode()
    pieces = b"".join(f"{len(body[i:i + chunk]):x};piece={i}\r\n".encode() + body[i:i + chunk] + b"\r\n"
                      for i in range(0, len(body), chunk))
    return (f"POST {path} HTTP/1.1\r\nHost: 127.0.0.1\r\nContent-Type: application/json\r\n"
            f"Transfer-Encoding: chunked\r\n\r\n").encode() + pieces + b"0\r\n\r\n"


def _with_length(path: str, length: str, payload) -> bytes:
    return (f"POST {path} HTTP/1.1\r\nHost: 127.0.0.1\r\nContent-Type: application/json\r\n"
            f"Content-Length: {length}\r\n\r\n").encode() + json.dumps(payload).encode()


GET_ROOT = b"GET / HTTP/1.1\r\nHost: 127.0.0.1\r\nConnection: close\r\n\r\n"


def _script(port: int, path: str, payload, *, root_body: bool) -> dict:
    """The three cases on ``port``: a chunked POST then GET / on one
    connection, Content-Length -1, Content-Length abc."""
    chunked = _responses(port, _chunked(path, payload) + GET_ROOT, 2)
    if not root_body and len(chunked) == 2:  # GET / carries the server's live state
        chunked[1] = chunked[1][:2]
    return {
        "chunked_then_get": chunked,
        "length_-1": [r[:1] for r in _responses(port, _with_length(path, "-1", payload), 1)],
        "length_abc": [r[:1] for r in _responses(port, _with_length(path, "abc", payload), 1)],
    }


def _mask(script: dict, key: str) -> dict:
    """Event ids and access keys are random: keep their shape."""
    def mask(body):
        if isinstance(body, dict):
            return {k: (len(v) if k in (key,) else mask(v)) for k, v in body.items()}
        return body
    return {case: [tuple(mask(x) for x in r) for r in rs] for case, rs in script.items()}


def _event_server_script(pkg):
    with event_server(pkg) as (port, _, _, key):
        event = {"event": "rate", "entityType": "user", "entityId": "u1", "targetEntityType": "item",
                 "targetEntityId": "i1", "properties": {"rating": 4}}
        return _mask(_script(port, f"/events.json?accessKey={key}", event, root_body=True), "eventId")


def _query_server_script(pkg):
    with query_server(pkg, result_cache_size=0) as (port, _, _):
        return _script(port, "/queries.json", {"qid": 2}, root_body=False)


def _gateway_script(pkg):
    from tests.test_torch_fleet import GATEWAYS, FakeReplica, poll

    fake = FakeReplica("r0")
    h = GATEWAYS[pkg](replica_urls=(fake.url,), probe_interval_s=0.05, probe_timeout_s=1.0,
                      request_timeout_s=5.0)
    try:
        poll(lambda: all(r.ever_ready for r in h.gw.replicas), "first probe pass")
        return _script(h.port, "/queries.json", {"user": "u1", "num": 3}, root_body=False)
    finally:
        h.close()
        fake.stop()


@contextlib.contextmanager
def _admin(pkg, registry):
    if pkg == "jax":
        from predictionio_tpu.data.storage.registry import Storage
        from predictionio_tpu.tools.admin_api import AdminServer

        admin = AdminServer(storage=Storage(env=MEMORY_ENV), registry_dir=registry)
        with aiohttp_served(admin.make_app()) as (port, _, _):
            yield port
        return
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.tools.admin_api import AdminServer

    admin = AdminServer(storage=Storage(env=MEMORY_ENV), registry_dir=registry)
    port = admin.start("127.0.0.1", 0)
    try:
        yield port
    finally:
        admin.shutdown()


SERVERS = {
    "event_server": _event_server_script,
    "query_server": _query_server_script,
    "gateway": _gateway_script,
}


@pytest.mark.parametrize("server", sorted(SERVERS))
def test_the_ports_servers_read_bodies_as_the_aiohttp_ones(server):
    got = {pkg: SERVERS[server](pkg) for pkg in PACKAGES}
    assert got["port"] == got["jax"]
    chunked = got["port"]["chunked_then_get"]
    assert [r[0] for r in chunked][1:] == [200], chunked  # GET / answered on the same connection
    assert got["port"]["length_-1"] == got["port"]["length_abc"] == [(400,)]


def test_the_admin_server_reads_bodies_as_the_aiohttp_one(tmp_path):
    got = {}
    for pkg in PACKAGES:
        with _admin(pkg, str(tmp_path / f"registry_{pkg}")) as port:
            got[pkg] = _mask(_script(port, "/cmd/app", {"name": "chunkedapp"}, root_body=False),
                             "accessKey")
    assert got["port"] == got["jax"]
    assert [r[0] for r in got["port"]["chunked_then_get"]] == [201, 200]
    assert got["port"]["length_-1"] == got["port"]["length_abc"] == [(400,)]


@pytest.mark.parametrize("server", ["event_server", "query_server", "gateway"])
def test_a_chunked_body_past_the_limit_is_a_413(server):
    """The 413 limits hold for chunked bodies: each server answers its own
    413 to a chunked body past its limit and closes the connection."""
    pad = {"pad": "x" * 2048}
    if server == "event_server":
        import predictionio_tpu_torch.data.api.event_server as es

        with event_server("port") as (port, _, _, key), pytest.MonkeyPatch.context() as mp:
            mp.setattr(es, "MAX_BODY_BYTES", 1024)
            (status, _, body), = _responses(port, _chunked(f"/events.json?accessKey={key}", pad, 512)
                                            + GET_ROOT, 2)
        assert (status, body) == (413, {"message": "payload too large"})
    elif server == "query_server":
        with query_server("port", result_cache_size=0, max_payload_bytes=1024) as (port, _, _):
            (status, _, body), = _responses(port, _chunked("/queries.json", pad, 512) + GET_ROOT, 2)
        assert status == 413 and body["message"].startswith("query payload too large (")
    else:
        from tests.test_torch_fleet import FakeReplica, PortGatewayThread, poll

        fake = FakeReplica("r0")
        h = PortGatewayThread(replica_urls=(fake.url,), probe_interval_s=0.05, max_payload_bytes=1024)
        try:
            poll(lambda: all(r.ever_ready for r in h.gw.replicas), "first probe pass")
            (status, _, body), = _responses(h.port, _chunked("/queries.json", pad, 512) + GET_ROOT, 2)
        finally:
            h.close()
            fake.stop()
        assert (status, body, fake.queries) == (413, {"message": "query payload too large"}, 0)
