"""Shared by the serving-contract and resilience tests of the port: the
sample engine behind both packages' query servers, both packages' event
servers on a memory store, the JAX package's aiohttp apps on a real socket
(so one scenario drives either package over HTTP), a keep-alive client, a
self-signed certificate and a collector of background POSTs."""

from __future__ import annotations

import asyncio
import contextlib
import http.client
import json
import socket
import ssl
import subprocess
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

PACKAGES = ("jax", "port")
MEMORY_ENV = {
    "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
}


class JsonQuery:
    """The sample engine's query with the /queries.json codec: a payload
    without ``qid`` fails to decode with ``KeyError('qid')``."""

    def __init__(self, qid: int):
        self.qid = qid

    @classmethod
    def from_json_dict(cls, d):
        return cls(qid=int(d["qid"]))


def algo_class(pkg: str):
    """The sample algorithm class a test patches to inject faults."""
    if pkg == "jax":
        from tests.sample_engine import Algo0
    else:
        from tests.torch_sample_engine import Algo0
    return Algo0


def patch_both(monkeypatch, name: str, make):
    """Patch ``name`` on both packages' sample algorithm, ``make(original)``
    giving the replacement."""
    for pkg in PACKAGES:
        cls = algo_class(pkg)
        monkeypatch.setattr(cls, name, make(getattr(cls, name)))


@contextlib.contextmanager
def aiohttp_served(app, ssl_context=None):
    """Run an aiohttp app on 127.0.0.1 from a loop on its own thread;
    yields (port, run, runner), ``run`` executing a coroutine on that loop."""
    from aiohttp import web

    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def run(coro, timeout: float = 30.0):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)

    runner = web.AppRunner(app, access_log=None)
    run(runner.setup())
    site = web.TCPSite(runner, "127.0.0.1", 0, ssl_context=ssl_context)
    run(site.start())
    try:
        yield runner.addresses[0][1], run, runner
    finally:
        run(runner.cleanup())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)
        loop.close()


@contextlib.contextmanager
def query_server(pkg: str, plugin_context=None, **cfg):
    """The sample engine (model ``Model0(3, 1, 2)``, instance
    ``inst-resil``) behind ``pkg``'s query server; yields (port, server,
    run), ``run`` None for the port."""
    cfg.setdefault("request_timeout_s", 0.5)
    cfg.setdefault("shed_retry_after_s", 1.0)
    if pkg == "jax":
        from predictionio_tpu.controller import Engine
        from predictionio_tpu.workflow.create_server import QueryServer, ServerConfig
        from predictionio_tpu.workflow.engine_loader import EngineManifest
        from tests.sample_engine import Algo0, DataSource0, Model0, Preparator0, Serving0
        from tests.test_engine import params

        engine = Engine({"ds": DataSource0}, {"prep": Preparator0}, {"a": Algo0}, {"s": Serving0},
                        query_class=JsonQuery)
        server = QueryServer(
            engine=engine, engine_params=params(), models=[Model0(3, 1, 2)],
            manifest=EngineManifest("resil", "1", "engine.json", "tests.test_engine.make_engine"),
            instance_id="inst-resil", config=ServerConfig(**cfg), plugin_context=plugin_context,
        )
        tls = server.config.ssl_context()
        with aiohttp_served(server.make_app(), tls) as (port, run, runner):
            server._runner = runner  # the drain closes the runner's sites
            yield port, server, run
        return
    from predictionio_tpu_torch.controller.engine import Engine
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.workflow.context import WorkflowContext
    from predictionio_tpu_torch.workflow.create_server import QueryServer, ServerConfig
    from predictionio_tpu_torch.workflow.engine_loader import EngineManifest
    from tests.torch_sample_engine import Algo0, DataSource0, Model0, Preparator0, Serving0

    engine = Engine({"ds": DataSource0}, {"prep": Preparator0}, {"a": Algo0}, {"s": Serving0},
                    query_class=JsonQuery)
    ep = engine.engine_params_from_variant({"algorithms": [{"name": "a", "params": {"id": 3}}]})
    ctx = WorkflowContext(mode="serving", device="cpu", _storage=Storage(env=MEMORY_ENV))
    server = QueryServer(
        engine, ep, [Model0(3, 1, 2)], ctx, ServerConfig(ip="127.0.0.1", port=0, **cfg), "inst-resil",
        manifest=EngineManifest("resil", "1", "engine.json", "tests.test_engine.make_engine"),
        plugin_context=plugin_context,
    )
    port = server.start()
    try:
        yield port, server, None
    finally:
        server.shutdown()


def batcher(server):
    return getattr(server, "batcher", None) or server._batcher


@contextlib.contextmanager
def event_server(pkg: str, **cfg):
    """``pkg``'s event server on a memory store with one app, its
    ``levents`` behind a FaultInjector of that package; yields (port,
    server, injector, access key)."""
    cfg.setdefault("storage_retries", 3)
    cfg.setdefault("storage_backoff_s", 0.001)
    cfg.setdefault("breaker_threshold", 3)
    cfg.setdefault("breaker_recovery_s", 0.2)
    if pkg == "jax":
        from predictionio_tpu.data.api.event_server import EventServer, EventServerConfig
        from predictionio_tpu.data.storage.base import AccessKey, App
        from predictionio_tpu.data.storage.registry import Storage
        from predictionio_tpu.resilience import FaultInjector
    else:
        from predictionio_tpu_torch.data.api.event_server import EventServer, EventServerConfig
        from predictionio_tpu_torch.data.storage.base import AccessKey, App
        from predictionio_tpu_torch.data.storage.registry import Storage
        from predictionio_tpu_torch.resilience import FaultInjector
    storage = Storage(env=MEMORY_ENV)
    app_id = storage.get_meta_data_apps().insert(App(0, "chaosapp"))
    key = storage.get_meta_data_access_keys().insert(AccessKey("", app_id, ()))
    if pkg == "jax":
        server = EventServer(storage=storage, config=EventServerConfig(**cfg))
    else:
        server = EventServer(storage=storage, config=EventServerConfig(ip="127.0.0.1", port=0, **cfg))
    injector = FaultInjector(server.levents)
    server.levents = injector
    if pkg == "jax":
        with aiohttp_served(server.make_app(), server.config.ssl_context()) as (port, *_):
            yield port, server, injector, key
        return
    port = server.start()
    try:
        yield port, server, injector, key
    finally:
        server.shutdown()


class Client:
    """A keep-alive client of one server (HTTPS when ``cafile`` is
    given); ``call`` returns (status, Retry-After or None, decoded body)."""

    def __init__(self, port: int, cafile: str | None = None, timeout: float = 30.0):
        if cafile:
            ctx = ssl.create_default_context(cafile=cafile)
            ctx.check_hostname = False
            self.conn = http.client.HTTPSConnection("127.0.0.1", port, context=ctx, timeout=timeout)
        else:
            self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)

    def call(self, method: str, path: str, body=None, headers=None, raw: bytes | None = None):
        headers = dict(headers or {})
        data = raw
        if body is not None:
            data = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        self.conn.request(method, path, body=data, headers=headers)
        resp = self.conn.getresponse()
        text = resp.read()
        try:
            decoded = json.loads(text)
        except ValueError:
            decoded = text.decode()
        return resp.status, resp.getheader("Retry-After"), decoded

    def close(self) -> None:
        self.conn.close()


def call(port: int, method: str, path: str, body=None, **kw):
    """One request on a connection of its own."""
    client = Client(port, **{k: kw.pop(k) for k in ("cafile", "timeout") if k in kw})
    try:
        return client.call(method, path, body, **kw)
    finally:
        client.close()


def wait_until(pred, timeout: float = 10.0, what: str = "condition") -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"{what} never held within {timeout} s")
        time.sleep(0.01)


@pytest.fixture(scope="session")
def tls_cert(tmp_path_factory):
    """A self-signed certificate for 127.0.0.1 from openssl: (cert, key)."""
    d = tmp_path_factory.mktemp("tls")
    cert, key = d / "cert.pem", d / "key.pem"
    out = subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-days", "1",
                          "-subj", "/CN=127.0.0.1", "-keyout", str(key), "-out", str(cert)],
                         capture_output=True)
    if out.returncode != 0:
        pytest.skip("openssl cannot make a test certificate here")
    return str(cert), str(key)


class Collector:
    """A plain HTTP server that records every POST (path with query,
    content type, body) and answers 201 ``{}``: a stand-in event server
    or remote-log collector. With ``delay_s`` each POST is recorded and
    answered that long after it arrived (until :meth:`close`): a slow or,
    with a delay past the test, a silent event server."""

    def __init__(self, delay_s: float = 0.0):
        self.received: list[tuple[str, str, bytes]] = []
        received = self.received
        release = self._release = threading.Event()

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def do_POST(self):
                body = self.rfile.read(int(self.headers.get("Content-Length") or 0))
                if delay_s and release.wait(delay_s):
                    return  # closed: the silent server never answered
                received.append((self.path, self.headers.get("Content-Type", ""), body))
                self.send_response(201)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def close(self) -> None:
        self._release.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(10)


@contextlib.contextmanager
def silent_client(port: int):
    """A TCP connection that sends nothing (no TLS ClientHello)."""
    sock = socket.create_connection(("127.0.0.1", port), timeout=5)
    try:
        yield sock
    finally:
        sock.close()
