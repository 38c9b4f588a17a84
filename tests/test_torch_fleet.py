"""The port's serving fleet (``predictionio_tpu_torch/fleet/``) held to the
JAX package's: federation text byte-equal for the same scrapes, the
supervisor's ladders and parks under the reference's fake processes and
clock, worker argv, ``pick_replica``'s choices under scripted states, the
gateway's HTTP answers against stdlib fake replicas (the JAX gateway on an
event loop thread, the port's on its own threads), its metric families,
thread-safe picks, and real ``deploy --fleet`` processes of the port's CLI
on the CPU."""

from __future__ import annotations

import asyncio
import concurrent.futures
import http.client
import inspect
import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import predictionio_tpu.fleet.federation as jax_federation
import predictionio_tpu.fleet.gateway as jax_gateway
import predictionio_tpu.fleet.launch as jax_launch
import predictionio_tpu.fleet.supervisor as jax_supervisor
import predictionio_tpu_torch.fleet.federation as pt_federation
import predictionio_tpu_torch.fleet.gateway as pt_gateway
import predictionio_tpu_torch.fleet.launch as pt_launch
import predictionio_tpu_torch.fleet.supervisor as pt_supervisor
import tests.test_fleet as ref_fleet
from predictionio_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from predictionio_tpu_torch.obs.metrics import MetricsRegistry as PortRegistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("jax", "port")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def free_ports(n: int) -> int:
    """A base port whose next ``n`` ports are free: a fleet's gateway, then
    its workers. Below Linux's ephemeral range (32768 up), so a client
    polling a port nobody listens on yet is never handed that port as its
    own source port (a TCP self-connect reads back its own request)."""
    rng = random.Random()
    for _ in range(200):
        base = rng.randrange(20_000, 32_000 - n)
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise AssertionError(f"no {n} free consecutive ports")


def poll(cond, what: str, deadline_s: float = 10.0) -> None:
    deadline = time.monotonic() + deadline_s
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.02)


# ---------------------------------------------------------------------------
# running a reference test through one package
# ---------------------------------------------------------------------------


def normalize(value, tmp: str):
    """Drop process ids and the per-package tmp directory from a recorded
    value, so the two packages' traces compare."""
    if isinstance(value, dict):
        return {k: normalize(v, tmp) for k, v in value.items() if k != "pid"}
    if isinstance(value, (list, tuple)):
        return [normalize(v, tmp) for v in value]
    if isinstance(value, str):
        return value.replace(tmp, "<tmp>")
    return value


def metrics_lines(registry) -> list[str]:
    """The exposition without wall-clock gauges."""
    return [ln for ln in registry.render_prometheus().splitlines() if "_unix" not in ln]


def recording_supervisor(base, trace: list, tmp: str):
    """``base`` (either package's Supervisor) recording its snapshot and
    exposition after every public step, and every hook call."""

    class RecordingSupervisor(base):
        def __init__(self, *args, **kw):
            for hook in ("on_crash", "on_host_down"):
                fn = kw.get(hook)
                if fn is not None:
                    def wrapped(info, fn=fn, hook=hook):
                        trace.append((hook, normalize(dict(info), tmp)))
                        return fn(info)

                    kw[hook] = wrapped
            super().__init__(*args, **kw)

        def _record(self, what, *extra):
            trace.append((what, *extra, normalize(self.snapshot(), tmp), metrics_lines(self.metrics)))

        def start(self):
            super().start()
            self._record("start")

        def tick(self):
            super().tick()
            self._record("tick")

        def add_worker(self, spec):
            super().add_worker(spec)
            self._record("add", spec.name)

        def retire_worker(self, name):
            ok = super().retire_worker(name)
            self._record("retire", name, ok)
            return ok

        def stop(self):
            super().stop()
            self._record("stop")

    return RecordingSupervisor


def run_reference(monkeypatch, module, names: dict, cls_name: str, test_name: str, tmp_path) -> None:
    """One test method of a reference suite with ``names`` patched into
    its module."""
    with monkeypatch.context() as m:
        for name, value in names.items():
            m.setattr(module, name, value)
        method = getattr(getattr(module, cls_name)(), test_name)
        params = inspect.signature(method).parameters
        kwargs = {}
        if "tmp_path" in params:
            kwargs["tmp_path"] = tmp_path
        if "monkeypatch" in params:
            kwargs["monkeypatch"] = m
        method(**kwargs)


def reference_tests(module, prefix: str, skip=()) -> list[tuple[str, str]]:
    out = []
    for cls_name in sorted(n for n in dir(module) if n.startswith(prefix)):
        for test_name in sorted(n for n in dir(getattr(module, cls_name)) if n.startswith("test_")):
            if test_name not in skip:
                out.append((cls_name, test_name))
    return out


def supervisor_names(which: str, trace: list, tmp: str) -> dict:
    mod = jax_supervisor if which == "jax" else pt_supervisor
    return {
        "Supervisor": recording_supervisor(mod.Supervisor, trace, tmp),
        "SupervisorConfig": mod.SupervisorConfig,
        "WorkerSpec": mod.WorkerSpec,
    }


# ---------------------------------------------------------------------------
# federation
# ---------------------------------------------------------------------------


def _histogram_scrapes(registry_cls, exemplar: bool) -> list[str]:
    out = []
    for i in range(3):
        reg = registry_cls()
        h = reg.histogram("pio_request_seconds", "request wall", labelnames=("endpoint",))
        c = reg.counter("pio_requests_total", "requests", labelnames=("endpoint", "status"))
        g = reg.gauge("pio_queue_depth", "queued")
        for k in range(5 + i):
            kw = {"exemplar": f"{i:02d}{k:014x}"} if exemplar else {}
            h.observe(0.0004 * (k + 1) * (i + 1) + 0.1 * (k == 4), endpoint="/queries.json", **kw)
            c.inc(endpoint="/queries.json", status="200")
        c.inc(0.5, endpoint="/queries.json", status="503")
        g.set(1.25 * i)
        out.append(reg.render_prometheus(exemplars=exemplar))
    return out


FEDERATION_CASES = {
    "counters": lambda cls: [
        'pio_requests_total{endpoint="/q",status="200"} 3\n',
        'pio_requests_total{endpoint="/q",status="200"} 4\npio_requests_total{endpoint="/q",status="503"} 1\n',
    ],
    "disjoint": lambda cls: ["only_a 1\n", "only_b 2\n"],
    "openmetrics_text": lambda cls: [
        '# TYPE pio_phase_seconds histogram\n'
        'pio_phase_seconds_bucket{le="0.01",phase="fetch"} 5 # {trace_id="aaa"} 0.003\n'
        'pio_phase_seconds_bucket{le="+Inf",phase="fetch"} 7 # {trace_id="bbb"} 0.2\n'
        'pio_phase_seconds_sum{phase="fetch"} 0.5\npio_phase_seconds_count{phase="fetch"} 7\n# EOF\n',
        '# TYPE pio_phase_seconds histogram\n'
        'pio_phase_seconds_bucket{le="0.01",phase="fetch"} 3 # {trace_id="ccc"} 0.003\n'
        'pio_phase_seconds_bucket{le="+Inf",phase="fetch"} 7 # {trace_id="bbb"} 0.2\n'
        'pio_phase_seconds_sum{phase="fetch"} 0.1\npio_phase_seconds_count{phase="fetch"} 7\n# EOF\n',
    ],
    "registries": lambda cls: _histogram_scrapes(cls, exemplar=False),
    "registries_with_exemplars": lambda cls: _histogram_scrapes(cls, exemplar=True),
    "escaped_labels": lambda cls: [
        'x_total{path="a\\"b\\\\c",q="x\\ny"} 1.5\n',
        'x_total{path="a\\"b\\\\c",q="x\\ny"} 2.25\nx_total{path="other"} 1e-05\n',
    ],
}


@pytest.mark.parametrize("exemplars", [False, True], ids=["plain", "exemplars"])
@pytest.mark.parametrize("case", sorted(FEDERATION_CASES))
def test_federation_is_byte_equal_to_the_reference(case, exemplars):
    """The same scrapes (each package's own registry rendering them where
    the case builds registries) merge into byte-equal text, with and
    without exemplar clauses carried."""
    texts_jax = FEDERATION_CASES[case](JaxRegistry)
    texts_port = FEDERATION_CASES[case](PortRegistry)
    assert texts_port == texts_jax
    merged = {
        "jax": jax_federation.federate_metrics(texts_jax, exemplars=exemplars),
        "port": pt_federation.federate_metrics(texts_port, exemplars=exemplars),
    }
    assert merged["port"] == merged["jax"]
    assert merged["port"].endswith("# EOF\n") == exemplars


# ---------------------------------------------------------------------------
# supervisor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cls_name,test_name", reference_tests(ref_fleet, "TestSupervisor"))
def test_supervisor_ladders_equal_the_reference(cls_name, test_name, monkeypatch, tmp_path):
    """tests/test_fleet.py's TestSupervisor under its FakeProc/FakeClock:
    the same snapshot and exposition after every tick, start and stop
    (restart ladders, parks, TERM-then-KILL), and the reference's
    assertions hold for the port."""
    got = {}
    for which in PACKAGES:
        trace: list = []
        base = tmp_path / which
        base.mkdir()
        run_reference(monkeypatch, ref_fleet, supervisor_names(which, trace, str(base)),
                      cls_name, test_name, base)
        got[which] = trace
    assert got["port"] == got["jax"]
    assert got["port"]


def test_supervisor_run_ticks_on_its_thread_until_stop():
    """The port's run() is a blocking loop on a thread: it restarts a
    crashed worker, and stop() ends it and the workers."""
    spawned = []

    def spawn(spec):
        p = ref_fleet.FakeProc()
        spawned.append(p)
        return p

    sup = pt_supervisor.Supervisor(
        spawn, [pt_supervisor.WorkerSpec("w0", 9000)],
        pt_supervisor.SupervisorConfig(poll_interval_s=0.01, backoff_base_s=0.0, term_grace_s=1.0),
    )
    sup.start()
    t = threading.Thread(target=sup.run, daemon=True)
    t.start()
    spawned[0].exit(1)
    poll(lambda: len(spawned) == 2, "no restart")
    sup.stop()
    t.join(timeout=5)
    assert not t.is_alive()
    assert spawned[-1].terminated and sup.snapshot()[0]["restarts"] == 1


# ---------------------------------------------------------------------------
# worker argv
# ---------------------------------------------------------------------------

ARGVS = [
    ["deploy", "--engine-dir", "eng", "--fleet", "3", "--ip", "0.0.0.0", "--port", "8000",
     "--registry-dir", "reg"],
    ["deploy", "--fleet=3", "--port=8000", "--accesskey=k"],
    ["--home", "h", "deploy", "--engine-dir", "eng", "--fleet", "2", "--autoscale", "--fleet-min", "1",
     "--fleet-max=4", "--cpu-fallback-max", "2", "--autoscale-interval", "0.5", "--port", "8000",
     "--device", "cuda", "--obs-dir", "o", "--hosts", "local:4", "--gateways", "1",
     "--fleet-probe-interval", "0.3", "--registry-sync-interval", "0.2"],
    ["deploy", "--device=cpu", "--fleet", "1", "--lifecycle", "grid.make", "--lifecycle-cadence", "60",
     "--lifecycle-cooldown", "5", "--lifecycle-workers", "0", "--lifecycle-nice", "3",
     "--lifecycle-warm-limit=8", "--lifecycle-app", "app", "--bandit", "thompson"],
]


def _strip_device(argv: list[str]) -> list[str]:
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        if a.split("=", 1)[0] == "--device":
            skip = "=" not in a
            continue
        out.append(a)
    return out


@pytest.mark.parametrize("remote", [False, True], ids=["loopback", "remote"])
@pytest.mark.parametrize("argv", ARGVS, ids=["topology", "equals", "elastic", "lifecycle"])
def test_worker_argv_differs_from_the_reference_only_as_stated(argv, remote):
    """Equal to the JAX worker argv apart from the two stated
    differences: the port's CLI module, and for a cpu-fallback worker
    every ``--device`` dropped and ``--device cpu`` appended."""
    bind = "0.0.0.0" if remote else "127.0.0.1"
    ref = jax_launch.worker_argv(argv, 8003, 0.5, bind_ip=bind)
    assert ref[:3] == [sys.executable, "-m", "predictionio_tpu.tools.cli"]
    device = pt_launch.worker_argv(argv, 8003, 0.5, bind_ip=bind)
    assert device == [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", *ref[3:]]
    cpu = pt_launch.worker_argv(argv, 8003, 0.5, bind_ip=bind, worker_class="cpu-fallback")
    assert cpu == [*device[:3], *_strip_device(ref[3:]), "--device", "cpu"]
    assert cpu.count("--device") == 1


# ---------------------------------------------------------------------------
# gateway routing (no sockets)
# ---------------------------------------------------------------------------

URLS = ("http://127.0.0.1:9101", "http://127.0.0.1:9102", "http://127.0.0.1:9103")


def _make_gateway(which: str, **cfg):
    mod = jax_gateway if which == "jax" else pt_gateway
    return mod.Gateway(mod.GatewayConfig(**cfg))


ROUTING_SCRIPTS = {
    # name: (classes, inflight, healthy, open breakers)
    "equal_load": ((), (0, 0, 0), (1, 1, 1), ()),
    "least_loaded": ((), (3, 1, 2), (1, 1, 1), ()),
    "ties_and_ejected": ((), (1, 1, 0), (1, 1, 0), ()),
    "breaker_open_on_the_low": ((), (0, 2, 2), (1, 1, 1), (0,)),
    "every_breaker_open": ((), (0, 0, 0), (1, 1, 1), (0, 1, 2)),
    "panic": ((), (2, 0, 1), (0, 0, 0), (1,)),
    "cpu_overflow_idle_device": (("device", "device", "cpu-fallback"), (1, 3, 0), (1, 1, 1), ()),
    "cpu_overflow_saturated": (("device", "device", "cpu-fallback"), (4, 5, 1), (1, 1, 1), ()),
    "all_saturated": (("device", "cpu-fallback", "cpu-fallback"), (6, 5, 4), (1, 1, 1), ()),
    "device_breakers_open": (("device", "device", "cpu-fallback"), (0, 0, 2), (1, 1, 1), (0, 1)),
}


@pytest.mark.parametrize("script", sorted(ROUTING_SCRIPTS))
def test_pick_replica_makes_the_reference_choices(script):
    """Scripted in-flight counts, probe health and breaker states: the same
    replica (or none), the same attribution and the same panic/overflow
    counts for 40 sticky keys, each with and without an exclusion."""
    classes, inflight, healthy, open_ = ROUTING_SCRIPTS[script]
    got = {}
    for which in PACKAGES:
        gw = _make_gateway(which, replica_urls=URLS, replica_classes=classes, breaker_threshold=2)
        for r, n, h in zip(gw.replicas, inflight, healthy):
            r.inflight, r.healthy = n, bool(h)
        for i in open_:
            for _ in range(2):
                gw.replicas[i].breaker.record_failure()
        picks = []
        for k in range(40):
            for exclude in (frozenset(), frozenset({gw.replicas[k % 3].name})):
                meta: dict = {}
                chosen = gw.pick_replica(f"user-{k}", exclude=exclude, meta=meta)
                if chosen is not None:
                    chosen.breaker.record_success()
                picks.append((chosen.name if chosen else None, meta))
        got[which] = (picks, gw._m_panic.value(), gw._m_overflow.value(),
                      [r.breaker.snapshot()["state"] for r in gw.replicas])
    assert got["port"] == got["jax"]


# ---------------------------------------------------------------------------
# gateway over HTTP: stdlib fake replicas, both gateways
# ---------------------------------------------------------------------------


class FakeReplica:
    """A stand-in QueryServer on the standard library: answers
    /queries.json with its own name, exposes /healthz (toggleable),
    /metrics, /traces/recent and the rollout admin routes (counted,
    optionally failing); ``gate`` holds queries until set."""

    def __init__(self, name: str):
        self.name = name
        self.reset()
        replica = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _send(self, status, body, ctype="application/json; charset=utf-8"):
                data = body.encode() if isinstance(body, str) else json.dumps(body).encode()
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/healthz":
                    self._send(200 if replica.ready else 503, {"ready": replica.ready})
                elif path == "/metrics":
                    self._send(200, f'pio_requests_total{{endpoint="/queries.json",status="200"}} '
                                    f"{replica.queries}\n", "text/plain; version=0.0.4; charset=utf-8")
                elif path == "/traces/recent":
                    self._send(200, {"spans": []})
                elif path == "/models":
                    self._admin()
                else:
                    self._send(404, {"message": "not found"})

            def _admin(self):
                with replica.lock:
                    replica.admin_hits += 1
                if replica.fail_status:
                    self._send(replica.fail_status, {"message": "injected"})
                else:
                    self._send(200, {"message": "ok", "replica": replica.name})

            def do_POST(self):
                body = self.rfile.read(int(self.headers.get("Content-Length") or 0))
                path = self.path.split("?")[0]
                if path.startswith("/models/"):
                    self._admin()
                    return
                with replica.lock:
                    replica.queries += 1
                    replica.active += 1
                    replica.peak = max(replica.peak, replica.active)
                try:
                    if replica.gate is not None:
                        replica.gate.wait(10)
                    if replica.delay_s:
                        time.sleep(replica.delay_s)
                    if replica.fail_status:
                        self._send(replica.fail_status, {"message": "injected"})
                    else:
                        self._send(200, {"replica": replica.name, "echo": json.loads(body)})
                finally:
                    with replica.lock:
                        replica.active -= 1

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def reset(self) -> None:
        self.lock = threading.Lock()
        self.queries = self.admin_hits = self.active = self.peak = 0
        self.ready = True
        self.fail_status = None
        self.delay_s = 0.0
        self.gate = None

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


class JaxGatewayThread:
    """The reference gateway (aiohttp) on an event loop of its own."""

    def __init__(self, **cfg):
        self.port = free_port()
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

        async def make():
            return jax_gateway.Gateway(jax_gateway.GatewayConfig(ip="127.0.0.1", port=self.port, **cfg))

        self.gw = self.call(make())
        self.call(self.gw.start())

    def call(self, coro, timeout: float = 30.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def drain(self) -> concurrent.futures.Future:
        return asyncio.run_coroutine_threadsafe(self.gw.drain(), self.loop)

    def close(self) -> None:
        self.call(self.gw.stop())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)
        self.loop.close()


class PortGatewayThread:
    def __init__(self, **cfg):
        self.gw = pt_gateway.Gateway(pt_gateway.GatewayConfig(ip="127.0.0.1", port=0, **cfg))
        self.port = self.gw.start()
        self._pool = concurrent.futures.ThreadPoolExecutor(1)

    def drain(self) -> concurrent.futures.Future:
        return self._pool.submit(self.gw.drain)

    def close(self) -> None:
        self.gw.stop()
        self._pool.shutdown()


GATEWAYS = {"jax": JaxGatewayThread, "port": PortGatewayThread}
HEADERS = ("Content-Type", "Retry-After", "Connection")


def request(conn: http.client.HTTPConnection, method: str, path: str, body=None, headers=None) -> dict:
    data = None if body is None else json.dumps(body).encode()
    conn.request(method, path, body=data, headers={"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    raw = resp.read()
    try:
        payload = json.loads(raw)
    except ValueError:
        payload = raw.decode()
    return {
        "status": resp.status,
        "headers": {h: resp.getheader(h) for h in HEADERS},
        "trace": resp.getheader("X-Pio-Trace-Id"),
        "body": payload,
    }


def _case_healthy(h, fakes, conn):
    out = [request(conn, "POST", "/queries.json", {"user": f"u{i}", "num": 3}) for i in range(8)]
    traced = request(conn, "POST", "/queries.json", {"user": "u1"}, {"X-Pio-Trace-Id": "00000000000000ab"})
    assert traced["trace"] == "00000000000000ab" and all(o.pop("trace") for o in out)
    traced.pop("trace")
    out.append(traced)
    out.append([f.queries for f in fakes])
    return out


def _case_5xx_retried(h, fakes, conn):
    fakes[0].fail_status = 500
    out = []
    for i in range(10):
        o = request(conn, "POST", "/queries.json", {"user": f"u{i}"})
        o.pop("trace")
        out.append(o)
    return out, fakes[0].queries, fakes[1].queries, h.gw._m_retries.value(), \
        h.gw.replicas[0].breaker.snapshot()["state"]


def _case_4xx(h, fakes, conn):
    fakes[0].fail_status = fakes[1].fail_status = 400
    out = []
    for i in range(5):
        o = request(conn, "POST", "/queries.json", {"user": f"u{i}"})
        o.pop("trace")
        out.append(o)
    return out, [f.queries for f in fakes], h.gw._m_retries.value(), \
        [r.breaker.snapshot()["state"] for r in h.gw.replicas]


def _case_breakers_open(h, fakes, conn):
    for r in h.gw.replicas:
        for _ in range(h.gw.config.breaker_threshold):
            r.breaker.record_failure()
    o = request(conn, "POST", "/queries.json", {"user": "u"})
    o.pop("trace")
    return o, [f.queries for f in fakes], h.gw._m_no_replica.value()


def _case_panic(h, fakes, conn):
    for f in fakes:
        f.ready = False
    poll(lambda: not any(r.healthy for r in h.gw.replicas), "no ejection")
    o = request(conn, "POST", "/queries.json", {"user": "u"})
    o.pop("trace")
    hz = request(conn, "GET", "/healthz")
    hz.pop("trace")
    return o, hz, h.gw._m_panic.value() >= 1, h.gw._m_ejections.value(replica=h.gw.replicas[0].name)


def _case_admin(h, fakes, conn):
    for f in fakes:
        f.fail_status = 500
    o = request(conn, "POST", "/models/promote", {})
    o.pop("trace")
    u = request(conn, "POST", "/models/nonsense", {})
    u.pop("trace")
    return o, u, sum(f.admin_hits for f in fakes), h.gw._m_retries.value()


def _case_drain(h, fakes, conn):
    fakes[0].delay_s = 0.4
    early = [http.client.HTTPConnection("127.0.0.1", h.port, timeout=10) for _ in range(2)]
    for c in early:  # established keep-alive connections, before the drain
        assert request(c, "GET", "/")["status"] == 200
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        inflight = pool.submit(request, conn, "POST", "/queries.json", {"user": "u"})
        poll(lambda: fakes[0].active == 1, "the first query never reached the replica")
        drain = h.drain()
        poll(lambda: h.gw._draining, "no drain")
        time.sleep(0.1)
        straggler = request(early[0], "POST", "/queries.json", {"user": "v"})
        hz = request(early[1], "GET", "/healthz")
        refused = False
        try:
            request(http.client.HTTPConnection("127.0.0.1", h.port, timeout=5), "GET", "/healthz")
        except ConnectionRefusedError:
            refused = True
        first = inflight.result(10)
        drain.result(10)
    for o in (straggler, hz, first):
        o.pop("trace")
    for c in early:
        c.close()
    return straggler, hz, first, refused, h.gw._inflight_requests


def _case_too_large(h, fakes, conn):
    o = request(conn, "POST", "/queries.json", {"user": "u", "pad": "x" * 200})
    o.pop("trace")
    return o, [f.queries for f in fakes], h.gw._m_responses.value(status="4xx")


HTTP_CASES = {
    "payload_too_large": (_case_too_large, {"max_payload_bytes": 64}),
    "healthy_route": (_case_healthy, {}),
    "replica_5xx_retried_once": (_case_5xx_retried, {"breaker_threshold": 3}),
    "4xx_not_retried": (_case_4xx, {}),
    "every_breaker_open": (_case_breakers_open, {}),
    "panic_routing": (_case_panic, {}),
    "admin_never_retried": (_case_admin, {}),
    "drain": (_case_drain, {"drain_grace_s": 5.0}),
}


@pytest.mark.parametrize("case", sorted(HTTP_CASES))
def test_gateway_answers_like_the_reference(case):
    """Both gateways over the same stdlib fake replicas (one at a time,
    counters reset between): the same statuses, bodies, Content-Type,
    Retry-After and Connection headers, the same replicas reached and the
    same retry, panic and shed counts."""
    fn, cfg = HTTP_CASES[case]
    fakes = [FakeReplica(f"r{i}") for i in range(2 if case != "drain" else 1)]
    got = {}
    try:
        for which in PACKAGES:
            for f in fakes:
                f.reset()
            h = GATEWAYS[which](replica_urls=tuple(f.url for f in fakes), probe_interval_s=0.05,
                                probe_timeout_s=1.0, request_timeout_s=5.0, **cfg)
            conn = http.client.HTTPConnection("127.0.0.1", h.port, timeout=10)
            try:
                poll(lambda: all(r.ever_ready for r in h.gw.replicas), "first probe pass")
                got[which] = fn(h, fakes, conn)
            finally:
                conn.close()
                h.close()
    finally:
        for f in fakes:
            f.stop()
    assert got["port"] == got["jax"]


def test_drain_hangs_up_idle_keep_alive_clients():
    """After drain and stop, a client idling on a keep-alive connection
    reads end of stream: it cannot hold the gateway past its grace."""
    fake = FakeReplica("r0")
    h = PortGatewayThread(replica_urls=(fake.url,), probe_interval_s=0.05, drain_grace_s=1.0)
    try:
        idle = socket.create_connection(("127.0.0.1", h.port), timeout=5)
        poll(lambda: len(h.gw._open_connections) == 1, "connection not tracked")
        t0 = time.monotonic()
        h.gw.drain()
        h.gw.stop()
        assert idle.recv(1) == b"" and time.monotonic() - t0 < 3.0
        idle.close()
    finally:
        fake.stop()


def test_gateway_metric_families_equal_the_reference():
    """A gateway, a supervisor and an autoscaler on one registry, a few
    routed queries later: the same metric families (HELP and TYPE) in
    both packages."""
    import predictionio_tpu.fleet.autoscaler as jax_autoscaler
    import predictionio_tpu_torch.fleet.autoscaler as pt_autoscaler

    fakes = [FakeReplica(f"r{i}") for i in range(2)]
    families = {}
    try:
        for which, registry_cls, gmod, smod, amod in (
                ("jax", JaxRegistry, jax_gateway, jax_supervisor, jax_autoscaler),
                ("port", PortRegistry, pt_gateway, pt_supervisor, pt_autoscaler)):
            reg = registry_cls()
            h = GATEWAYS[which](replica_urls=tuple(f.url for f in fakes), probe_interval_s=0.05)
            h.gw.metrics = reg  # the scrape below renders this registry
            gw = gmod.Gateway(gmod.GatewayConfig(replica_urls=tuple(f.url for f in fakes)), metrics=reg)
            sup = smod.Supervisor(lambda spec: ref_fleet.FakeProc(), [smod.WorkerSpec("w0", 9000)],
                                  smod.SupervisorConfig(), metrics=reg)
            amod.Autoscaler(amod.ScalingPolicy(amod.AutoscalerConfig()), sup, gw,
                            lambda cls: smod.WorkerSpec("w1", 9001, cls), metrics=reg)
            sup.start()
            gw.replicas[0].breaker.record_failure()
            try:
                conn = http.client.HTTPConnection("127.0.0.1", h.port, timeout=10)
                poll(lambda: all(r.ever_ready for r in h.gw.replicas), "first probe pass")
                for i in range(3):
                    request(conn, "POST", "/queries.json", {"user": f"u{i}"})
                text = reg.render_prometheus() + h.gw.metrics.render_prometheus()
            finally:
                h.close()
            families[which] = sorted({ln for ln in text.splitlines() if ln.startswith("# ")})
    finally:
        for f in fakes:
            f.stop()
    assert families["port"] == families["jax"]
    names = {ln.split()[2] for ln in families["port"]}
    assert {"pio_fleet_replica_up", "pio_gateway_request_seconds", "pio_fleet_restarts_total",
            "pio_autoscaler_replicas", "pio_breaker_state", "pio_slo_burn_rate"} <= names


def test_concurrent_picks_never_read_the_same_inflight_count():
    """32 concurrent queries held at one replica, under a short switch
    interval: each pick saw a distinct in-flight count (0..31), so no two
    handler threads tied on the same "least loaded" reading; with two
    replicas every (replica, count) pair is distinct and the load splits
    evenly."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for n_replicas in (1, 2):
            fakes = [FakeReplica(f"r{i}") for i in range(n_replicas)]
            gate = threading.Event()
            for f in fakes:
                f.gate = gate
            h = PortGatewayThread(replica_urls=tuple(f.url for f in fakes), probe_interval_s=0.05,
                                  request_timeout_s=20.0)
            seen: list = []
            original = h.gw.pick_replica

            def recording(key, exclude=frozenset(), meta=None):
                chosen = original(key, exclude=exclude, meta=meta)
                seen.append((chosen.name, chosen.inflight))
                return chosen

            h.gw.pick_replica = recording
            try:
                poll(lambda: all(r.ever_ready for r in h.gw.replicas), "first probe pass")

                def one(i):
                    c = http.client.HTTPConnection("127.0.0.1", h.port, timeout=30)
                    try:
                        return request(c, "POST", "/queries.json", {"user": "same"})["status"]
                    finally:
                        c.close()

                with concurrent.futures.ThreadPoolExecutor(32) as pool:
                    futs = [pool.submit(one, i) for i in range(32)]
                    poll(lambda: sum(f.active for f in fakes) == 32, "queries not all in flight")
                    gate.set()
                    statuses = [f.result(30) for f in futs]
            finally:
                h.close()
                for f in fakes:
                    f.stop()
            assert statuses == [200] * 32
            assert len(set(seen)) == len(seen) == 32
            per = 32 // n_replicas
            assert sorted(seen) == sorted((r.name, k) for r in h.gw.replicas for k in range(per))
    finally:
        sys.setswitchinterval(old)


def test_a_failed_upstream_connection_is_never_reused():
    """A replica that hangs up mid-answer fails that forward (the retry
    answers it elsewhere); the broken connection leaves the pool, and
    the next forward to the same replica opens a new one."""
    accepted = []
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)

    def serve():
        while True:
            try:
                c, _ = srv.accept()
            except OSError:
                return
            accepted.append(c)
            c.recv(65536)
            if len(accepted) == 1:
                c.close()  # hang up without an answer
            else:
                body = b'{"ok": true}'
                c.sendall(b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\nContent-Length: "
                          + str(len(body)).encode() + b"\r\n\r\n" + body)

    threading.Thread(target=serve, daemon=True).start()
    up = pt_gateway._Upstream(f"http://127.0.0.1:{srv.getsockname()[1]}", 4, 30.0)
    try:
        with pytest.raises(pt_gateway.TRANSPORT_ERRORS):
            up.request("POST", "/queries.json", b"{}", {}, 5.0)
        assert up._idle == []
        assert up.request("POST", "/queries.json", b"{}", {}, 5.0)[0] == 200
        assert len(accepted) == 2 and len(up._idle) == 1
        # the replica hangs up an idle connection: checkout drops it and
        # the forward goes out on a new one
        accepted[1].close()
        time.sleep(0.05)
        assert up.request("POST", "/queries.json", b"{}", {}, 5.0)[0] == 200
        assert len(accepted) == 3 and len(up._idle) == 1
    finally:
        up.close()
        srv.close()


# ---------------------------------------------------------------------------
# real deploy --fleet processes of the port's CLI on the CPU
# ---------------------------------------------------------------------------

# every process that imports site reports, at its exit, each module of JAX,
# the JAX package or aiohttp it imported
_SITECUSTOMIZE = """
import atexit, json, os, sys
def _report():
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "aiohttp", "predictionio_tpu"))
    with open(os.path.join(os.environ["PIO_FOREIGN_DIR"], f"{os.getpid()}.json"), "w") as fh:
        json.dump({"argv": sys.argv, "foreign": bad}, fh)
atexit.register(_report)
"""


def foreign_module_env(tmp_path) -> dict:
    """An environment whose processes each write their foreign modules to
    ``tmp_path/foreign/<pid>.json`` when they exit."""
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_SITECUSTOMIZE)
    (tmp_path / "foreign").mkdir()
    env = {k: v for k, v in os.environ.items() if not k.startswith("PIO_")}
    env.update(PYTHONPATH=f"{site}{os.pathsep}{REPO}", PIO_FOREIGN_DIR=str(tmp_path / "foreign"),
               OMP_NUM_THREADS="1")
    return env


def foreign_reports(tmp_path) -> list[dict]:
    out = []
    for name in os.listdir(tmp_path / "foreign"):
        with open(tmp_path / "foreign" / name) as fh:
            out.append(json.load(fh))
    return out


def rate_lines(n_users: int = 16, n_items: int = 10) -> list[dict]:
    out, k = [], 0
    for u in range(n_users):
        for i in range(n_items):
            if (u * 7 + i * 3) % 4 == 0:
                continue
            out.append({"event": "rate", "entityType": "user", "entityId": f"u{u}",
                        "targetEntityType": "item", "targetEntityId": f"i{i}",
                        "properties": {"rating": float(1 + (u + i) % 5)},
                        "eventTime": f"2024-03-01T00:{k // 60:02d}:{k % 60:02d}.000Z"})
            k += 1
    return out


class FleetProject:
    """An app, its events and an ALS engine trained into a registry by
    the port's CLI processes, on the CPU."""

    def __init__(self, tmp_path, env, engine_id: str, app: str, versions: int = 1, **algo):
        self.home, self.dir = tmp_path / "home", tmp_path / "project"
        self.registry, self.engine_id, self.app, self.env = str(tmp_path / "registry"), engine_id, app, env
        self.dir.mkdir()
        variant = json.loads(open(os.path.join(
            REPO, "predictionio_tpu_torch/models/recommendation/engine.json")).read())
        variant["id"] = engine_id
        variant["datasource"]["params"]["appName"] = app
        variant["algorithms"][0]["params"].update(rank=4, numIterations=2, **algo)
        self.variant = variant
        (self.dir / "engine.json").write_text(json.dumps(variant))
        events = tmp_path / "events.jsonl"
        events.write_text("".join(json.dumps(e) + "\n" for e in rate_lines()))
        self.cli = [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", "--home", str(self.home)]
        self.run("app", "new", app)
        self.run("import", "--appname", app, "--input", str(events))
        for v in range(versions):
            if v:
                variant["algorithms"][0]["params"]["seed"] = 100 + v
                (self.dir / "engine.json").write_text(json.dumps(variant))
            self.run("train", "--engine-dir", str(self.dir), "--device", "cpu", "--registry-dir", self.registry)

    def run(self, *args) -> str:
        out = subprocess.run([*self.cli, *args], env=self.env, cwd=str(self.dir), capture_output=True,
                             text=True, timeout=120)
        assert out.returncode == 0, f"{args[:2]}: {out.stderr[-3000:]}"
        return out.stdout

    def deploy_fleet(self, port: int, *extra) -> subprocess.Popen:
        return subprocess.Popen(
            [*self.cli, "deploy", "--engine-dir", str(self.dir), "--device", "cpu", "--ip", "127.0.0.1",
             "--port", str(port), "--registry-dir", self.registry, *extra],
            env=self.env, cwd=str(self.dir), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def reference(self, version: str):
        """``serve_batch`` of the version's own model, on the CPU."""
        from predictionio_tpu_torch.ops.als import ServingIndex
        from predictionio_tpu_torch.registry import ArtifactStore
        from predictionio_tpu_torch.workflow import model_io

        model = model_io.deserialize_models(ArtifactStore(self.registry).load_blob(self.engine_id, version))[0]
        index = ServingIndex(model.user_factors, model.item_factors, "cpu")

        def answer(user: str, num: int):
            scores, items = index.serve_batch(np.asarray([model.user_index(user)]), num)
            return [model.item_vocab[int(i)] for i in items[0]], scores[0]

        return answer


def http_json(port: int, method: str, path: str, body=None, timeout: float = 30.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read()
        return resp.status, json.loads(raw) if raw else None
    finally:
        conn.close()


def gateway_health(port: int) -> dict:
    try:
        return http_json(port, "GET", "/healthz", timeout=2)[1] or {}
    except (OSError, http.client.HTTPException):
        return {}


def fleet_ready(port: int, n: int) -> bool:
    """Every worker answers and the gateway counts them healthy (a replica
    is healthy until its first probe fails, so the workers are asked
    themselves)."""
    for p in range(port + 1, port + 1 + n):
        try:
            if http_json(p, "GET", "/", timeout=2)[0] != 200:
                return False
        except (OSError, http.client.HTTPException):
            return False
    return gateway_health(port).get("replicasHealthy") == n


def pid_serving(port: int) -> int:
    """The pid of the worker process bound to ``port`` (its argv says so)."""
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/cmdline", "rb") as fh:
                argv = fh.read().split(b"\0")
        except OSError:
            continue
        if b"predictionio_tpu_torch.tools.cli" in argv and b"--port" in argv \
                and argv[argv.index(b"--port") + 1] == str(port).encode():
            return int(name)
    raise AssertionError(f"no worker on port {port}")


def stop_fleet(proc: subprocess.Popen, grace_s: float) -> tuple[int, float, str]:
    t0 = time.monotonic()
    proc.send_signal(signal.SIGTERM)
    try:
        out, _ = proc.communicate(timeout=grace_s + 20)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        raise AssertionError(f"the fleet parent outlived its grace:\n{out[-3000:]}")
    return proc.returncode, time.monotonic() - t0, out


def test_a_device_worker_without_cuda_exits_non_zero(tmp_path):
    """A device-class worker's command line (no --device: cuda) on a
    machine without CUDA fails at once with exit 1; it never serves on the
    CPU. The supervisor counts that exit as a crash."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    argv = pt_launch.worker_argv(
        ["--home", str(tmp_path), "deploy", "--engine-dir", os.path.join(REPO, "predictionio_tpu_torch/models/"
                                                                         "recommendation"), "--fleet", "2"],
        free_port(), 1.0)
    out = subprocess.run(argv, capture_output=True, text=True, timeout=120, cwd=REPO,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 1 and "CUDA is not available" in out.stderr, out.stderr[-2000:]


def test_cli_fleet_of_two_survives_a_worker_kill_and_rolls_out(tmp_path):
    """``deploy --fleet 2 --device cpu --registry-dir R --obs-dir O`` on the
    port's CLI: 200 queries from 8 clients, every answer serve_batch's,
    with a SIGKILL of w0 amid them and zero 5xx; w0 restarted and
    readmitted, a worker-crash bundle holding its stderr tail; a candidate
    staged through the gateway and adopted by both workers (equal
    state_generation), then promoted fleet-wide; SIGTERM ends the parent
    with 0 within the drain grace; no process imported JAX, the JAX
    package or aiohttp."""
    from predictionio_tpu_torch.obs.incidents import list_bundles, load_bundle

    env = foreign_module_env(tmp_path)
    proj = FleetProject(tmp_path, env, "fleet-e2e", "fleetapp", versions=2)
    answers = {v: proj.reference(v) for v in ("v000001", "v000002")}
    port, obs = free_ports(3), str(tmp_path / "obs")
    parent = proj.deploy_fleet(port, "--fleet", "2", "--obs-dir", obs, "--fleet-probe-interval", "0.2",
                               "--registry-sync-interval", "0.2", "--drain-grace", "5",
                               "--no-auto-promote", "--result-cache-size", "0")
    try:
        poll(lambda: parent.poll() is not None or fleet_ready(port, 2), "the fleet never became ready", 90)
        assert parent.poll() is None, parent.stdout.read()
        w0 = pid_serving(port + 1)
        statuses: list = []
        lock = threading.Lock()

        def one(i: int):
            user, num = f"u{i % 16}", 3
            status, body = http_json(port, "POST", "/queries.json", {"user": user, "num": num})
            with lock:
                statuses.append(status)
            if i == 60:
                os.kill(w0, signal.SIGKILL)
            if status == 200:
                ids, scores = answers["v000001"](user, num)
                assert [s["item"] for s in body["itemScores"]] == ids
                np.testing.assert_allclose([s["score"] for s in body["itemScores"]], scores, rtol=1e-5)
            return status

        t_kill = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            list(pool.map(one, range(200)))
        assert len(statuses) == 200 and set(statuses) == {200}, sorted(set(statuses))
        # restarted (a new pid on w0's port) and readmitted
        poll(lambda: fleet_ready(port, 2) and pid_serving(port + 1) != w0, "w0 never came back", 60)
        readmit_s = time.monotonic() - t_kill
        status, text = 0, ""
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        status, text = resp.status, resp.read().decode()
        conn.close()
        assert status == 200 and 'pio_fleet_restarts_total{replica="w0"} 1' in text
        crashes = [b for b in list_bundles(os.path.join(obs, "incidents")) if b.trigger == "worker-crash"]
        assert crashes, os.listdir(os.path.join(obs, "incidents"))
        bundle = load_bundle(os.path.join(obs, "incidents"), crashes[0].bundle_id)
        assert bundle["manifest"]["context"]["replica"] == "w0"
        assert "deployed at http://127.0.0.1" in bundle["texts"]["stderr_tail"]
        # a candidate staged through the gateway reaches both workers
        from predictionio_tpu_torch.registry import ArtifactStore

        store = ArtifactStore(proj.registry)
        assert http_json(port, "POST", "/models/candidate", {"version": "v000002", "fraction": 0.5})[0] == 200
        assert store.get_state(proj.engine_id).candidate == "v000002"
        generation = store.state_generation(proj.engine_id)

        def adopted(pred):
            outs = [http_json(p, "GET", "/models")[1] for p in (port + 1, port + 2)]
            return all(pred(o) for o in outs) and len({o["registry"]["stateGeneration"] for o in outs}) == 1

        poll(lambda: adopted(lambda o: (o["candidate"] or {}).get("version") == "v000002"),
             "a worker never adopted the stage", 20)
        assert http_json(port, "POST", "/models/promote", {})[0] == 200
        poll(lambda: adopted(lambda o: o["stable"]["version"] == "v000002" and o["candidate"] is None),
             "a worker never adopted the promote", 20)
        assert store.get_state(proj.engine_id).stable == "v000002"
        assert store.state_generation(proj.engine_id) > generation
        for i in range(8):
            status, body = http_json(port, "POST", "/queries.json", {"user": f"u{i}", "num": 3})
            assert status == 200
            assert [s["item"] for s in body["itemScores"]] == answers["v000002"](f"u{i}", 3)[0]
    finally:
        rc, took, out = stop_fleet(parent, 5.0)
    assert rc == 0 and took < 5.0 + 15.0, out[-3000:]
    assert readmit_s < 60
    reports = foreign_reports(tmp_path)
    workers = [r for r in reports if "deploy" in r["argv"] and "--fleet" not in r["argv"]]
    assert len(workers) >= 2 and all(r["foreign"] == [] for r in reports), reports


_GRID_MODULE = """
from predictionio_tpu_torch.eval import Evaluation
from predictionio_tpu_torch.models.recommendation.engine import engine_factory
from predictionio_tpu_torch.tuning.metrics import PrecisionAtK

VARIANT = {variant!r}


def make_evaluation():
    engine = engine_factory()
    params = [engine.engine_params_from_variant({{**VARIANT, "algorithms": [{{"name": "als", "params": {{
        **VARIANT["algorithms"][0]["params"], "rank": rank}}}}]}}) for rank in (3, 5)]
    return Evaluation(engine=engine, metric=PrecisionAtK(k=3), engine_params_generator=params)
"""


def test_cli_fleet_lifecycle_drift_retune_promote_warm(tmp_path):
    """``deploy --fleet 1 --lifecycle`` on the port's CLI, the controller in
    the fleet parent: one drift line on the fleet's telemetry ring starts
    the episode, the grid runs in the parent on the CPU, its winner lands
    as the canary the worker adopts, a promote through the gateway ends
    the bake, and the controller warms at most 8 queries through the
    gateway, which are cache hits when sent again."""
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.lifecycle import read_json_file
    from predictionio_tpu_torch.obs.tsring import TelemetryRing
    from predictionio_tpu_torch.registry import ArtifactStore
    from predictionio_tpu_torch.tools.top import parse_prometheus
    from predictionio_tpu_torch.workflow.batch_predict import iter_event_users

    env = foreign_module_env(tmp_path)
    proj = FleetProject(tmp_path, env, "fleet-lifecycle", "lifecycleapp")
    grid_variant = {**proj.variant, "datasource": {"params": {
        **proj.variant["datasource"]["params"], "evalParams": {"kFold": 2, "queryNum": 3}}}}
    (proj.dir / "grid_eval.py").write_text(_GRID_MODULE.format(variant=grid_variant))
    port, obs = free_ports(2), str(tmp_path / "obs")
    parent = proj.deploy_fleet(
        port, "--fleet", "1", "--obs-dir", obs, "--fleet-probe-interval", "0.2", "--registry-sync-interval", "0.1",
        "--no-auto-promote", "--lifecycle", "grid_eval.make_evaluation", "--lifecycle-workers", "0",
        "--lifecycle-app", proj.app, "--lifecycle-warm-limit", "8", "--drain-grace", "5")
    store = ArtifactStore(proj.registry)
    state_path = os.path.join(obs, "lifecycle", "lifecycle.json")

    def state() -> dict:
        assert parent.poll() is None, parent.stdout.read()[-3000:]
        return (read_json_file(state_path) or {}).get("policy", {})

    def cache_hits() -> float:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        try:
            conn.request("GET", "/metrics")
            text = conn.getresponse().read().decode()
        finally:
            conn.close()
        return sum(v for _, v in parse_prometheus(text).get("pio_cache_hits_total", []))

    try:
        poll(lambda: parent.poll() is not None or fleet_ready(port, 1), "the fleet never became ready", 90)
        assert parent.poll() is None, parent.stdout.read()
        TelemetryRing(os.path.join(obs, "telemetry"), writer_id="stream").append({
            "kind": "drift", "engine": proj.engine_id, "trainer": "als", "guard": "holdout_rmse",
            "measured": 9.9, "threshold": 0.5, "reason": "a breach"})
        poll(lambda: state().get("state") == "baking", "the grid's winner never baked", 60)
        winner = store.get_state(proj.engine_id).candidate
        assert winner == "v000002"
        poll(lambda: (http_json(port + 1, "GET", "/models")[1]["candidate"] or {}).get("version") == winner,
             "the worker never adopted the canary", 20)
        assert http_json(port, "POST", "/models/promote", {})[0] == 200
        done = {}
        poll(lambda: (done := read_json_file(state_path) or {}).get("policy", {}).get("state") == "idle"
             and done["policy"].get("lastOutcome") == "promoted", "the episode never closed", 30)
        done = read_json_file(state_path)
        assert done["lastDecision"]["action"] == "warm"
        storage = Storage(env={"PIO_FS_BASEDIR": str(proj.home)})
        app_id = storage.get_meta_data_apps().get_by_name(proj.app).id
        queries = [q for _, q in iter_event_users(storage.get_l_events(), app_id, limit=8)]
        hits = cache_hits()
        for q in queries:
            assert http_json(port, "POST", "/queries.json", q)[0] == 200
        assert 0 < len(queries) <= 8 and cache_hits() - hits == len(queries)
        events = [r.get("event") for r in TelemetryRing(os.path.join(obs, "telemetry")).records()
                  if r.get("kind") == "lifecycle"]
        assert events == ["triggered", "tuning", "baking", "finished"]
    finally:
        rc, took, out = stop_fleet(parent, 5.0)
    assert rc == 0, out[-3000:]
    assert all(r["foreign"] == [] for r in foreign_reports(tmp_path))


@pytest.mark.parametrize("flags", [["--autoscale"], ["--hosts", "local:2"], ["--lifecycle", "grid.make"],
                                   ["--gateways", "2"]], ids=["autoscale", "hosts", "lifecycle", "gateways"])
def test_fleet_flags_without_fleet_are_refused_as_the_reference_refuses_them(flags, tmp_path, capsys):
    from predictionio_tpu.tools.cli import main as jax_main
    from predictionio_tpu_torch.tools.cli import main as port_main

    got = {}
    for which, main in (("jax", jax_main), ("port", port_main)):
        home = ["--home", str(tmp_path / "home")] if which == "port" else []
        rc = main([*home, "deploy", "--engine-dir", str(tmp_path), *flags])
        got[which] = (rc, capsys.readouterr().err)
    assert got["port"] == got["jax"]
    assert got["port"][0] != 0 and "requires --fleet N" in got["port"][1]
