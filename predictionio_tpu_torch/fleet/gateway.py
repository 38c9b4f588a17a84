"""The fleet gateway: one ingress, N QueryServer replicas, zero-downtime.

Port of ``predictionio_tpu/fleet/gateway.py``. The reference is an aiohttp
application with an aiohttp client pool; the port's servers run the
standard library's ``ThreadingHTTPServer``, so this gateway does too: one
handler thread per connection, per-replica pools of ``http.client``
keep-alive connections, and threads for the probe and telemetry loops.
The semantics are the reference's:

- **Routing.** ``POST /queries.json`` goes to the least-loaded routable
  replica (fewest in-flight proxied requests); ties break on a
  consistent hash of the query's sticky key, so equal-load fleets still
  route a user deterministically and per-replica caches see repeat
  traffic. A replica is *routable* when its ``/healthz`` probe passes
  and its circuit breaker admits traffic. When EVERY replica has failed
  its last probe, routing goes *panic mode* — health is ignored
  (breakers still apply), because a fleet-wide probe blackout is more
  often a probe artifact than a dead fleet. One event loop serialised
  the reference's pick and its in-flight increment; here both happen
  under one lock, so two handler threads never tie on the same "least
  loaded" replica.
- **Ejection / readmission.** A probe loop GETs every replica's
  ``/healthz`` each ``probe_interval_s``; a failing or unreachable
  replica is ejected (counted) and readmitted when the probe passes
  again. Independently, each replica has a circuit breaker fed by proxy
  outcomes — consecutive forward failures stop traffic within the
  breaker threshold, faster than the next probe.
- **Retry.** /queries.json is idempotent (pure reads), so a forward
  that dies (connection error or replica 5xx) is retried ONCE on a
  different replica — never on a 4xx (the client's error follows them
  to any replica), never for the non-idempotent admin proxies, and
  bounded by the :class:`~predictionio_tpu_torch.resilience.RetryBudget`
  so a dying fleet sees load drop, not double.
- **Upstream pool.** Each replica has its own keep-alive connections,
  checked out for one forward and back (at most ``upstream_pool_per_host``
  idle, each idle at most ``upstream_keepalive_s``). A connection whose
  forward failed is closed and never reused; an idle one the replica has
  hung up is dropped at checkout.
- **Drain.** :meth:`Gateway.drain` closes the listener (new connections
  refused at TCP), keeps answering requests that arrive on established
  keep-alive connections — with ``Connection: close`` so clients migrate
  — and waits for in-flight proxies (bounded by ``drain_grace_s``);
  :meth:`Gateway.stop` then ends the read side of every connection still
  open, so an idle keep-alive client cannot hold the gateway past its
  grace.
- **Federation.** ``GET /metrics`` merges every replica's scrape with
  the gateway's own ``pio_fleet_*``/``pio_gateway_*`` instruments
  (:mod:`.federation`) — the endpoint ``pio top --fleet`` reads.
- **Cross-tier tracing.** Every routed query is recorded as spans on the
  ingress trace id: ``gateway.route`` and one ``gateway.proxy`` per
  forward attempt. ``GET /traces/recent`` merges the gateway's span ring
  with each replica's (fetched live from healthy replicas, served from
  the per-tick cache for dead ones — a SIGKILLed worker's last spans
  survive it); ``?trace_id=`` assembles one gateway→replica waterfall.
- **Telemetry ring + fleet SLOs.** Each telemetry tick federates the
  fleet's counters, evaluates fleet-level SLOs over the federated deltas
  and appends a snapshot to the durable
  :class:`~predictionio_tpu_torch.obs.tsring.TelemetryRing` — the history
  ``GET /telemetry/window?s=N`` and ``pio top --history`` serve, and what
  the autoscaler reads.
- **Incident triggers.** A fleet SLO flipping to alerting, a replica
  breaker tripping open, or a 5xx escaping to a client each fire the
  attached :class:`~predictionio_tpu_torch.obs.incidents.IncidentRecorder`
  on a thread of its own, never the handler's.

Model-rollout admin (``GET /models``, ``POST /models/*``) proxies to one
healthy replica; the change lands in the shared registry and every other
replica adopts it through its registry-sync loop.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import http.client
import json
import logging
import select
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any
from urllib.parse import parse_qsl, urlsplit

from predictionio_tpu_torch.fleet.federation import federate_metrics
from predictionio_tpu_torch.fleet.supervisor import REPLICA_CLASS_CPU
from predictionio_tpu_torch.obs.incidents import IncidentRecorder
from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.obs.sampler import HostSampler
from predictionio_tpu_torch.obs.slo import DEFAULT_WINDOWS, SLOEngine
from predictionio_tpu_torch.obs.tracing import TRACE_HEADER, Tracer, mint_trace_id
from predictionio_tpu_torch.obs.tsring import TelemetryRing
from predictionio_tpu_torch.obs.web import (
    OPENMETRICS_CONTENT_TYPE,
    PROMETHEUS_CONTENT_TYPE,
    BreakerInstruments,
    _wants_exemplars,
    slo_response,
)
from predictionio_tpu_torch.registry.router import routing_key, sticky_bucket
from predictionio_tpu_torch.resilience import OPEN, CircuitBreaker, CircuitOpenError, RetryBudget
from predictionio_tpu_torch.tools.top import parse_prometheus
from predictionio_tpu_torch.utils.httpbody import BodyError, BodyTooLarge, read_body, reply_bad_framing

logger = logging.getLogger(__name__)

# forward outcomes that justify trying a different replica: transport
# failures and replica-side 5xx. 4xx is the CLIENT's problem — it would
# fail identically everywhere, and re-dispatching it doubles load for
# nothing.
RETRIABLE_STATUSES = frozenset((500, 502, 503, 504))

# spans fetched per replica per telemetry tick: enough ring to cover a
# probe interval of traffic at fleet scale without the fan-in dominating
# the tick
TRACE_FANIN_LIMIT = 200

# what a forward raises when the replica cannot be reached or hangs up
TRANSPORT_ERRORS = (OSError, http.client.HTTPException)

# aiohttp's json_response content type, which the reference answers with
JSON_TYPE = "application/json; charset=utf-8"

# (status, content type, body, extra headers)
Answer = tuple[int, str, bytes, dict[str, str]]


@dataclasses.dataclass
class GatewayConfig:
    ip: str = "0.0.0.0"
    port: int = 8000
    replica_urls: tuple[str, ...] = ()
    # /healthz probe cadence and per-probe timeout (ejection latency is
    # bounded by interval + timeout)
    probe_interval_s: float = 1.0
    probe_timeout_s: float = 2.0
    # per-forward timeout (connect, and each read of the response)
    request_timeout_s: float = 10.0
    # one-retry budget: each first attempt earns `ratio` tokens, each
    # retry spends 1 (resilience.RetryBudget semantics)
    retry_budget_ratio: float = 0.2
    # per-replica breaker: consecutive forward failures before the
    # gateway stops routing there without waiting for the next probe
    breaker_threshold: int = 3
    breaker_recovery_s: float = 5.0
    # consistent-hash tie-break key (same field the servers use for
    # sticky canary routing)
    sticky_key_field: str = "user"
    # replica class per replica_urls entry ("device" default); shorter
    # tuples pad with "device". cpu-fallback replicas absorb OVERFLOW
    # only: routed to when every healthy device-class replica already
    # carries >= cpu_overflow_inflight proxied queries (or none is
    # routable) — slower answers instead of sheds, never instead of the
    # fast path
    replica_classes: tuple[str, ...] = ()
    cpu_overflow_inflight: int = 4
    max_payload_bytes: int = 1 << 20
    shed_retry_after_s: float = 1.0
    drain_grace_s: float = 15.0
    # telemetry tick cadence (federate + SLO + ring append + trace
    # fan-in refresh); None follows probe_interval_s, 0 disables
    telemetry_interval_s: float | None = None
    # fleet SLO burn windows ((seconds, threshold), ...); None = the SRE
    # defaults (300s fast / 3600s slow)
    slo_windows: tuple[tuple[float, float], ...] | None = None
    # upstream connection pool: idle keep-alive connections kept per
    # replica (the proxy hop must not pay a TCP handshake per query) and
    # how long an idle pooled connection survives
    upstream_pool_per_host: int = 32
    upstream_keepalive_s: float = 30.0
    # shared-nothing gateway tier (--gateways N): this gateway's stable
    # id (telemetry-ring writer namespace, peer attribution) and its
    # peers' base URLs for /traces/recent + /slo fan-in
    gateway_id: str = "g0"
    peer_urls: tuple[str, ...] = ()


def _peer_hung_up(conn: http.client.HTTPConnection) -> bool:
    """An idle keep-alive connection the replica has closed (or sent
    something unasked on) reads as readable: it must not carry a forward."""
    if conn.sock is None:
        return True
    try:
        return bool(select.select([conn.sock], [], [], 0)[0])
    except (OSError, ValueError):
        return True


class _Upstream:
    """Keep-alive connections to one replica, checked out for one request
    and back. A connection whose request failed is closed, never reused."""

    def __init__(self, url: str, max_idle: int, keepalive_s: float):
        split = urlsplit(url)
        self.host = split.hostname or "127.0.0.1"
        self.port = split.port or 80
        self.max_idle = max(0, int(max_idle))
        self.keepalive_s = keepalive_s
        self._idle: list[tuple[http.client.HTTPConnection, float]] = []
        self._lock = threading.Lock()
        self._closed = False

    def _checkout(self, timeout_s: float) -> http.client.HTTPConnection:
        now = time.monotonic()
        while True:
            with self._lock:
                if not self._idle:
                    break
                conn, since = self._idle.pop()
            if now - since <= self.keepalive_s and not _peer_hung_up(conn):
                conn.timeout = timeout_s
                if conn.sock is not None:
                    conn.sock.settimeout(timeout_s)
                return conn
            conn.close()
        return http.client.HTTPConnection(self.host, self.port, timeout=timeout_s)

    def _checkin(self, conn: http.client.HTTPConnection) -> None:
        with self._lock:
            if not self._closed and len(self._idle) < self.max_idle:
                self._idle.append((conn, time.monotonic()))
                return
        conn.close()

    def request(
        self,
        method: str,
        path: str,
        body: bytes | None,
        headers: dict[str, str],
        timeout_s: float,
    ) -> tuple[int, bytes, str]:
        """(status, body, content type); raises one of ``TRANSPORT_ERRORS``
        when the replica cannot be reached or hangs up."""
        conn = self._checkout(timeout_s)
        try:
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            payload = resp.read()
        except BaseException:
            conn.close()
            raise
        ctype = resp.getheader("Content-Type", "application/json")
        if resp.will_close:
            conn.close()
        else:
            self._checkin(conn)
        return resp.status, payload, ctype

    def close(self) -> None:
        with self._lock:
            self._closed = True
            idle, self._idle = self._idle, []
        for conn, _ in idle:
            conn.close()


def _get(url: str, timeout_s: float) -> tuple[int, bytes]:
    """One GET on a connection of its own: the health and telemetry
    planes' traffic (probes, scrapes, trace fan-in) never borrows the
    forwarding pool."""
    split = urlsplit(url)
    conn = http.client.HTTPConnection(split.hostname, split.port or 80, timeout=timeout_s)
    try:
        path = split.path or "/"
        if split.query:
            path += "?" + split.query
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


class Replica:
    """Gateway-side state for one backend QueryServer."""

    def __init__(
        self,
        url: str,
        breaker: CircuitBreaker,
        worker_class: str = "device",
        healthy: bool = True,
    ):
        self.url = url.rstrip("/")
        split = urlsplit(self.url)
        self.name = split.netloc or self.url
        self.worker_class = worker_class
        self.breaker = breaker
        # healthy-until-proven-otherwise: the first probe fires
        # immediately at startup, and the breaker bounds the damage of
        # routing to a replica that was never up. A replica JOINING at
        # runtime (scale-out) is the opposite case — its worker process
        # is still loading its model — so it joins unhealthy and earns
        # routing from its first passing probe.
        self.healthy = healthy
        # a replica that has never passed a probe is "not up yet", not
        # "ejected": startup must not inflate the ejection counter
        self.ever_ready = False
        self.inflight = 0
        self.upstream: _Upstream | None = None

    def snapshot(self) -> dict[str, Any]:
        return {
            "url": self.url,
            "healthy": self.healthy,
            "workerClass": self.worker_class,
            "inflight": self.inflight,
            "breaker": self.breaker.snapshot(),
        }


class _GatewayHTTPServer(ThreadingHTTPServer):
    """Tracks every open connection, so :meth:`Gateway.stop` can hang up
    the idle keep-alives."""

    daemon_threads = True
    # a burst of new connections must not overflow the backlog: a client
    # past it would see a reset, not a 503
    request_queue_size = 1024

    def __init__(self, address, handler, owner: "Gateway"):
        self.owner = owner
        super().__init__(address, handler)

    def process_request(self, request, client_address) -> None:
        with self.owner._count_lock:
            self.owner._open_connections.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request) -> None:
        with self.owner._count_lock:
            self.owner._open_connections.discard(request)
        super().shutdown_request(request)

    def process_request_thread(self, request, client_address) -> None:
        # the host sampler attributes stacks by thread name
        threading.current_thread().name = "pio-handler"
        super().process_request_thread(request, client_address)


def _json(status: int, body: Any, headers: dict[str, str] | None = None) -> Answer:
    return status, JSON_TYPE, json.dumps(body).encode(), headers or {}


class Gateway:
    def __init__(
        self,
        config: GatewayConfig,
        metrics: MetricsRegistry | None = None,
        tracer: Tracer | None = None,
        telemetry: TelemetryRing | None = None,
        incidents: IncidentRecorder | None = None,
    ):
        if not config.replica_urls:
            raise ValueError("gateway needs at least one replica URL")
        self.config = config
        self.metrics = metrics or MetricsRegistry()
        self.tracer = tracer or Tracer(ring_size=512)
        self.telemetry = telemetry
        self.incidents = incidents
        m = self.metrics
        self._breaker_instruments = BreakerInstruments(m)
        # membership funnel: every runtime add/retire mutates the replica
        # set, the breaker map, and the per-replica gauges under this one
        # lock, so the probe loop, routing, and the scrape never see them
        # disagree
        self._membership_lock = threading.Lock()
        # a pick and its in-flight increment are one step
        self._route_lock = threading.Lock()
        # gateway-wide in-flight count, its peak, and the open connections
        self._count_lock = threading.Lock()
        classes = tuple(config.replica_classes) + ("device",) * max(
            0, len(config.replica_urls) - len(config.replica_classes)
        )
        self.replicas: list[Replica] = []
        for url, worker_class in zip(config.replica_urls, classes):
            self._make_replica(url, worker_class, healthy=True)
        self.retry_budget = RetryBudget(ratio=config.retry_budget_ratio)
        self._m_replicas = m.gauge(
            "pio_fleet_replicas", "replicas configured behind this gateway"
        )
        self._m_replicas.set(len(self.replicas))
        self._m_up = m.gauge(
            "pio_fleet_replica_up",
            "1 when the replica's last /healthz probe passed",
            labelnames=("replica",),
        )
        self._m_inflight = m.gauge(
            "pio_fleet_replica_inflight",
            "queries currently proxied to the replica",
            labelnames=("replica",),
        )
        self._m_requests = m.counter(
            "pio_fleet_requests_total",
            "queries proxied, by replica and upstream status class",
            labelnames=("replica", "status"),
        )
        self._m_ejections = m.counter(
            "pio_fleet_ejections_total",
            "replicas ejected on a failed /healthz probe",
            labelnames=("replica",),
        )
        self._m_readmissions = m.counter(
            "pio_fleet_readmissions_total",
            "ejected replicas readmitted on a passing /healthz probe",
            labelnames=("replica",),
        )
        self._m_retries = m.counter(
            "pio_fleet_retries_total",
            "queries retried on a different replica after a forward failure",
        )
        self._m_no_replica = m.counter(
            "pio_fleet_no_replica_total",
            "queries shed because no routable replica existed",
        )
        self._m_panic = m.counter(
            "pio_fleet_panic_picks_total",
            "queries routed in panic mode: every replica failed its last "
            "probe, so health was ignored (breakers still applied)",
        )
        self._m_overflow = m.counter(
            "pio_fleet_overflow_picks_total",
            "queries routed to a cpu-fallback replica because every "
            "healthy device-class replica was saturated (slower answer "
            "instead of a shed)",
        )
        self._m_membership = m.counter(
            "pio_fleet_membership_changes_total",
            "runtime replica set changes through the membership funnel, "
            "by kind (join/retire)",
            labelnames=("kind",),
        )
        self._m_latency = m.histogram(
            "pio_gateway_request_seconds",
            "gateway e2e proxy wall time (ingress to upstream answer relayed)",
            labelnames=("endpoint",),
        )
        self._m_responses = m.counter(
            "pio_gateway_responses_total",
            "CLIENT-VISIBLE /queries.json outcomes by status class — what "
            "the retry already rescued is a 2xx here (pio_fleet_requests_"
            "total counts the per-attempt forwards)",
            labelnames=("status",),
        )
        self._m_telemetry_snapshots = m.counter(
            "pio_telemetry_snapshots_total",
            "fleet snapshots appended to the on-disk telemetry ring",
        )
        self._m_telemetry_errors = m.counter(
            "pio_telemetry_errors_total",
            "telemetry ticks that failed (federation, SLO, or ring append)",
        )
        self._m_telemetry_records = m.gauge(
            "pio_telemetry_ring_records",
            "records currently live in the telemetry ring (0 when no ring "
            "is attached)",
        )
        m.register_collector(self._collect)
        # fleet-level SLOs over the federated view: snapshots ride the
        # telemetry tick AND the scrape
        self.slo = SLOEngine(m)
        self._last_federated: dict[str, list[tuple[dict[str, str], float]]] = {}
        self._add_fleet_slos()
        m.register_collector(self.slo.collect)
        self._slo_alerting: dict[str, bool] = {}
        # the gateway tier samples its own host threads: GET
        # /profile/stacks answers "is the gateway or the replica slow"
        # without touching a replica
        self.sampler = HostSampler(metrics=m)
        # trace fan-in cache: replica name -> last fetched span dicts.
        # Refreshed per telemetry tick and on /traces/recent; NEVER
        # cleared on fetch failure — a dead replica's final spans are
        # exactly the evidence an incident bundle needs.
        self._replica_spans: dict[str, list[dict[str, Any]]] = {}
        # gateway-peer fan-in cache (--gateways N): peer base url ->
        # spans it served on its LOCAL /traces/recent, same
        # keep-on-failure rule
        self._peer_spans: dict[str, list[dict[str, Any]]] = {}
        self._draining = False
        self._inflight_requests = 0
        # high-water mark since the last telemetry tick: an instant
        # inflight sample can read 0 mid-flood; the autoscaler needs "was
        # there concurrency since I last looked", not "at this instant"
        self._inflight_peak = 0
        self._open_connections: set = set()
        # POST /stop sets it; the fleet launcher waits on it beside SIGTERM
        self.stop_requested = threading.Event()
        self._stop_loops = threading.Event()
        self._loops: list[threading.Thread] = []
        self._httpd: _GatewayHTTPServer | None = None
        self._serve_thread: threading.Thread | None = None
        # probes, scrapes and trace fetches of all replicas run side by
        # side, as the reference gathers them
        self._fanout = concurrent.futures.ThreadPoolExecutor(
            max_workers=16, thread_name_prefix="pio-gateway-fanout"
        )
        # incident captures do disk I/O exactly when the fleet is
        # degraded: never on a handler thread
        self._incident_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="pio-gateway-incident"
        )

    # ------------------------------------------------------------- plumbing
    def _collect(self) -> None:
        replicas = self.replicas
        self._m_replicas.set(len(replicas))
        for r in replicas:
            self._m_up.set(1.0 if r.healthy else 0.0, replica=r.name)
            self._m_inflight.set(float(r.inflight), replica=r.name)
        # reconcile against the live set: a retired replica's series
        # must not outlive its membership — covers any write that raced
        # the retire funnel
        live = [r.name for r in replicas]
        self._m_up.prune("replica", live)
        self._m_inflight.prune("replica", live)
        state_gauge = self.metrics.get("pio_breaker_state")
        if state_gauge is not None and hasattr(state_gauge, "remove"):
            live_breakers = {r.breaker.name for r in replicas}
            for (bname,), _v in state_gauge.collect():
                if bname.startswith("replica:") and bname not in live_breakers:
                    state_gauge.remove(breaker=bname)
        if self.telemetry is not None:
            self._m_telemetry_records.set(
                float(getattr(self.telemetry, "approx_count", 0))
            )

    def _fan(self, fn, items) -> list[Any]:
        """``fn`` over ``items`` on the fan-out threads, results in order."""
        items = list(items)
        if not items:
            return []
        return list(self._fanout.map(fn, items))

    # ---------------------------------------------------------- fleet SLOs
    def _add_fleet_slos(self) -> None:
        """Fleet-level objectives evaluated over federated counter deltas
        (the replicas' own /slo endpoints rate each process in isolation;
        these rate what CLIENTS of the fleet experience)."""

        def availability() -> tuple[float, float]:
            # CLIENT-VISIBLE outcomes only: a forward that failed and was
            # rescued by the retry is a success here. Sheds are 503
            # responses, so they are already counted as bad.
            total = bad = 0.0
            for key, v in self._m_responses.collect():
                labels = dict(zip(self._m_responses.labelnames, key))
                total += v
                if labels.get("status") == "5xx":
                    bad += v
            return total, bad

        def latency() -> tuple[float, float]:
            # the paper's <10 ms p50 target, fleet-wide: over-threshold
            # fraction from the FEDERATED request histogram (0.01 sits
            # exactly on a ladder bound so good = the 0.01 bucket)
            total = good = 0.0
            for labels, v in self._last_federated.get(
                "pio_request_seconds_bucket", ()
            ):
                if labels.get("endpoint") != "/queries.json":
                    continue
                le = labels.get("le")
                if le == "+Inf":
                    total += v
                elif le == "0.01":
                    good += v
            return total, max(0.0, total - good)

        def shed() -> tuple[float, float]:
            total = sum(v for _key, v in self._m_responses.collect())
            return total, self._m_no_replica.total()

        windows = self.config.slo_windows or DEFAULT_WINDOWS
        self.slo.add(
            "fleet-availability",
            "fraction of fleet queries answered without a 5xx, transport "
            "error, or shed",
            objective=0.999,
            source=availability,
            windows=windows,
        )
        self.slo.add(
            "fleet-latency",
            "fraction of fleet queries under the paper's 10 ms target "
            "(federated replica histograms)",
            objective=0.50,
            source=latency,
            windows=windows,
        )
        self.slo.add(
            "fleet-shed",
            "fraction of fleet queries NOT shed for want of a routable "
            "replica",
            objective=0.99,
            source=shed,
            windows=windows,
        )

    # --------------------------------------------------- incident plumbing
    def _trigger_incident(self, kind: str, context: dict[str, Any]) -> None:
        """Fire the flight recorder off the calling thread: a capture does
        disk I/O (ring tail, registry read, bundle write), and it fires
        exactly when the fleet is degraded. The folded host stacks are
        snapshotted NOW, so they show the moment of the alert."""
        if self.incidents is None:
            return
        texts = {"stacks_folded": self.sampler.folded()}
        incidents = self.incidents
        try:
            self._incident_pool.submit(
                incidents.trigger, kind, context=context, texts=texts
            )
        except RuntimeError:  # the gateway has stopped: capture inline
            incidents.trigger(kind, context=context, texts=texts)

    def _on_breaker_transition(self, name: str, old: str, new: str) -> None:
        if new == OPEN:
            self._trigger_incident(
                "breaker-trip",
                {"breaker": name, "from": old, "to": new},
            )

    def _note_transition(
        self, event: str, replica: Replica, **tags: Any
    ) -> None:
        """The single funnel for replica state transitions: counter +
        health-event span (the eject/readmit timeline incident bundles
        and ``/traces/recent`` replay)."""
        if event == "eject":
            self._m_ejections.inc(replica=replica.name)
        elif event == "readmit":
            self._m_readmissions.inc(replica=replica.name)
        self.tracer.record_span(
            "gateway.health",
            "gateway",
            0.0,
            trace_id=mint_trace_id(),
            status=event,
            replica=replica.name,
            **tags,
        )

    # ----------------------------------------------------- fleet membership
    def _make_replica(
        self, url: str, worker_class: str, healthy: bool
    ) -> Replica:
        """Construct + register one replica: breaker watched (state
        gauge), trip listener chained (incident trigger), its upstream
        pool, appended to the routing set. The only place replicas are
        born."""
        breaker = self._breaker_instruments.watch(
            CircuitBreaker(
                name=f"replica:{urlsplit(url.rstrip('/')).netloc or url}",
                failure_threshold=self.config.breaker_threshold,
                recovery_timeout_s=self.config.breaker_recovery_s,
            )
        )
        # a breaker tripping OPEN is an incident trigger: by the time an
        # operator looks, the consecutive failures that tripped it are
        # only in the flight recorder
        breaker.chain_listener(self._on_breaker_transition)
        replica = Replica(url, breaker, worker_class=worker_class, healthy=healthy)
        replica.upstream = _Upstream(
            replica.url, self.config.upstream_pool_per_host, self.config.upstream_keepalive_s
        )
        self.replicas = [*self.replicas, replica]
        return replica

    def add_replica(self, url: str, worker_class: str = "device") -> Replica:
        """Scale-out membership: one locked funnel adds the replica to
        the routing set, the breaker map, and the probe loop's view in
        one step. The replica joins UNHEALTHY — no query routes to it
        until its first ``/healthz`` probe passes."""
        with self._membership_lock:
            name = urlsplit(url.rstrip("/")).netloc or url
            for r in self.replicas:
                if r.name == name:
                    raise ValueError(f"replica {name!r} already routed")
            replica = self._make_replica(url, worker_class, healthy=False)
            self._m_replicas.set(len(self.replicas))
            self._m_membership.inc(kind="join")
            self._note_transition("join", replica, worker_class=worker_class)
            return replica

    def retire_replica(self, url_or_name: str) -> Replica | None:
        """Scale-in membership: remove the replica from routing through
        the same locked funnel. New requests stop routing to it
        immediately; requests already forwarded hold the Replica object
        and complete normally (the worker drains them after its SIGTERM)
        — the ordering that makes scale-in 5xx-free. Its live-set gauges
        drop from the exposition; its span cache is dropped too (a
        planned retire is not incident evidence). Returns the retired
        replica, or None when unknown."""
        name = urlsplit(url_or_name.rstrip("/")).netloc or url_or_name
        with self._membership_lock:
            victim = next((r for r in self.replicas if r.name == name), None)
            if victim is None:
                return None
            self.replicas = [r for r in self.replicas if r is not victim]
            self._breaker_instruments.unwatch(victim.breaker)
            self._m_up.remove(replica=victim.name)
            self._m_inflight.remove(replica=victim.name)
            self._replica_spans.pop(victim.name, None)
            self._m_replicas.set(len(self.replicas))
            self._m_membership.inc(kind="retire")
            self._note_transition(
                "retire", victim, worker_class=victim.worker_class
            )
        victim.upstream.close()
        return victim

    def replica_shape(self) -> dict[str, int]:
        """Routable-set census by replica class (the ``gateway`` side of
        the autoscaler's shape; the supervisor's ``live_specs`` is the
        process side)."""
        shape: dict[str, int] = {}
        for r in self.replicas:
            shape[r.worker_class] = shape.get(r.worker_class, 0) + 1
        return shape

    def cached_spans(self) -> list[dict[str, Any]]:
        """Merged-trace snapshot (gateway ring + per-tick replica caches)
        — what incident sources capture without touching the network
        mid-incident. Each span is tagged with its ``source`` tier."""
        out = [
            {**s, "source": "gateway"} for s in self.tracer.recent(None)
        ]
        for name, spans in list(self._replica_spans.items()):
            out.extend({**s, "source": name} for s in spans)
        out.sort(key=lambda s: s.get("startTime", 0.0), reverse=True)
        return out

    # -------------------------------------------------------------- routing
    def pick_replica(
        self,
        key: str,
        exclude: frozenset[str] = frozenset(),
        meta: dict[str, Any] | None = None,
    ) -> Replica | None:
        """Least-loaded routable replica; consistent-hash tie-break.

        Claims a breaker slot (``allow()``) on the winner — the caller
        MUST pair the pick with ``record_success``/``record_failure``.
        ``meta``, when given, is filled with routing attribution (panic
        mode, healthy count) for the ``gateway.route`` span. Request
        paths pick through :meth:`_claim`, which holds the route lock
        across this pick and the in-flight increment.
        """
        pool = [r for r in self.replicas if r.name not in exclude]
        candidates = [r for r in pool if r.healthy]
        if meta is not None:
            meta["healthy"] = len(candidates)
        if not candidates and pool:
            # panic routing: EVERY replica failed its last probe. Probes
            # are advisory — one can time out against a loaded-but-alive
            # worker — and when the whole fleet looks down at once, the
            # probes being wrong is likelier than the fleet being dead.
            # Route across all of them; the per-replica breakers still
            # gate backends that are truly gone.
            candidates = pool
            self._m_panic.inc()
            if meta is not None:
                meta["panic"] = True
        if not candidates:
            return None
        chosen = None
        for group in self._class_preference(candidates):
            chosen = self._pick_admitted(group, key)
            if chosen is not None:
                break
        if chosen is None:
            return None
        if chosen.worker_class == REPLICA_CLASS_CPU and any(
            r.worker_class != REPLICA_CLASS_CPU for r in candidates
        ):
            # the device class was saturated (or breaker-refused): this
            # query degrades to a slower cpu-fallback answer, not a shed
            self._m_overflow.inc()
            if meta is not None:
                meta["overflow"] = True
        return chosen

    def _class_preference(self, candidates: list[Replica]) -> list[list[Replica]]:
        """Cost/latency-aware routing order: device-bound replicas carry
        traffic while any has headroom; cpu-fallback replicas absorb
        overflow only; a fully saturated fleet falls back to least-loaded
        across everything (queueing beats shedding)."""
        cpu = [r for r in candidates if r.worker_class == REPLICA_CLASS_CPU]
        device = [r for r in candidates if r.worker_class != REPLICA_CLASS_CPU]
        if not cpu or not device:
            return [candidates]
        thresh = max(1, self.config.cpu_overflow_inflight)
        under_dev = [r for r in device if r.inflight < thresh]
        under_cpu = [r for r in cpu if r.inflight < thresh]
        if under_dev:
            return [g for g in (under_dev, under_cpu, candidates) if g]
        if under_cpu:
            return [under_cpu, candidates]
        return [candidates]

    @staticmethod
    def _pick_admitted(group: list[Replica], key: str) -> Replica | None:
        """Least-loaded within the group, consistent-hash tie-break,
        first replica whose breaker admits the request."""
        if not group:
            return None
        low = min(r.inflight for r in group)
        tied = sorted(
            (r for r in group if r.inflight == low),
            key=lambda r: r.name,
        )
        # rotate the tie list by the sticky hash: same key -> same replica
        # while loads stay equal, different keys spread uniformly
        start = int(sticky_bucket(key) * len(tied)) % len(tied)
        for i in range(len(tied)):
            r = tied[(start + i) % len(tied)]
            try:
                r.breaker.allow()
            except CircuitOpenError:
                continue
            return r
        # every tied replica's breaker refused; try the rest by load
        rest = sorted(
            (r for r in group if r.inflight != low),
            key=lambda r: (r.inflight, r.name),
        )
        for r in rest:
            try:
                r.breaker.allow()
            except CircuitOpenError:
                continue
            return r
        return None

    def _claim(
        self,
        key: str,
        exclude: frozenset[str] = frozenset(),
        meta: dict[str, Any] | None = None,
    ) -> Replica | None:
        """Pick and count the forward in flight in one step: a second
        handler thread's pick already sees this one's load."""
        with self._route_lock:
            replica = self.pick_replica(key, exclude=exclude, meta=meta)
            if replica is not None:
                replica.inflight += 1
            return replica

    def _forward(
        self,
        replica: Replica,
        method: str,
        path: str,
        body: bytes | None,
        headers: dict[str, str],
    ) -> tuple[int, bytes, str]:
        """One proxied request on a replica :meth:`_claim` returned,
        recorded as a ``gateway.proxy`` span on the request's trace id
        (upstream wall time = span duration); releases the in-flight
        count. Returns (status, body, content_type); raises one of
        ``TRANSPORT_ERRORS`` on transport failure. Breaker and counters
        are the caller's job — retry logic needs to see the raw
        outcome."""
        t0 = time.perf_counter()
        status: Any = "error"
        try:
            status, payload, ctype = replica.upstream.request(
                method, path, body, headers, self.config.request_timeout_s
            )
            return status, payload, ctype
        finally:
            with self._route_lock:
                replica.inflight -= 1
            self.tracer.record_span(
                "gateway.proxy",
                "gateway",
                time.perf_counter() - t0,
                trace_id=headers.get(TRACE_HEADER),
                replica=replica.name,
                path=path,
                upstream_status=status,
            )

    @staticmethod
    def _status_class(status: int) -> str:
        return f"{status // 100}xx"

    def _record_outcome(self, replica: Replica, status: int) -> None:
        self._m_requests.inc(
            replica=replica.name, status=self._status_class(status)
        )
        if status in RETRIABLE_STATUSES:
            # replica-side trouble: feeds the breaker like a transport
            # failure (a 503-shedding replica needs backing off from too)
            replica.breaker.record_failure()
        else:
            # 2xx obviously; 4xx too — the *replica* answered fine, the
            # client's request was bad. 4xx must not trip a breaker.
            replica.breaker.record_success()

    # --------------------------------------------------------------- routes
    def handle_queries(self, body: bytes | None, headers) -> Answer:
        """``POST /queries.json``: ``headers`` is the request's header
        mapping, ``body`` None for a payload past ``max_payload_bytes``
        (left unread). The answer carries the trace id; while draining it
        also carries ``Connection: close``."""
        t0 = time.perf_counter()
        status = 500
        try:
            answer = self._handle_queries_inner(body, headers)
            status = answer[0]
            return answer
        finally:
            self._m_latency.observe(
                time.perf_counter() - t0, endpoint="/queries.json"
            )
            # client-visible outcome (an escaping exception becomes a
            # 500): the fleet-availability SLO's input
            self._m_responses.inc(status=self._status_class(status))

    def _handle_queries_inner(self, body: bytes | None, headers) -> Answer:
        if body is None:
            return _json(413, {"message": "query payload too large"})
        # sticky key for the consistent-hash tie-break; a non-JSON body
        # still routes (the replica will 400 it properly)
        try:
            key = routing_key(json.loads(body), self.config.sticky_key_field)
        except (ValueError, TypeError):
            key = body.decode("utf-8", errors="replace")
        trace_id = headers.get(TRACE_HEADER) or mint_trace_id()
        fwd_headers = {
            "Content-Type": "application/json",
            TRACE_HEADER: trace_id,
        }
        with self._count_lock:
            self._inflight_requests += 1
            if self._inflight_requests > self._inflight_peak:
                self._inflight_peak = self._inflight_requests
        try:
            status, ctype, payload, extra = self._route_query(
                key, body, fwd_headers, trace_id
            )
        finally:
            with self._count_lock:
                self._inflight_requests -= 1
        extra = {**extra, TRACE_HEADER: trace_id}
        if status >= 500:
            # the zero-5xx invariant just broke for a real client: capture
            # the fleet state while the evidence — the dead replica's
            # cached spans, the ring history — is still warm
            self._trigger_incident(
                "fleet-5xx",
                {"status": status, "traceId": trace_id},
            )
        if self._draining:
            # drain keeps ANSWERING: the listener is closed (new
            # connections refused at TCP), but a request arriving on an
            # established keep-alive connection is served — 503ing it
            # would be the 5xx the drain exists to avoid. Connection:
            # close winds the keep-alive down so the client reconnects
            # elsewhere and the drain converges.
            extra["Connection"] = "close"
        return status, ctype, payload, extra

    def _route_query(
        self,
        key: str,
        body: bytes,
        headers: dict[str, str],
        trace_id: str,
    ) -> Answer:
        with self.tracer.span(
            "gateway.route", kind="gateway", trace_id=trace_id
        ) as route_span:
            answer = self._route_query_inner(key, body, headers, route_span)
            route_span.tags["status"] = answer[0]
            return answer

    def _route_query_inner(
        self,
        key: str,
        body: bytes,
        headers: dict[str, str],
        route_span: Any,
    ) -> Answer:
        self.retry_budget.record_attempt()
        pick_meta: dict[str, Any] = {}
        first = self._claim(key, meta=pick_meta)
        route_span.tags.update(pick_meta)
        if first is None:
            self._m_no_replica.inc()
            route_span.tags["shed"] = True
            return self._unavailable(
                "no healthy replica available", self.config.shed_retry_after_s
            )
        route_span.tags["replica"] = first.name
        route_span.tags["breaker"] = first.breaker.snapshot()["state"]
        failure: tuple[int, bytes, str] | None = None
        try:
            status, payload, ctype = self._forward(
                first, "POST", "/queries.json", body, headers
            )
        except TRANSPORT_ERRORS as exc:
            first.breaker.record_failure()
            self._m_requests.inc(replica=first.name, status="error")
            logger.warning("forward to %s failed: %s", first.name, exc)
        else:
            self._record_outcome(first, status)
            if status not in RETRIABLE_STATUSES:
                return status, _bare(ctype), payload, {}
            failure = (status, payload, ctype)
        # one retry on a DIFFERENT replica — /queries.json is idempotent
        # (pure read), so re-dispatch cannot double-apply anything
        if self.retry_budget.try_spend():
            retry_meta: dict[str, Any] = {}
            second = self._claim(
                key, exclude=frozenset((first.name,)), meta=retry_meta
            )
            if second is not None:
                self._m_retries.inc()
                route_span.tags["retried"] = True
                route_span.tags["retry_replica"] = second.name
                if retry_meta.get("panic"):
                    route_span.tags["panic"] = True
                try:
                    status, payload, ctype = self._forward(
                        second, "POST", "/queries.json", body, headers
                    )
                except TRANSPORT_ERRORS as exc:
                    second.breaker.record_failure()
                    self._m_requests.inc(replica=second.name, status="error")
                    logger.warning(
                        "retry forward to %s failed: %s", second.name, exc
                    )
                else:
                    self._record_outcome(second, status)
                    return status, _bare(ctype), payload, {}
        if failure is not None:
            # relay the replica's own 5xx rather than masking it
            status, payload, ctype = failure
            return status, _bare(ctype), payload, {}
        return self._unavailable(
            "replica unavailable and retry failed",
            self.config.shed_retry_after_s,
        )

    def proxy_admin(
        self, method: str, path: str, body: bytes | None, headers
    ) -> Answer:
        """Single-dispatch proxy for the non-idempotent rollout admin
        surface: exactly ONE replica sees the request (the registry is
        the fan-out — every other replica adopts the state change via
        its sync loop). Never retried: a promote that timed out may
        still have landed."""
        replica = self._claim(path)
        if replica is None:
            return self._unavailable(
                "no healthy replica available", self.config.shed_retry_after_s
            )
        trace_id = headers.get(TRACE_HEADER) or mint_trace_id()
        try:
            status, payload, ctype = self._forward(
                replica,
                method,
                path,
                body,
                {"Content-Type": "application/json", TRACE_HEADER: trace_id},
            )
        except TRANSPORT_ERRORS as exc:
            replica.breaker.record_failure()
            self._m_requests.inc(replica=replica.name, status="error")
            return self._unavailable(
                f"replica {replica.name} unreachable: {exc}",
                self.config.shed_retry_after_s,
            )
        self._record_outcome(replica, status)
        return status, _bare(ctype), payload, {}

    def handle_models_post(self, action: str, body: bytes | None, headers) -> Answer:
        if action not in ("candidate", "promote", "rollback"):
            return _json(404, {"message": "unknown action"})
        return self.proxy_admin("POST", f"/models/{action}", body, headers)

    def handle_profile_capture(self, query_string: str, body: bytes | None, headers) -> Answer:
        """Fan a device capture out to exactly ONE replica (the
        single-flight lives server-side; a broadcast would trip every
        replica's 409 rail at once). ``?ms=`` and friends pass through."""
        path = "/profile/capture"
        if query_string:
            path += "?" + query_string
        return self.proxy_admin("POST", path, body, headers)

    def handle_profile_stacks(self, query: dict[str, str]) -> Answer:
        """The GATEWAY's own host stacks (folded; ``?format=json`` for
        the structured view) — replica stacks live on each replica's own
        /profile/stacks."""
        if query.get("format") == "json":
            body = self.sampler.snapshot()
            body["hotspots"] = self.sampler.hotspots()
            return _json(200, body)
        return 200, "text/plain; charset=utf-8", self.sampler.folded().encode(), {}

    def handle_metrics(self, query: dict[str, str], headers) -> Answer:
        """Federated fleet scrape: every reachable replica's /metrics
        merged (counters summed, histogram buckets added) plus the
        gateway's own pio_fleet_* instruments. An OpenMetrics-negotiated
        scrape (Accept or ``?exemplars=1``) federates the replicas'
        exemplar-decorated expositions and carries the clauses through
        the merge."""
        exemplars = _wants_exemplars(query, headers)
        text = self._federate(exemplars=exemplars)
        ctype = OPENMETRICS_CONTENT_TYPE if exemplars else PROMETHEUS_CONTENT_TYPE
        return 200, ctype, text.encode(), {}

    def _federate(self, exemplars: bool = False) -> str:
        """Fetch + merge the fleet's expositions; refreshes the cached
        federated parse the fleet SLO sources read."""
        texts = [self.metrics.render_prometheus(exemplars=exemplars)]
        results = self._fan(
            lambda r: self._fetch_metrics(r, exemplars=exemplars), self.replicas
        )
        texts.extend(t for t in results if t is not None)
        merged = federate_metrics(texts, exemplars=exemplars)
        self._last_federated = parse_prometheus(merged)
        return merged

    def _fetch_metrics(
        self, replica: Replica, exemplars: bool = False
    ) -> str | None:
        suffix = "?exemplars=1" if exemplars else ""
        try:
            status, data = _get(
                f"{replica.url}/metrics{suffix}", self.config.probe_timeout_s
            )
        except TRANSPORT_ERRORS:
            return None
        if status != 200:
            return None
        return data.decode("utf-8", errors="replace")

    # ----------------------------------------------------- trace fan-in
    def _fetch_spans(self, url: str) -> list[dict[str, Any]] | None:
        try:
            status, data = _get(url, self.config.probe_timeout_s)
            if status != 200:
                return None
            spans = json.loads(data).get("spans")
        except (*TRANSPORT_ERRORS, ValueError, AttributeError):
            return None
        return spans if isinstance(spans, list) else None

    def _fetch_traces(self, replica: Replica) -> None:
        """Refresh one replica's span cache. Failures keep the stale
        cache — a SIGKILLed replica's final spans are incident evidence,
        not staleness."""
        spans = self._fetch_spans(
            f"{replica.url}/traces/recent?limit={TRACE_FANIN_LIMIT}"
        )
        if spans is not None:
            self._replica_spans[replica.name] = spans

    def _fetch_peer_traces(self, peer_url: str) -> None:
        """Refresh one gateway peer's span cache from its LOCAL view
        (``?local=1`` stops the fan-in recursing peer->peer->peer).
        Failures keep the stale cache."""
        spans = self._fetch_spans(
            f"{peer_url}/traces/recent?limit={TRACE_FANIN_LIMIT}&local=1"
        )
        if spans is not None:
            self._peer_spans[peer_url] = spans

    def _peer_cached_spans(self) -> list[dict[str, Any]]:
        out: list[dict[str, Any]] = []
        for url, spans in list(self._peer_spans.items()):
            out.extend(
                {**s, "gatewayPeer": url} if "gatewayPeer" not in s else s
                for s in spans
            )
        return out

    def merged_recent(
        self,
        limit: int = 100,
        trace_id: str | None = None,
        peers: bool = True,
    ) -> list[dict[str, Any]]:
        """The fan-in merged trace view: gateway ring + every replica's,
        refreshed live from healthy replicas (dead ones serve from the
        telemetry tick's cache), plus — in a multi-gateway tier — every
        peer gateway's local view. With ``trace_id``, the assembled
        cross-tier waterfall: that trace's spans only, oldest first."""
        fetches: list[Any] = [
            (self._fetch_traces, r) for r in self.replicas if r.healthy
        ]
        if peers:
            fetches += [(self._fetch_peer_traces, u) for u in self.config.peer_urls]
        self._fan(lambda job: job[0](job[1]), fetches)
        merged = self.cached_spans()
        if peers and self.config.peer_urls:
            # peers also fan in from the shared replica set; drop spans
            # this gateway already holds (same trace id + name + start)
            seen = {
                (s.get("traceId"), s.get("name"), s.get("startTime"))
                for s in merged
            }
            merged += [
                s
                for s in self._peer_cached_spans()
                if (s.get("traceId"), s.get("name"), s.get("startTime"))
                not in seen
            ]
            merged.sort(key=lambda s: s.get("startTime", 0.0), reverse=True)
        if trace_id is not None:
            waterfall = [s for s in merged if s.get("traceId") == trace_id]
            waterfall.sort(key=lambda s: s.get("startTime", 0.0))
            return waterfall
        return merged[: max(0, limit)]

    def handle_traces(self, query: dict[str, str]) -> Answer:
        try:
            limit = int(query.get("limit", 100))
        except ValueError:
            return _json(400, {"message": "limit must be an integer"})
        trace_id = query.get("trace_id") or None
        local = query.get("local") not in (None, "", "0")
        spans = self.merged_recent(
            limit=limit, trace_id=trace_id, peers=not local
        )
        return _json(200, {"spans": spans})

    # ----------------------------------------------------- telemetry ring
    def fleet_snapshot(self) -> dict[str, Any]:
        """One telemetry-ring record: per-replica state + federated
        counters + SLO burn — the queue-depth/burn/utilization history
        the autoscaler reads."""
        fed = self._last_federated
        counters = {
            key: sum(v for _labels, v in fed.get(name, ()))
            for key, name in (
                ("requests", "pio_fleet_requests_total"),
                ("retries", "pio_fleet_retries_total"),
                ("no_replica", "pio_fleet_no_replica_total"),
                ("panic_picks", "pio_fleet_panic_picks_total"),
                ("overflow_picks", "pio_fleet_overflow_picks_total"),
                # the workers' own admission-control sheds, federated
                ("load_shed", "pio_load_shed_total"),
            )
        }
        counters["errors_5xx"] = sum(
            v
            for labels, v in fed.get("pio_fleet_requests_total", ())
            if labels.get("status") in ("5xx", "error")
        )
        inflight_now = sum(r.inflight for r in self.replicas)
        gauges = {
            "queue_depth": sum(
                v for _labels, v in fed.get("pio_queue_depth", ())
            ),
            "inflight": inflight_now,
            # peak concurrency since the previous TELEMETRY TICK — the
            # alias-proof pressure signal the autoscaler reads. This
            # getter is side-effect-free: incident captures also call it,
            # and a capture mid-spike must not consume the high-water
            # mark out from under the ring
            "inflight_peak": max(self._inflight_peak, inflight_now),
        }
        slo: dict[str, Any] = {}
        for report in self.slo.evaluate():
            slo[report["name"]] = {
                "alerting": report["alerting"],
                "burn": {
                    str(int(w["window_s"])): w["burn_rate"]
                    for w in report["windows"]
                },
            }
        return {
            "kind": "fleet",
            "gateway": self.config.gateway_id,
            "replicas": {
                r.name: {
                    "healthy": r.healthy,
                    "ever_ready": r.ever_ready,
                    "inflight": r.inflight,
                    "class": r.worker_class,
                    "breaker": r.breaker.snapshot()["state"],
                }
                for r in self.replicas
            },
            "shape": self.replica_shape(),
            "counters": counters,
            "gauges": gauges,
            "slo": slo,
        }

    def _telemetry_tick(self) -> None:
        self._federate()
        self._fan(self._fetch_traces, [r for r in self.replicas if r.healthy])
        self.slo.tick()
        record = self.fleet_snapshot()
        # SLO alert *transitions* trigger the flight recorder (level
        # triggers would re-fire every tick of a long burn)
        for name, state in record["slo"].items():
            was = self._slo_alerting.get(name, False)
            now_alerting = bool(state["alerting"])
            self._slo_alerting[name] = now_alerting
            if now_alerting and not was:
                self._trigger_incident("slo-alert", {"slo": name, **state})
        if self.telemetry is not None:
            self.telemetry.append(record)
            self._m_telemetry_snapshots.inc()
        # ONLY the telemetry tick consumes the inflight high-water mark
        # (reset to the current level so a sustained plateau stays
        # visible on the next record)
        with self._count_lock:
            self._inflight_peak = self._inflight_requests

    def _telemetry_loop(self, interval: float) -> None:
        while not self._stop_loops.is_set():
            try:
                self._telemetry_tick()
            except Exception:
                self._m_telemetry_errors.inc()
                logger.exception("telemetry tick failed")
            self._stop_loops.wait(interval)

    def handle_telemetry(self, query: dict[str, str]) -> Answer:
        if self.telemetry is None:
            return _json(404, {"message": "no telemetry ring attached"})
        try:
            seconds = float(query.get("s", 600))
        except ValueError:
            return _json(400, {"message": "s must be a number"})
        records = self.telemetry.window(seconds)
        return _json(200, {"windowS": seconds, "records": records})

    def handle_slo(self, query: dict[str, str]) -> Answer:
        local = query.get("local") not in (None, "", "0")
        if local or not self.config.peer_urls:
            status, ctype, body = slo_response(self.slo)
            return status, ctype, body, {}
        # multi-gateway tier: each peer rates the traffic the balancer
        # sent IT; the fan-in view answers for the tier from any member.
        # A peer that cannot answer is reported, not hidden.
        report = self.slo.report()
        report["gateway"] = self.config.gateway_id
        peers: dict[str, Any] = {}
        for url in self.config.peer_urls:
            try:
                status, data = _get(f"{url}/slo?local=1", self.config.probe_timeout_s)
                if status == 200:
                    peers[url] = json.loads(data)
                else:
                    peers[url] = {"error": f"status {status}"}
            except (*TRANSPORT_ERRORS, ValueError) as exc:
                peers[url] = {"error": type(exc).__name__}
        report["peers"] = peers
        return _json(200, report)

    def handle_healthz(self) -> Answer:
        healthy = sum(1 for r in self.replicas if r.healthy)
        ready = healthy > 0 and not self._draining
        return _json(
            200 if ready else 503,
            {
                "ready": ready,
                "draining": self._draining,
                "replicasHealthy": healthy,
                "replicasTotal": len(self.replicas),
            },
        )

    def handle_status(self) -> Answer:
        return _json(
            200,
            {
                "status": "alive",
                "role": "gateway",
                "draining": self._draining,
                "replicas": [r.snapshot() for r in self.replicas],
                "retryBudgetTokens": self.retry_budget.tokens,
            },
        )

    def handle_stop(self) -> Answer:
        self.stop_requested.set()
        return _json(200, {"message": "Stopping."})

    @staticmethod
    def _unavailable(message: str, retry_after_s: float) -> Answer:
        return _json(
            503,
            {"message": message},
            {"Retry-After": str(max(1, round(retry_after_s)))},
        )

    # ---------------------------------------------------------------- probes
    def _probe_loop(self) -> None:
        while not self._stop_loops.is_set():
            try:
                self._fan(self._probe, self.replicas)
            except Exception:
                logger.exception("probe pass failed")
            self._stop_loops.wait(self.config.probe_interval_s)

    def _probe(self, replica: Replica) -> None:
        try:
            # probe GETs are the health plane's own traffic; their
            # OUTCOME transitions route through _note_transition below
            status, _ = _get(f"{replica.url}/healthz", self.config.probe_timeout_s)
            ok = status == 200
        except TRANSPORT_ERRORS:
            ok = False
        if ok:
            if not replica.healthy:
                replica.healthy = True
                if replica.ever_ready:
                    self._note_transition("readmit", replica)
                    logger.info("replica %s readmitted", replica.name)
                else:
                    self._note_transition("up", replica)
                    logger.info("replica %s up", replica.name)
            replica.ever_ready = True
        elif replica.healthy:
            replica.healthy = False
            if replica.ever_ready:
                self._note_transition("eject", replica)
                logger.warning(
                    "replica %s ejected (failed /healthz)", replica.name
                )
            else:
                logger.info("replica %s not ready yet", replica.name)

    # ------------------------------------------------------------------ HTTP
    def route(self, method: str, target: str, body: bytes | None, headers) -> Answer:
        """The answer to one request; ``target`` is the request line's
        path with its query string."""
        split = urlsplit(target)
        path = split.path
        query = dict(parse_qsl(split.query))
        if method == "GET":
            gets = {
                "/": self.handle_status,
                "/healthz": self.handle_healthz,
                "/metrics": lambda: self.handle_metrics(query, headers),
                "/slo": lambda: self.handle_slo(query),
                "/traces/recent": lambda: self.handle_traces(query),
                "/telemetry/window": lambda: self.handle_telemetry(query),
                "/models": lambda: self.proxy_admin("GET", "/models", None, headers),
                "/profile/stacks": lambda: self.handle_profile_stacks(query),
            }
            if path in gets:
                return gets[path]()
        elif method == "POST":
            if path == "/queries.json":
                return self.handle_queries(body or b"", headers)
            if path.startswith("/models/") and path.count("/") == 2:
                return self.handle_models_post(path.rsplit("/", 1)[1], body, headers)
            if path == "/profile/capture":
                return self.handle_profile_capture(split.query, body, headers)
            if path == "/stop":
                return self.handle_stop()
        return _json(404, {"message": "not found"})

    def _handler(self):
        gateway = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # headers and body go out in two writes: with Nagle's
            # algorithm on, the body would wait for the client's delayed
            # ACK
            disable_nagle_algorithm = True

            def log_message(self, fmt, *args):
                logger.debug("%s " + fmt, self.address_string(), *args)

            def _answer(self, answer: Answer) -> None:
                status, ctype, data, headers = answer
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                for k, v in headers.items():
                    self.send_header(k, v)  # "Connection: close" ends the keep-alive
                self.end_headers()
                self.wfile.write(data)

            def _route(self, method: str, body: bytes | None) -> Answer:
                try:
                    return gateway.route(method, self.path, body, self.headers)
                except Exception:  # an answer, as aiohttp gives one, not a reset
                    logger.exception("gateway %s %s failed", method, self.path)
                    return _json(500, {"message": "internal gateway error"})

            def do_GET(self):
                self._answer(self._route("GET", None))

            def do_POST(self):
                queries = self.path.split("?", 1)[0] == "/queries.json"
                try:
                    body = read_body(self.headers, self.rfile,
                                     gateway.config.max_payload_bytes if queries else None)
                except BodyTooLarge:
                    self.close_connection = True  # the rest stays unread
                    self._answer(gateway.handle_queries(None, self.headers))
                    return
                except BodyError as exc:
                    reply_bad_framing(self, exc)
                    return
                self._answer(self._route("POST", body))

        return Handler

    # ------------------------------------------------------------- lifecycle
    def start(self) -> int:
        """Bind and serve on a thread of its own, start the host sampler,
        the probe loop (its first pass at once) and the telemetry loop;
        returns the bound port."""
        httpd = _GatewayHTTPServer((self.config.ip, self.config.port), self._handler(), self)
        self._httpd = httpd
        self._serve_thread = threading.Thread(
            target=httpd.serve_forever, name="pio-http-gateway", daemon=True
        )
        self._serve_thread.start()
        self.sampler.start()
        loops = [("pio-gateway-probe", self._probe_loop, ())]
        interval = self.config.telemetry_interval_s
        if interval is None:
            interval = self.config.probe_interval_s
        if interval > 0:
            loops.append(("pio-gateway-telemetry", self._telemetry_loop, (interval,)))
        for name, target, args in loops:
            t = threading.Thread(target=target, args=args, name=name, daemon=True)
            t.start()
            self._loops.append(t)
        port = httpd.server_address[1]
        logger.info(
            "fleet gateway on %s:%d (%d replicas)",
            self.config.ip,
            port,
            len(self.replicas),
        )
        return port

    def _close_listener(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
            self._serve_thread.join(timeout=10)

    def drain(self) -> None:
        """Stop accepting, answer in-flight, then return. Idempotent."""
        if self._draining:
            return
        self._draining = True
        logger.info(
            "gateway drain: listener closing, %d in flight",
            self._inflight_requests,
        )
        self._close_listener()
        deadline = time.monotonic() + max(0.0, self.config.drain_grace_s)
        while self._inflight_requests > 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        if self._inflight_requests:
            logger.warning(
                "gateway drain grace expired with %d requests in flight",
                self._inflight_requests,
            )

    def _hang_up_connections(self) -> None:
        """End the read side of every open connection: a handler waiting
        for its client's next request reads end of stream and returns; a
        handler still writing an answer finishes it first."""
        with self._count_lock:
            conns = list(self._open_connections)
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RD)
            except OSError:  # the client hung up first
                pass

    def stop(self) -> None:
        """Stop the loops and the listener, hang up the keep-alive
        connections, close the upstream pools."""
        self._stop_loops.set()
        self.sampler.stop()
        for t in self._loops:
            t.join(timeout=10)
        self._loops = []
        self._close_listener()
        self._hang_up_connections()
        self._fanout.shutdown(wait=True)
        self._incident_pool.shutdown(wait=True)
        for r in self.replicas:
            r.upstream.close()


def _bare(content_type: str) -> str:
    """The proxied upstream content type without parameters, as the
    reference relays it (aiohttp's ``Response(content_type=...)`` takes
    none)."""
    return content_type.split(";", 1)[0].strip() or "application/json"


class GatewayGroup:
    """The autoscaler's view of a multi-gateway tier: membership changes
    (add/retire) fan out to EVERY gateway — all peers route over the
    same replica set, so a scale-out a single gateway learned about
    would silently halve itself behind the balancer. Everything else
    (ring reads, shape) delegates to the primary. Shared-nothing
    otherwise: peers never exchange routing state."""

    def __init__(self, gateways: list[Gateway]):
        if not gateways:
            raise ValueError("GatewayGroup needs at least one gateway")
        self.gateways = list(gateways)
        self.primary = gateways[0]

    def add_replica(self, url: str, worker_class: str = "device") -> None:
        for gw in self.gateways:
            gw.add_replica(url, worker_class)

    def retire_replica(self, url_or_name: str) -> None:
        for gw in self.gateways:
            gw.retire_replica(url_or_name)

    def __getattr__(self, name: str) -> Any:
        return getattr(self.primary, name)


__all__ = [
    "Gateway",
    "GatewayConfig",
    "GatewayGroup",
    "Replica",
    "RETRIABLE_STATUSES",
]
