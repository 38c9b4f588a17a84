"""REST event-collection server over the standard library's
``ThreadingHTTPServer``.

Port of the data routes of ``predictionio_tpu/data/api/event_server.py``
(ref ``data/.../api/EventServer.scala:54-663``)::

  GET  /                       -> {"status": "alive"}
  GET  /healthz                -> readiness: the storage breaker (503 open)
  GET  /metrics                -> Prometheus text exposition (obs registry)
  GET  /slo                    -> the ingestion availability SLO's burn rates
  GET  /traces/recent          -> recent request spans (ring buffer)
  POST /profile/capture?ms=    -> one bounded torch.profiler capture (409 busy)
  GET  /profile/stacks         -> the host sampler's folded stacks
  POST /events.json            -> 201 {"eventId": ...} (single event)
  GET  /events.json            -> filtered query (default limit 20)
  GET  /events/<id>.json       -> one event
  DELETE /events/<id>.json     -> {"message": "Found"} | 404
  POST /batch/events.json      -> per-event status array, <= 50 events
  GET  /stats.json             -> ingestion stats (requires --stats)
  GET  /plugins.json           -> plugin inventory
  GET  /plugins/<type>/<name>/...  -> plugin REST surface
  POST /webhooks/<name>.json   -> JSON connector ingestion
  GET  /webhooks/<name>.json   -> connector presence check
  POST /webhooks/<name>        -> form connector ingestion
  GET  /webhooks/<name>        -> connector presence check

Auth (ref :92-130): ``accessKey`` query param, or HTTP Basic where the
username is the access key; per-key allowed-event enforcement; optional
``channel`` query param must name an existing channel of the key's app.
Status codes and JSON bodies are the JAX server's; a path no route matches
answers 404 and a method a path does not take answers 405, with aiohttp's
plain-text bodies.

Each connection is served on its own thread and storage calls run on it;
the sqlite backend serialises them on its connection lock. With TLS, the
handshake runs on that thread too, never in the serve thread's
``accept()`` (``utils/tls.py``).

Every storage call (the access-key and channel lookups included) runs
through one :class:`ResiliencePolicy`: a transient failure is retried with
backoff, ``breaker_threshold`` consecutive failures open the storage
breaker, and while it is open a request answers 503 ``"storage
unavailable: ..."`` with ``Retry-After`` without touching storage. A
storage failure that is not the breaker's answers 500, on reads as on
writes; a 400 is only ever the client's fault. A batch request
inserts its events one by one, each with its own status, as the JAX server
does. A client's ``creationTime`` is ignored, as in the JAX server: an
event's creation time is when this server accepted it, the key of the
store's tail order.

Observability, as in the JAX server: every request accepts or mints an
``X-Pio-Trace-Id`` (echoed), records an ``http.event`` ingress span, and
counts into ``pio_requests_total{endpoint,status}`` and
``pio_request_seconds{endpoint}`` under its route pattern (the JAX
server's canonical aiohttp resource, ``/events/{event_id}.json``, not the
raw path). Storage calls go through traced DAOs (``storage.<dao>.<method>``
spans on the same trace). The availability SLO rates the collection
routes only. Captures on the event server record the CPU: it launches no
kernel.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import logging
import re
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from predictionio_tpu_torch.data.api.plugins import EventInfo, EventServerPluginContext
from predictionio_tpu_torch.data.api.stats import StatsCollector
from predictionio_tpu_torch.data.event import Event, parse_event_time
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.data.webhooks import (
    ConnectorException,
    connector_to_event,
    form_connector,
    json_connector,
)
from predictionio_tpu_torch.data.storage.traced import trace_dao
from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.obs.profiler import ProfileBusyError, ProfileSession, ProfileStore
from predictionio_tpu_torch.obs.sampler import HostSampler
from predictionio_tpu_torch.obs.slo import SLOEngine, counter_ratio_source
from predictionio_tpu_torch.obs.tracing import (
    TRACE_HEADER,
    Tracer,
    get_tracer,
    mint_trace_id,
    reset_trace_id,
    set_trace_id,
)
from predictionio_tpu_torch.obs.web import (
    BreakerInstruments,
    metrics_response,
    slo_response,
    traces_response,
)
from predictionio_tpu_torch.resilience.breaker import OPEN, CircuitBreaker, CircuitOpenError
from predictionio_tpu_torch.resilience.policy import ResiliencePolicy
from predictionio_tpu_torch.resilience.retry import RetryBudget, RetryPolicy
from predictionio_tpu_torch.utils.httpbody import BodyError, BodyTooLarge, read_body, reply_bad_framing
from predictionio_tpu_torch.utils.tls import HandshakeOnHandlerThread, server_ssl_context

logger = logging.getLogger(__name__)

MAX_EVENTS_PER_BATCH_REQUEST = 50  # ref EventServer.scala:70
MAX_BODY_BYTES = 16 << 20

# the routes that ARE the collection API: the availability SLO rates these
# and only these (health checks and scrapes must not mask an outage)
COLLECTION_ENDPOINTS = frozenset({
    "/events.json",
    "/events/{event_id}.json",
    "/batch/events.json",
    "/webhooks/{name}.json",
    "/webhooks/{name}",
})
# fixed routes, labelled as themselves
_FIXED_ROUTES = frozenset({
    "/", "/healthz", "/metrics", "/slo", "/traces/recent", "/profile/capture",
    "/profile/stacks", "/events.json", "/batch/events.json", "/stats.json", "/plugins.json",
})


@dataclasses.dataclass
class EventServerConfig:
    ip: str = "0.0.0.0"
    port: int = 7070
    stats: bool = False
    # TLS (ref common/SSLConfiguration.scala): PEM cert + key paths
    ssl_certfile: str | None = None
    ssl_keyfile: str | None = None
    # transient storage failures retry with exponential backoff before the
    # request fails; <= 1 disables retries
    storage_retries: int = 3
    storage_backoff_s: float = 0.05
    # consecutive storage failures that open the breaker: requests then
    # answer 503 "storage unavailable" + Retry-After without touching storage
    breaker_threshold: int = 5
    breaker_recovery_s: float = 5.0
    # ingestion availability SLO: non-5xx fraction of collection-API answers
    slo_availability_objective: float = 0.999
    # POST /profile/capture and GET /profile/stacks, as on the query server
    profile_dir: str = "pio_obs/profiles"
    profile_max_bundles: int = 20
    profile_default_ms: int = 500
    profile_max_ms: int = 10_000
    sampler_period_s: float = 0.05

    def ssl_context(self):
        return server_ssl_context(self.ssl_certfile, self.ssl_keyfile)


@dataclasses.dataclass
class _Raw:
    """A body already encoded, with its content type (the obs answers)."""

    data: bytes
    content_type: str


class BlockedEvent(Exception):
    """An input-blocker plugin rejected the event."""


@dataclasses.dataclass
class AuthData:
    app_id: int
    channel_id: int | None
    events: tuple[str, ...]

    def allows(self, event_name: str) -> bool:
        return not self.events or event_name in self.events


@dataclasses.dataclass
class Request:
    """One decoded HTTP request: what a route handler reads."""

    method: str
    path: str
    query: dict[str, str]  # first value of each parameter
    headers: dict[str, str]  # lower-cased names
    body: bytes = b""


# status, JSON body (a str body is sent as text), and optionally headers
Response = tuple[int, Any] | tuple[int, Any, dict[str, str]]


def _error(status: int, message: str) -> Response:
    return status, {"message": message}


def _storage_unavailable(exc: CircuitOpenError) -> Response:
    return (503, {"message": f"storage unavailable: {exc}"},
            {"Retry-After": str(max(1, round(exc.retry_after_s)))})


def _decode_event(item: Any) -> Event:
    """A wire event without the client's ``creationTime`` (see the module
    docstring)."""
    if isinstance(item, dict) and "creationTime" in item:
        item = {k: v for k, v in item.items() if k != "creationTime"}
    return Event.from_json_dict(item)


_EVENT_ID = re.compile(r"^/events/([^/{}]+)\.json$")
_WEBHOOK_JSON = re.compile(r"^/webhooks/([^/{}]+)\.json$")
_WEBHOOK_FORM = re.compile(r"^/webhooks/([^/{}]+)$")
_PLUGIN = re.compile(r"^/plugins/(.+)$")


class EventServer:
    def __init__(
        self,
        storage: Storage | None = None,
        config: EventServerConfig | None = None,
        plugin_context: EventServerPluginContext | None = None,
        tracer: Tracer | None = None,
    ):
        self.storage = storage or Storage.instance()
        self.config = config or EventServerConfig()
        # DAO calls record storage.<dao>.<method> spans on the ingress trace
        self.tracer = tracer or get_tracer()
        self.levents = trace_dao(self.storage.get_l_events(), "l_events", tracer=self.tracer)
        self.access_keys = trace_dao(
            self.storage.get_meta_data_access_keys(), "access_keys", tracer=self.tracer
        )
        self.channels = trace_dao(self.storage.get_meta_data_channels(), "channels", tracer=self.tracer)
        self.metrics = MetricsRegistry()
        self.stats = StatsCollector(registry=self.metrics)
        self.plugin_context = plugin_context or EventServerPluginContext()
        self._m_requests = self.metrics.counter(
            "pio_requests_total", "HTTP requests served, by route and status", labelnames=("endpoint", "status")
        )
        self._m_latency = self.metrics.histogram(
            "pio_request_seconds", "HTTP request wall time, by route", labelnames=("endpoint",)
        )
        self._m_retries = self.metrics.counter(
            "pio_storage_retries_total", "storage calls replayed by the retry policy"
        )
        self._breaker_instruments = BreakerInstruments(self.metrics)
        self.metrics.register_collector(self._breaker_instruments.collect)
        self.storage_policy = ResiliencePolicy(
            retry=RetryPolicy(
                max_attempts=max(1, self.config.storage_retries),
                backoff_base_s=self.config.storage_backoff_s,
                budget=RetryBudget(),
                on_retry=lambda exc: self._m_retries.inc(),
            ),
            breaker=self._breaker_instruments.watch(CircuitBreaker(
                name="eventdata",
                failure_threshold=self.config.breaker_threshold,
                recovery_timeout_s=self.config.breaker_recovery_s,
            )),
        )
        self.slo = SLOEngine(self.metrics)
        self.slo.add(
            "availability",
            "collection API answered without a 5xx",
            self.config.slo_availability_objective,
            counter_ratio_source(
                self._m_requests,
                bad=lambda lab: lab.get("status", "").startswith("5"),
                match=lambda lab: lab.get("endpoint") in COLLECTION_ENDPOINTS,
            ),
        )
        self.metrics.register_collector(self.slo.collect)
        self.sampler = HostSampler(
            period_s=self.config.sampler_period_s if self.config.sampler_period_s > 0 else 0.05,
            metrics=self.metrics,
        )
        self.profiler = ProfileSession(
            ProfileStore(self.config.profile_dir, self.config.profile_max_bundles),
            device="cpu",  # the event server launches no kernel
            default_ms=self.config.profile_default_ms,
            max_ms=self.config.profile_max_ms,
            context_fn=lambda: {"server": "event", "port": self.config.port},
            metrics=self.metrics,
        )
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------ auth
    def _authenticate(self, request: Request) -> AuthData | Response:
        access_key = request.query.get("accessKey")
        channel_name = request.query.get("channel")
        if access_key is None:
            auth_header = request.headers.get("authorization", "")
            if auth_header.startswith("Basic "):
                try:
                    decoded = base64.b64decode(auth_header[6:]).decode()
                    access_key = decoded.strip().split(":")[0]
                except Exception:
                    return _error(401, "Invalid accessKey.")
            else:
                return _error(401, "Missing accessKey.")
        key = self.storage_policy.call(self.access_keys.get, access_key)
        if key is None:
            return _error(401, "Invalid accessKey.")
        channel_id = None
        if channel_name is not None:
            channels = self.storage_policy.call(self.channels.get_by_app_id, key.appid)
            channel_map = {c.name: c.id for c in channels}
            if channel_name not in channel_map:
                return _error(401, f"Invalid channel '{channel_name}'.")
            channel_id = channel_map[channel_name]
        return AuthData(key.appid, channel_id, tuple(key.events))

    def _insert_one(self, auth: AuthData, event: Event) -> Response:
        """Blocker -> insert -> sniffer. Raises BlockedEvent when an input
        blocker rejects (-> 403), CircuitOpenError while the storage breaker
        is open (-> 503); any other exception is a storage failure (-> 500).
        Blockers run outside the storage policy: a rejection is the
        client's, neither retried nor counted against the breaker."""
        info = EventInfo(auth.app_id, auth.channel_id, event)
        for blocker in self.plugin_context.input_blockers.values():
            try:
                blocker.process(info, self.plugin_context)
            except Exception as exc:
                raise BlockedEvent(str(exc)) from exc
        event_id = self.storage_policy.call(self.levents.insert, event, auth.app_id, auth.channel_id)
        for sniffer in self.plugin_context.input_sniffers.values():
            try:
                sniffer.process(info, self.plugin_context)
            except Exception:  # sniffers must never fail the request
                logger.exception("input sniffer failed")
        return 201, {"eventId": event_id}

    def _ingest(self, auth: AuthData, event: Event) -> Response:
        """The single-event tail shared by POST /events.json and webhooks."""
        if not auth.allows(event.event):
            return _error(403, f"{event.event} events are not allowed")
        try:
            status, body = self._insert_one(auth, event)
        except BlockedEvent as exc:
            return _error(403, str(exc))
        except CircuitOpenError as exc:
            return _storage_unavailable(exc)
        except Exception as exc:
            logger.exception("event insert failed")
            return _error(500, str(exc))
        self.stats.bookkeeping(auth.app_id, status, event)
        return status, body

    # ---------------------------------------------------------------- routes
    def handle_post_event(self, request: Request, auth: AuthData) -> Response:
        try:
            event = _decode_event(json.loads(request.body.decode("utf-8")))
        except Exception as exc:
            return _error(400, str(exc))
        return self._ingest(auth, event)

    def handle_get_events(self, request: Request, auth: AuthData) -> Response:
        q = request.query
        try:
            reversed_ = q.get("reversed", "false").lower() == "true"
            if reversed_ and not (q.get("entityType") and q.get("entityId")):
                raise ValueError(
                    "the parameter reversed can only be used with both entityType "
                    "and entityId specified."
                )
            start_time = parse_event_time(q["startTime"]) if "startTime" in q else None
            until_time = parse_event_time(q["untilTime"]) if "untilTime" in q else None
            kwargs: dict[str, Any] = dict(
                app_id=auth.app_id,
                channel_id=auth.channel_id,
                start_time=start_time,
                until_time=until_time,
                entity_type=q.get("entityType"),
                entity_id=q.get("entityId"),
                event_names=[q["event"]] if "event" in q else None,
                limit=int(q.get("limit", 20)),
                reversed=reversed_,
            )
            if "targetEntityType" in q:
                kwargs["target_entity_type"] = q["targetEntityType"]
            if "targetEntityId" in q:
                kwargs["target_entity_id"] = q["targetEntityId"]
        except Exception as exc:
            return _error(400, str(exc))  # parameter errors only
        try:
            events = self.storage_policy.call(lambda: list(self.levents.find(**kwargs)))
        except CircuitOpenError as exc:
            return _storage_unavailable(exc)
        except Exception as exc:
            # a storage failure is a server-side outage (500), never a 400
            logger.exception("event find failed")
            return _error(500, str(exc))
        if not events:
            return _error(404, "Not Found")
        return 200, [e.to_json_dict() for e in events]

    def handle_get_event(self, request: Request, auth: AuthData, event_id: str) -> Response:
        event = self.storage_policy.call(self.levents.get, event_id, auth.app_id, auth.channel_id)
        if event is None:
            return _error(404, "Not Found")
        return 200, event.to_json_dict()

    def handle_delete_event(self, request: Request, auth: AuthData, event_id: str) -> Response:
        if not self.storage_policy.call(self.levents.delete, event_id, auth.app_id, auth.channel_id):
            return _error(404, "Not Found")
        return 200, {"message": "Found"}

    def handle_batch_events(self, request: Request, auth: AuthData) -> Response:
        try:
            payload = json.loads(request.body.decode("utf-8"))
            if not isinstance(payload, list):
                raise ValueError("batch request body must be a JSON array")
        except Exception as exc:
            return _error(400, str(exc))
        if len(payload) > MAX_EVENTS_PER_BATCH_REQUEST:
            return _error(
                400,
                "Batch request must have less than or equal to "
                f"{MAX_EVENTS_PER_BATCH_REQUEST} events",
            )
        results: list[dict[str, Any] | None] = []
        to_insert: list[tuple[int, Event]] = []  # (result slot, event)
        for item in payload:
            try:
                event = _decode_event(item)
            except Exception as exc:
                results.append({"status": 400, "message": str(exc)})
                continue
            if not auth.allows(event.event):
                results.append({"status": 403, "message": f"{event.event} events are not allowed"})
                continue
            results.append(None)
            to_insert.append((len(results) - 1, event))
        for slot, event in to_insert:
            try:
                status, body = self._insert_one(auth, event)
            except BlockedEvent as exc:
                status, body = 403, {"message": str(exc)}
            except CircuitOpenError as exc:
                status, body = 503, {"message": f"storage unavailable: {exc}"}
            except Exception as exc:
                status, body = 500, {"message": str(exc)}
            results[slot] = {"status": status, **body}
            if status == 201:
                self.stats.bookkeeping(auth.app_id, status, event)
        return 200, results

    def handle_stats(self, request: Request, auth: AuthData) -> Response:
        if not self.config.stats:
            return _error(404, "To see stats, launch Event Server with --stats argument.")
        return 200, self.stats.get_stats(auth.app_id)

    def handle_plugin_rest(self, request: Request, auth: AuthData, tail: str) -> Response:
        parts = tail.split("/")
        if len(parts) < 2:
            return _error(404, "Not Found")
        plugin_type, plugin_name, *args = parts
        registry = (
            self.plugin_context.input_blockers
            if plugin_type == "inputblocker"
            else self.plugin_context.input_sniffers
        )
        plugin = registry.get(plugin_name)
        if plugin is None:
            return _error(404, f"Unknown plugin {plugin_name}")
        return 200, plugin.handle_rest(auth.app_id, auth.channel_id, args)

    def handle_webhook(
        self, request: Request, auth: AuthData, name: str, form: bool
    ) -> Response:
        connector = form_connector(name) if form else json_connector(name)
        if connector is None:
            return _error(404, f"webhooks connection for {name} is not supported.")
        if request.method == "GET":
            return 200, {"message": f"webhooks {name} connected."}
        try:
            if form:
                fields = dict(
                    urllib.parse.parse_qsl(request.body.decode("utf-8"), keep_blank_values=True)[::-1]
                )  # reversed: the first value of a repeated field wins
                event = connector_to_event(connector, fields)
            else:
                event = connector_to_event(connector, json.loads(request.body.decode("utf-8")))
        except (ConnectorException, ValueError) as exc:
            return _error(400, str(exc))
        return self._ingest(auth, event)

    def handle_healthz(self) -> Response:
        """Readiness, distinct from ``/`` liveness: not ready while the
        storage breaker is open, so a load balancer routes around us."""
        snap = self.storage_policy.snapshot()
        ready = snap["breaker"]["state"] != OPEN
        return (200 if ready else 503), {"ready": ready, **snap}

    def handle_profile_capture(self, request: Request) -> Response:
        raw = request.query.get("ms")
        try:
            ms = int(raw) if raw is not None else None
        except ValueError:
            return _error(400, "ms must be an integer")
        try:
            path = self.profiler.capture(ms=ms, trigger="manual", parts={"stacks": self.sampler.snapshot()})
        except ProfileBusyError:
            return _error(409, "a profile capture is already in flight")
        except Exception as exc:
            logger.exception("profile capture failed")
            return _error(500, f"capture failed: {exc}")
        return 200, {"bundle": path.rsplit("/", 1)[-1], "path": path,
                     "durationMs": self.profiler.clamp_ms(ms)}

    def handle_profile_stacks(self, request: Request) -> Response:
        if request.query.get("format") == "json":
            body = self.sampler.snapshot()
            body["hotspots"] = self.sampler.hotspots()
            return 200, body
        return 200, self.sampler.folded()

    @staticmethod
    def route_label(path: str) -> str:
        """The route pattern a request counts under (the JAX server's
        canonical resource), never the raw path: raw paths would blow up
        the label cardinality."""
        if path in _FIXED_ROUTES:
            return path
        if _EVENT_ID.match(path):
            return "/events/{event_id}.json"
        if _WEBHOOK_JSON.match(path):
            return "/webhooks/{name}.json"
        if _WEBHOOK_FORM.match(path):
            return "/webhooks/{name}"
        if (m := _PLUGIN.match(path)) and m.group(1):
            return "/plugins/{tail}"
        return "unmatched"

    # -------------------------------------------------------------- dispatch
    def handle(self, request: Request) -> Response:
        """Route one request under its trace id and count it; returns
        (status, body[, headers]), the trace id echoed in the headers. An
        open storage breaker met outside a route's own mapping (the
        access-key lookup, a single-event get or delete) answers 503 too."""
        trace_id = request.headers.get(TRACE_HEADER.lower()) or mint_trace_id()
        token = set_trace_id(trace_id)
        endpoint = self.route_label(request.path)
        status = 500  # an escaping exception is a 500 to the client
        t0 = time.perf_counter()
        try:
            with self.tracer.span("http.event", kind="ingress", endpoint=endpoint, method=request.method) as sp:
                try:
                    out = self._route(request)
                except CircuitOpenError as exc:
                    out = _storage_unavailable(exc)
                status = out[0]
                sp.tags["status"] = status
        finally:
            reset_trace_id(token)
            self._m_requests.inc(endpoint=endpoint, status=str(status))
            self._m_latency.observe(time.perf_counter() - t0, endpoint=endpoint)
        headers = dict(out[2]) if len(out) > 2 else {}
        headers[TRACE_HEADER] = trace_id
        return out[0], out[1], headers

    def _route(self, request: Request) -> Response:
        method, path = request.method, request.path
        if path == "/":
            return (200, {"status": "alive"}) if method == "GET" else (405, "405: Method Not Allowed")
        if path == "/healthz":
            return self.handle_healthz() if method == "GET" else (405, "405: Method Not Allowed")
        if path == "/plugins.json":
            if method != "GET":
                return 405, "405: Method Not Allowed"
            return 200, self.plugin_context.to_json_dict()
        if path in ("/metrics", "/slo", "/traces/recent", "/profile/stacks"):
            if method != "GET":
                return 405, "405: Method Not Allowed"
            if path == "/metrics":
                status, ctype, data = metrics_response(self.metrics, request.query, request.headers)
            elif path == "/slo":
                status, ctype, data = slo_response(self.slo)
            elif path == "/traces/recent":
                status, ctype, data = traces_response(self.tracer, request.query)
            else:
                return self.handle_profile_stacks(request)
            return status, _Raw(data, ctype)
        if path == "/profile/capture":
            return self.handle_profile_capture(request) if method == "POST" else (405, "405: Method Not Allowed")
        routes: list[tuple[set[str], Any]] = []
        if path == "/events.json":
            routes = [
                ({"POST"}, self.handle_post_event),
                ({"GET"}, self.handle_get_events),
            ]
        elif path == "/batch/events.json":
            routes = [({"POST"}, self.handle_batch_events)]
        elif path == "/stats.json":
            routes = [({"GET"}, self.handle_stats)]
        elif m := _EVENT_ID.match(path):
            eid = urllib.parse.unquote(m.group(1))
            routes = [
                ({"GET"}, lambda r, a: self.handle_get_event(r, a, eid)),
                ({"DELETE"}, lambda r, a: self.handle_delete_event(r, a, eid)),
            ]
        elif m := _WEBHOOK_JSON.match(path):
            name = urllib.parse.unquote(m.group(1))
            routes = [({"GET", "POST"}, lambda r, a: self.handle_webhook(r, a, name, False))]
        elif m := _WEBHOOK_FORM.match(path):
            name = urllib.parse.unquote(m.group(1))
            routes = [({"GET", "POST"}, lambda r, a: self.handle_webhook(r, a, name, True))]
        elif (m := _PLUGIN.match(path)) and m.group(1):
            tail = urllib.parse.unquote(m.group(1))
            routes = [({"GET"}, lambda r, a: self.handle_plugin_rest(r, a, tail))]
        if not routes:
            return 404, "404: Not Found"
        handler = next((h for methods, h in routes if method in methods), None)
        if handler is None:
            return 405, "405: Method Not Allowed"
        auth = self._authenticate(request)
        if not isinstance(auth, AuthData):
            return auth
        return handler(request, auth)

    # ------------------------------------------------------------------ HTTP
    def _handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # headers and body go out in two writes: with Nagle's algorithm on,
            # the body would wait for the client's delayed ACK (~40 ms)
            disable_nagle_algorithm = True

            def log_message(self, fmt, *args):  # one line per request is noise
                logger.debug("%s " + fmt, self.address_string(), *args)

            def _serve(self):
                try:
                    body = read_body(self.headers, self.rfile, MAX_BODY_BYTES)
                except BodyTooLarge:
                    self.close_connection = True  # the rest stays unread
                    self._reply(413, {"message": "payload too large"})
                    return
                except BodyError as exc:
                    reply_bad_framing(self, exc)
                    return
                url = urllib.parse.urlsplit(self.path)
                query: dict[str, str] = {}
                for k, v in urllib.parse.parse_qsl(url.query, keep_blank_values=True):
                    query.setdefault(k, v)
                request = Request(
                    method=self.command,
                    path=url.path,
                    query=query,
                    headers={k.lower(): v for k, v in self.headers.items()},
                    body=body,
                )
                try:
                    status, out, *headers = server.handle(request)
                except Exception as exc:
                    logger.exception("event server request failed")
                    status, out, headers = 500, {"message": str(exc)}, []
                self._reply(status, out, *headers)

            def _reply(self, status: int, out: Any, headers: dict[str, str] | None = None) -> None:
                if isinstance(out, _Raw):
                    data, ctype = out.data, out.content_type
                elif isinstance(out, str):
                    data, ctype = out.encode(), "text/plain; charset=utf-8"
                else:
                    data, ctype = json.dumps(out).encode(), "application/json; charset=utf-8"
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            do_GET = do_POST = do_DELETE = do_PUT = _serve

        return Handler

    def start(self) -> int:
        """Bind and serve on a background thread; returns the bound port."""
        httpd = _HTTPServer((self.config.ip, self.config.port), self._handler())
        httpd.ssl_context = self.config.ssl_context()
        self._httpd = httpd
        self._thread = threading.Thread(target=httpd.serve_forever, name="pio-events", daemon=True)
        self._thread.start()
        if self.config.sampler_period_s > 0:
            self.sampler.start()
        port = httpd.server_address[1]
        logger.info("Event server started on %s:%d", self.config.ip, port)
        return port

    def shutdown(self) -> None:
        self.sampler.stop()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=10)
            self._httpd = None


class _HTTPServer(HandshakeOnHandlerThread, ThreadingHTTPServer):
    daemon_threads = True
    request_queue_size = 256  # a burst of new connections must not overflow the backlog

    def process_request_thread(self, request, client_address) -> None:
        # the host sampler attributes stacks by thread name
        threading.current_thread().name = "pio-handler"
        super().process_request_thread(request, client_address)


def create_event_server(
    config: EventServerConfig | None = None, storage: Storage | None = None
) -> EventServer:
    return EventServer(storage=storage, config=config)


def run_event_server(config: EventServerConfig | None = None, storage: Storage | None = None) -> None:
    """Blocking entry point (ref EventServer.createEventServer): serve on
    ``storage`` (default ``Storage.instance()``) until SIGINT or SIGTERM.
    Call from the main thread."""
    from predictionio_tpu_torch.utils.platform import wait_for_signal

    server = EventServer(storage=storage or Storage.instance(), config=config or EventServerConfig())
    server.start()
    try:
        wait_for_signal()
    finally:
        server.shutdown()
