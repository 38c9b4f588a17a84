"""The query server: ``GET /``, ``GET /healthz``, ``GET /plugins.json``,
``POST /queries.json``, ``POST``/``GET /stop``, ``POST /reload`` and the
rollout routes over the standard library's ``ThreadingHTTPServer``, with a
micro-batcher.

Port of ``predictionio_tpu/workflow/create_server.py``: the serving core
(``_MicroBatcher``, the dispatch of a query batch), its rollout half
(stable and candidate lanes, sticky canary routing, shadow scoring, the
bake loop, registry sync, ``/reload`` and ``/models``), the ANN attach of
a lane loaded from the registry (with the ``pio_ann_*`` instruments) and
its serving contract: the access key, TLS, output blockers and sniffers,
the feedback loop, the remote log, per-request deadlines, load shedding,
the dispatch watchdog and breaker, ``/healthz`` and a graceful drain; and
its observability: ``GET /metrics`` (Prometheus text, or OpenMetrics with
trace-id exemplars), ``GET /slo``, ``GET /traces/recent``, ``POST
/profile/capture?ms=`` (409 while a capture runs) and ``GET
/profile/stacks``, trace ids, the phase waterfall, profile-on-alert, and
the version-keyed result cache; and the bandit lanes
(``bandit_policy``): a two-arm Thompson or epsilon-greedy policy that
steers the canary fraction from reward events and promotes or retires
the candidate.

Observability. ``X-Pio-Trace-Id`` is accepted or minted, echoed, and
carried on each queued item onto the dispatch and fetch threads, which
install it around each query's stages; one ``query.batch`` span per query
carries its waterfall. The nine phases of ``obs/waterfall.py`` are
observed where the JAX server observes them: ingress parse and the cache
lookup on the handler thread, queue wait when the collect thread takes
the batch, batch assembly and dispatch around the dispatch call, and
device compute (the fetch thread's wall time waiting for the lanes'
results), the fetch residual and serve when the batch's answers are
distributed; respond from then until the answer is ready to write, the
same end the ``pio_request_seconds`` histogram reads, so the phases tile
it (the answer is written after the ingress span is recorded). The
result cache answers a repeat query on a quiesced stable lane before
admission (also while the dispatch breaker is open), is bypassed while a
rollout is active, and is flushed for the affected version on every
stage, promote, rollback and stable swap.

Each handler thread submits its query to the batcher and waits. One
collect thread takes everything queued (up to ``max_batch``), drops what
expired in the queue, and hands the batch to a one-thread dispatch pool,
which decodes and supplements it and calls every algorithm's
``predict_batch_dispatch`` (launching the device work without waiting);
the returned finalize runs on a fetch pool, so batch n+1 dispatches while
batch n is fetched (a solo query on an idle server, with nothing to
overlap, dispatches and fetches in one hop). Both waits are bounded by the batch's tightest
deadline: a call that blows it fails its batch with 503s, counts a
watchdog trip against the dispatch breaker, and is walked away from (its
pool replaced; a thread stuck in a device call cannot be interrupted).
``/stop`` (what ``pio undeploy`` calls) answers ``{"message":
"Stopping."}`` and sets :attr:`QueryServer.stop_requested`; SIGTERM drains
(:meth:`QueryServer.drain`).

Rollout: the stable lane, the candidate lane, the routing plan and the
rollout generation change together under one lock, and the dispatch
thread reads all four at once (:meth:`QueryServer.lanes`) per
micro-batch: an in-flight batch finishes on the lanes it read, whatever a
concurrent promote, rollback or ``/reload`` swaps in. Where the reference
runs an asyncio task (the bake loop, registry sync), the port runs a
daemon thread, and the bandit's tick (a storage read of new reward
events) runs on the bake loop's own thread, holding no lock across the
read; shadow scoring, output sniffers and the background HTTP of
the feedback loop and the remote log run on bounded pools off the serving
path. A retired lane is dropped from every reference, so its device
tables are freed once its last in-flight batch is done, whatever
connections stay open; :meth:`QueryServer.shutdown` hangs up the
keep-alive connections, whose handler threads would otherwise hold the
server and its lanes until each client hangs up.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import logging
import os
import queue
import socket
import threading
import time
import traceback
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import torch

from predictionio_tpu_torch.ann import lifecycle as ann_lifecycle
from predictionio_tpu_torch.ann.metrics import AnnInstruments
from predictionio_tpu_torch.bandit import (
    ARM_CANDIDATE,
    ARM_STABLE,
    DECIDE_PROMOTE,
    DECIDE_RETIRE,
    BanditCriteria,
    BanditInstruments,
    BanditLoop,
    RewardTailer,
)
from predictionio_tpu_torch.controller.engine import Engine, EngineParams
from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.obs.profiler import ProfileBusyError, ProfileSession, ProfileStore
from predictionio_tpu_torch.obs.sampler import HostSampler
from predictionio_tpu_torch.obs.slo import (
    SLOEngine,
    counter_ratio_source,
    histogram_threshold_source,
    paired_counter_source,
)
from predictionio_tpu_torch.obs.torchprof import KernelBuildWatcher, kernel_launch_counts
from predictionio_tpu_torch.obs.tracing import (
    TRACE_HEADER,
    Tracer,
    current_trace_id,
    get_tracer,
    mint_trace_id,
    reset_trace_id,
    set_trace_id,
)
from predictionio_tpu_torch.obs.waterfall import (
    PHASE_BATCH_ASSEMBLY,
    PHASE_CACHE,
    PHASE_DEVICE_COMPUTE,
    PHASE_DISPATCH,
    PHASE_FETCH,
    PHASE_INGRESS_PARSE,
    PHASE_QUEUE_WAIT,
    PHASE_RESPOND,
    PHASE_SERVE,
    PhaseWaterfall,
    phase_tags_ms,
)
from predictionio_tpu_torch.obs.web import (
    BreakerInstruments,
    metrics_response,
    slo_response,
    traces_response,
)
from predictionio_tpu_torch.registry.controller import (
    VERDICT_PROMOTE,
    VERDICT_ROLLBACK,
    PromotionCriteria,
    RolloutController,
)
from predictionio_tpu_torch.registry.router import (
    LANE_CANDIDATE,
    LANE_SHADOW,
    LANE_STABLE,
    PLAN_OFF,
    Lane,
    RolloutInstruments,
    RolloutPlan,
    choose_lane,
    routing_key,
)
from predictionio_tpu_torch.registry.lease import register_lease_metrics
from predictionio_tpu_torch.registry.result_cache import ResultCache
from predictionio_tpu_torch.registry.store import MODE_CANARY, MODE_SHADOW, ArtifactStore
from predictionio_tpu_torch.resilience.breaker import OPEN, CircuitBreaker, CircuitOpenError
from predictionio_tpu_torch.resilience.deadline import Deadline, DeadlineExceeded
from predictionio_tpu_torch.utils.httpbody import (
    BodyError,
    BodyTooLarge,
    framing,
    read_body,
    reply_bad_framing,
)
from predictionio_tpu_torch.utils.tls import HandshakeOnHandlerThread, server_ssl_context
from predictionio_tpu_torch.workflow import model_io
from predictionio_tpu_torch.workflow.context import WorkflowContext
from predictionio_tpu_torch.workflow.core_workflow import load_models_for_instance
from predictionio_tpu_torch.workflow.engine_loader import EngineManifest, load_engine
from predictionio_tpu_torch.workflow.server_plugins import EngineServerPluginContext

logger = logging.getLogger(__name__)


MAX_INFLIGHT = 4  # batches dispatched but not yet fetched
BACKGROUND_HTTP_THREADS = 4  # feedback and remote-log POSTs in flight at once
# of a drain's grace, what stays for shutdown and the interpreter's exit (about
# 0.6 s of a CPU process with torch loaded) after the background POSTs
EXIT_RESERVE_S = 1.5
VERSION_HEADER = "X-Pio-Model-Version"  # the lane version that answered


class LoadShedError(RuntimeError):
    """Admission control rejected the query (queue at high water): the
    client is told to back off (``Retry-After``)."""

    transient = False

    def __init__(self, message: str, retry_after_s: float):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class ShuttingDownError(RuntimeError):
    """The server is stopping; new and queued queries answer 503."""

    transient = False

    def __init__(self):
        super().__init__("query server is shutting down")


@dataclasses.dataclass
class ServerConfig:
    ip: str = "0.0.0.0"
    port: int = 8000
    max_batch: int = 64
    accesskey: str | None = None  # required on /queries.json when set
    # feedback loop: a `predict` event per answered query, POSTed to the
    # event server's /events.json with feedback_access_key
    feedback: bool = False
    event_server_url: str | None = None  # e.g. http://localhost:7070
    feedback_access_key: str | None = None
    # TLS (ref common/SSLConfiguration.scala): PEM cert + key paths
    ssl_certfile: str | None = None
    ssl_keyfile: str | None = None
    # remote log of serving errors: POST log_prefix + JSON{engineInstance,
    # message} to log_url (ref CreateServer.scala:423-434)
    log_url: str | None = None
    log_prefix: str = ""
    # a /queries.json answer is due within this many seconds, else 503;
    # <= 0 disables (a wedged device call then blocks its clients forever)
    request_timeout_s: float = 10.0
    # admission control: with this many queries queued, new ones answer
    # 503 + Retry-After instead of growing the queue; 0 = unbounded
    queue_high_water: int = 256
    shed_retry_after_s: float = 1.0  # Retry-After on load-shed and deadline 503s
    max_payload_bytes: int = 1 << 20  # larger bodies answer 413 unread
    # timeout of each feedback or remote-log POST
    http_timeout_s: float = 10.0
    # dispatch breaker: this many consecutive watchdog trips open it, and
    # /queries.json answers 503 at once for breaker_recovery_s
    breaker_threshold: int = 3
    breaker_recovery_s: float = 5.0
    # -- model registry / progressive rollout ----------------------------
    # artifact registry base dir; None: the metadata store's latest
    # COMPLETED instance is the only source of what serves
    registry_dir: str | None = None
    # the payload field whose value routes a user to one lane for a whole
    # bake; a payload without it routes by a hash of the whole payload
    sticky_key_field: str = "user"
    # consecutive candidate failures that trip the candidate breaker and
    # roll the candidate back at once
    candidate_breaker_threshold: int = 3
    # promotion gates (registry/controller.py PromotionCriteria)
    bake_window_s: float = 60.0
    bake_min_requests: int = 20
    max_error_ratio: float = 2.0
    max_p95_ratio: float = 1.5
    max_divergence_rate: float = 0.25
    auto_promote: bool = True
    bake_check_interval_s: float = 1.0
    # shadow batches queued at most; past it samples are dropped (counted)
    shadow_max_backlog: int = 8
    # poll the registry's state generation on this cadence and adopt the
    # stage/promote/rollback/stable moves other processes made; 0 disables
    registry_sync_interval_s: float = 0.0
    # graceful drain (SIGTERM): how long queued and in-flight queries have
    # to answer after the listener closes
    drain_grace_s: float = 15.0
    # -- SLOs: burn rates on /slo and the pio_slo_* gauges ----------------
    # latency objective: this fraction of /queries.json answers lands at
    # or under the threshold (keep it on a histogram bucket bound)
    slo_latency_threshold_s: float = 0.010
    slo_latency_objective: float = 0.50
    # availability objective: non-5xx fraction of /queries.json answers
    slo_availability_objective: float = 0.999
    # shed objective: fraction of arrivals NOT rejected by admission control
    slo_shed_objective: float = 0.99
    # -- the version-keyed result cache (registry/result_cache.py) ----------
    # entries (0 disables) and the staleness bound for serving components
    # that read live state outside the model artifact
    result_cache_size: int = 1024
    result_cache_ttl_s: float = 10.0
    # -- profiling -------------------------------------------------------------
    # bundle store of POST /profile/capture (created on the first capture)
    profile_dir: str = "pio_obs/profiles"
    profile_max_bundles: int = 20
    # capture duration rails: ?ms= defaults and clamps here
    profile_default_ms: int = 500
    profile_max_ms: int = 10_000
    # the always-on host stack sampler; <= 0 disables sampling
    sampler_period_s: float = 0.05
    # profile-on-alert: SLO-alert transitions and candidate-breaker trips
    # capture a rate-limited host-stack bundle; profile_alert_trace_ms > 0
    # adds a device trace of that length
    profile_on_alert: bool = True
    profile_alert_min_interval_s: float = 60.0
    profile_alert_trace_ms: int = 0
    # -- bandit exploration lanes ----------------------------------------------
    # policy steering the candidate traffic fraction while a rollout is
    # live: "epsilon" | "thompson"; None keeps the plain bake gate. With a
    # policy set, the bandit owns the promote/retire decision (the bake
    # gate keeps its error/latency/divergence veto) and the plan fraction
    # follows the reward posterior every bake tick.
    bandit_policy: str | None = None
    bandit_epsilon: float = 0.1  # explore share (and cold-start fraction)
    bandit_min_pulls: int = 20  # per-arm evidence floor before deciding
    bandit_promote_threshold: float = 0.95  # P(candidate better) to promote
    bandit_retire_threshold: float = 0.05  # ... to retire the candidate
    bandit_min_fraction: float = 0.05
    bandit_max_fraction: float = 0.9
    # reward source: feedback events tailed from the event store and
    # matched to impressions by the trace id echoed into properties
    bandit_app_name: str | None = None  # app whose events carry rewards
    bandit_channel_name: str | None = None
    bandit_reward_events: tuple[str, ...] = ("reward",)
    bandit_trace_property: str = "traceId"
    bandit_reward_property: str = "reward"
    bandit_impression_capacity: int = 65536
    bandit_seed: int = 0

    def ssl_context(self):
        return server_ssl_context(self.ssl_certfile, self.ssl_keyfile)


@dataclasses.dataclass
class _QItem:
    """One queued query: its payload, future and deadline, the ingress
    trace id (a contextvar does not follow the item onto the dispatch
    thread), the enqueue time, the ``phases`` channel the handler shares
    with the batcher (``t_collect``, ``t_done``) and, when its answer is
    cacheable, its canonical query bytes."""

    payload: Any
    fut: concurrent.futures.Future
    deadline: Deadline
    trace_id: str | None = None
    t_submit: float = 0.0
    phases: dict[str, float] = dataclasses.field(default_factory=dict)
    cache_key: bytes | None = None


def _settle(fut: concurrent.futures.Future, result: Any = None, exc: BaseException | None = None) -> None:
    """Give a query its outcome unless it has one: a batch the watchdog
    failed can still come back from the thread it walked away from."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except concurrent.futures.InvalidStateError:
        pass


class _MicroBatcher:
    """Coalesces concurrent queries into batched dispatches, with
    admission control, queue deadlines and the dispatch/fetch watchdogs
    (see the module docstring)."""

    def __init__(
        self,
        server: "QueryServer",
        max_batch: int,
        max_inflight: int,
        high_water: int = 0,
        shed_retry_after_s: float = 1.0,
    ):
        self._server = server
        self.max_batch = max(1, max_batch)
        self.high_water = max(0, high_water)
        self.shed_retry_after_s = shed_retry_after_s
        self._queue: queue.Queue = queue.Queue()
        self._admit_lock = threading.Lock()
        self._inflight = threading.Semaphore(max(1, max_inflight))
        self._max_fetch_workers = max(1, max_inflight)
        self._pool_lock = threading.Lock()
        self._dispatch_pool = self._pool(1, "pio-dispatch")
        self._fetch_pool = self._pool(self._max_fetch_workers, "pio-fetch")
        # one waiter per batch in flight: it runs the fetch watchdog
        self._finish_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=self._max_fetch_workers, thread_name_prefix="pio-finish"
        )
        self._count_lock = threading.Lock()
        self._closed = False
        self.batches_dispatched = 0
        self.queries_dispatched = 0
        self.largest_batch = 0
        self.batches_in_flight = 0  # dispatched, not yet answered
        self.watchdog_trips = 0  # batches failed for blowing their deadline
        self.shed_count = 0  # queries rejected by admission control
        self._thread = threading.Thread(target=self._run, name="pio-collect", daemon=True)
        self._thread.start()

    def _pool(self, workers: int, prefix: str) -> concurrent.futures.ThreadPoolExecutor:
        # a CUDA current device is per thread: every (replacement) worker
        # takes the server's device before it launches anything
        return concurrent.futures.ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix=prefix, initializer=self._server.bind_device
        )

    @property
    def queue_depth(self) -> int:
        return self._queue.qsize()

    def submit(
        self,
        payload: Any,
        deadline: Deadline | None = None,
        phases: dict[str, float] | None = None,
        t_submit: float | None = None,
        cache_key: bytes | None = None,
    ) -> concurrent.futures.Future:
        """Enqueue one query; the future resolves to ``(encoded body,
        version)`` or the query's error. Raises ``ShuttingDownError`` once
        closed and ``LoadShedError`` at high water. ``phases`` receives the
        waterfall timestamps; ``t_submit`` anchors the queue wait at the
        caller's last phase boundary."""
        if self._closed:
            raise ShuttingDownError()
        item = _QItem(
            payload,
            concurrent.futures.Future(),
            deadline or Deadline.never(),
            current_trace_id(),
            t_submit if t_submit is not None else time.perf_counter(),
            phases if phases is not None else {},
            cache_key,
        )
        with self._admit_lock:
            depth = self._queue.qsize()
            if self.high_water and depth >= self.high_water:
                self.shed_count += 1
                self._server._m_shed.inc()
                raise LoadShedError(
                    f"admission queue over high water ({depth}/{self.high_water})",
                    self.shed_retry_after_s,
                )
            self._queue.put(item)
        return item.fut

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            batch = [item]
            stop = False
            while len(batch) < self.max_batch:
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    stop = True
                    break
                batch.append(nxt)
            self._inflight.acquire()  # bound the batches in flight
            self._dispatch(batch)
            if stop:
                return

    def _dispatch(self, batch: list[_QItem]) -> None:
        """Dispatch one collected batch under the dispatch watchdog and
        hand it to a finish waiter; holds one in-flight slot on entry."""
        server = self._server
        collect_t = time.perf_counter()
        live = []
        for item in batch:
            if item.fut.done():  # its probe slot, if it held one, can never be recorded
                server.dispatch_breaker.release_probe()
            elif item.deadline.expired:
                # expired while queued: no device work for an answer nobody awaits
                _settle(item.fut, exc=DeadlineExceeded("query expired in admission queue"))
            else:
                live.append(item)
                queue_wait_s = collect_t - item.t_submit
                item.phases["t_collect"] = collect_t
                server._m_queue_wait.observe(queue_wait_s)
                server.waterfall.observe(PHASE_QUEUE_WAIT, queue_wait_s, item.trace_id)
        if not live:
            self._inflight.release()
            return
        deadline = Deadline.min_of([it.deadline for it in live])
        with self._count_lock:
            # idle fast path: a batch of one with nothing queued behind it
            # and nothing in flight has nothing to overlap its fetch with,
            # so dispatch and fetch run in one hop under the dispatch watchdog
            combined = len(live) == 1 and self._queue.empty() and self.batches_in_flight == 0
            self.batches_in_flight += 1
        fn = self._dispatch_combined if combined else server.dispatch_batch
        payloads, trace_ids = [it.payload for it in live], [it.trace_id for it in live]
        dispatch_t0 = time.perf_counter()
        call = self._dispatch_pool.submit(fn, payloads, trace_ids)
        done, _ = concurrent.futures.wait([call], timeout=deadline.remaining())
        if not done:
            self._walk_away(live, "dispatch")
            return
        dispatch_s = time.perf_counter() - dispatch_t0
        try:
            # the outcomes in the combined hop, else the finalize that fetches them
            result = call.result()
        except Exception as exc:  # the whole batch failed to dispatch
            logger.exception("micro-batch dispatch failed")
            server.dispatch_breaker.record_failure()
            self._end_batch(live, [(exc, "")] * len(live))
            return
        timings = result[1] if combined else result.timings
        if combined:
            # the combined hop swallowed device compute and serve: carve them
            # out so the finish's observations keep the waterfall tiling
            dispatch_s = max(0.0, dispatch_s - timings["device_s"] - timings["serve_s"])
        server._m_dispatch.observe(dispatch_s)
        # batch-scoped phases: every rider waits out the whole batch
        riders = [item.trace_id for item in live]
        server.waterfall.observe_batch(PHASE_BATCH_ASSEMBLY, max(0.0, dispatch_t0 - collect_t), riders)
        server.waterfall.observe_batch(PHASE_DISPATCH, dispatch_s, riders)
        self.batches_dispatched += 1
        self.queries_dispatched += len(live)
        self.largest_batch = max(self.largest_batch, len(live))
        dispatch_end = dispatch_t0 + dispatch_s
        if combined:
            server._m_fetch.observe(0.0)
            if timings["device_s"] > 0.0:
                server._m_stall.inc(timings["device_s"], where="micro-batch-fetch")
            server.dispatch_breaker.record_success()
            self._end_batch(live, result[0], timings, dispatch_s, dispatch_end, 0.0)
        else:
            self._finish_pool.submit(self._finish, live, result, deadline, dispatch_s, dispatch_end)

    def _dispatch_combined(self, payloads: list[Any], trace_ids: list[str | None]):
        fin = self._server.dispatch_batch(payloads, trace_ids)
        return fin(), fin.timings

    def _finish(self, batch: list[_QItem], finalize, deadline: Deadline, dispatch_s: float,
                dispatch_end: float) -> None:
        server = self._server
        timings = finalize.timings
        fetch_t0 = time.perf_counter()
        with self._pool_lock:
            fetch = self._fetch_pool.submit(finalize)
        del finalize  # the lanes it holds go with the fetch
        done, _ = concurrent.futures.wait([fetch], timeout=deadline.remaining())
        if not done:
            self._walk_away(batch, "fetch")
            return
        fetch_s = time.perf_counter() - fetch_t0
        server._m_fetch.observe(fetch_s)
        # the fetch is where the host blocks on the card: stall time
        server._m_stall.inc(fetch_s, where="micro-batch-fetch")
        try:
            outs = fetch.result()
        except Exception as exc:
            # a finalize that raised as a whole counts like a failed dispatch
            logger.exception("micro-batch finalize failed")
            server.dispatch_breaker.record_failure()
            outs = [(exc, "")] * len(batch)
        else:
            server.dispatch_breaker.record_success()
        self._end_batch(batch, outs, timings, dispatch_s, dispatch_end, fetch_s)

    def _walk_away(self, batch: list[_QItem], stage: str) -> None:
        """Watchdog trip: fail the batch, replace the pool whose thread is
        stuck (the call cannot be interrupted; it runs on, unread), and
        count a failure against the dispatch breaker."""
        with self._count_lock:
            self.watchdog_trips += 1
        self._server._m_watchdog.inc()
        fresh = self._pool(1 if stage == "dispatch" else self._max_fetch_workers, f"pio-{stage}")
        with self._pool_lock:
            if stage == "dispatch":
                old, self._dispatch_pool = self._dispatch_pool, fresh
            else:
                old, self._fetch_pool = self._fetch_pool, fresh
        old.shutdown(wait=False)
        self._server.dispatch_breaker.record_failure()
        exc = DeadlineExceeded(f"micro-batch {stage}: deadline exceeded")
        self._end_batch(batch, [(exc, "")] * len(batch))

    def _end_batch(
        self,
        batch: list[_QItem],
        outs: list[tuple[Any, str]],
        timings: dict[str, float] | None = None,
        dispatch_s: float = 0.0,
        dispatch_end: float = 0.0,
        fetch_s: float = 0.0,
    ) -> None:
        """Release the batch's in-flight slot (once per batch) and answer
        its queries. A batch that ran (``timings`` given) also observes
        its device compute, fetch residual and serve phases, stores its
        cacheable answers and records one ``query.batch`` span a query."""
        with self._count_lock:
            self.batches_in_flight -= 1
        self._inflight.release()
        server = self._server
        done_t = time.perf_counter()
        if timings is not None:
            device_s = max(0.0, timings["device_s"])
            serve_s = max(0.0, timings["serve_s"])
            fetch_resid_s = max(0.0, done_t - dispatch_end - device_s - serve_s)
            riders = [item.trace_id for item in batch]
            server.waterfall.observe_batch(PHASE_DEVICE_COMPUTE, device_s, riders)
            server.waterfall.observe_batch(PHASE_FETCH, fetch_resid_s, riders)
            server.waterfall.observe_batch(PHASE_SERVE, serve_s, riders)
        for item, (out, version) in zip(batch, outs):
            if timings is not None:
                if item.cache_key is not None and not isinstance(out, BaseException):
                    server._cache_store(version, item.cache_key, out)
                item.phases["t_done"] = done_t
                queue_s = max(0.0, item.phases.get("t_collect", item.t_submit) - item.t_submit)
                server.tracer.record_span(
                    "query.batch",
                    kind="batch",
                    duration_s=done_t - item.t_submit,
                    trace_id=item.trace_id,
                    status=type(out).__name__ if isinstance(out, BaseException) else "ok",
                    batch_size=len(batch),
                    version=version,
                    queue_ms=round(queue_s * 1000, 3),
                    dispatch_ms=round(dispatch_s * 1000, 3),
                    fetch_ms=round(fetch_s * 1000, 3),
                    **phase_tags_ms(device_compute=device_s, serve=serve_s, fetch_residual=fetch_resid_s),
                )
            if isinstance(out, BaseException):
                _settle(item.fut, exc=out)
            else:
                _settle(item.fut, (out, version))

    def close(self) -> None:
        """Stop admitting, let the batches in flight answer, and fail what
        is still queued with ``ShuttingDownError``."""
        self._closed = True
        self._queue.put(None)
        self._thread.join(timeout=10)
        while True:  # anything queued behind the stop marker
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                _settle(item.fut, exc=ShuttingDownError())
        self._finish_pool.shutdown(wait=True)
        with self._pool_lock:
            pools = (self._dispatch_pool, self._fetch_pool)
        for pool in pools:
            pool.shutdown(wait=True)


class _PostQueue:
    """Fire-and-forget background work (feedback and remote-log POSTs) on
    daemon threads. Unlike an executor's, its threads never hold the
    process's exit: :meth:`close` waits for what is queued and in flight
    only until a deadline, then abandons the rest."""

    def __init__(self, n_threads: int, name: str):
        self._queue: queue.Queue = queue.Queue()
        self._cv = threading.Condition()
        self._pending = 0  # queued plus running
        self._threads = [
            threading.Thread(target=self._run, name=f"{name}_{i}", daemon=True)
            for i in range(n_threads)
        ]
        for t in self._threads:
            t.start()

    def submit(self, fn, *args) -> None:
        with self._cv:
            self._pending += 1
        self._queue.put((fn, args))

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            fn, args = item
            try:
                fn(*args)
            except Exception:
                logger.exception("background %s failed", getattr(fn, "__name__", fn))
            finally:
                with self._cv:
                    self._pending -= 1
                    self._cv.notify_all()

    def close(self, deadline: float) -> int:
        """Wait until everything submitted has run or ``deadline``
        (``time.monotonic()``) has passed, then stop the threads; returns
        how many items were abandoned (dropped from the queue or still
        running)."""
        with self._cv:
            while self._pending and deadline - time.monotonic() > 0:
                self._cv.wait(deadline - time.monotonic())
            left = self._pending
        while True:  # what never started is dropped
            try:
                if self._queue.get_nowait() is not None:
                    with self._cv:
                        self._pending -= 1
            except queue.Empty:
                break
        for _ in self._threads:
            self._queue.put(None)
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        return left


class _HTTPServer(HandshakeOnHandlerThread, ThreadingHTTPServer):
    """Counts the connections accepted whose first request has not yet
    been answered, so a drain does not close the process on a connection
    it accepted (see :meth:`QueryServer.drain`)."""

    daemon_threads = True
    # a burst of new connections must not overflow the backlog: a client
    # past it would see a reset, not a 503
    request_queue_size = 1024

    def __init__(self, address, handler, owner: "QueryServer"):
        self.owner = owner
        super().__init__(address, handler)

    def process_request(self, request, client_address) -> None:
        self.owner._connection_accepted(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request) -> None:
        self.owner._connection_closed(request)
        super().shutdown_request(request)

    def process_request_thread(self, request, client_address) -> None:
        # the host sampler attributes stacks by thread name
        threading.current_thread().name = "pio-handler"
        super().process_request_thread(request, client_address)

    def finish_request(self, request, client_address) -> None:
        self.owner._first_request.pending = True
        try:
            super().finish_request(request, client_address)
        finally:
            self.owner._first_request_done()


def _canonical_json(body: Any) -> str:
    return json.dumps(body, sort_keys=True, default=str)


# the result-cache key: canonical bytes of the raw payload, so
# {"user": "u1", "num": 10} and {"num": 10, "user": "u1"} share one entry
# (the JAX server's encoder: sorted keys, compact separators)
_CANONICAL = json.JSONEncoder(sort_keys=True, separators=(",", ":"), default=str)


def _canonical_query_bytes(payload: Any) -> bytes:
    return _CANONICAL.encode(payload).encode()


def _engine_params_of_instance(engine: Engine, instance: Any) -> EngineParams:
    variant = {
        "datasource": {"params": json.loads(instance.data_source_params or "{}")},
        "preparator": {"params": json.loads(instance.preparator_params or "{}")},
        "algorithms": json.loads(instance.algorithms_params or "[]"),
        "serving": {"params": json.loads(instance.serving_params or "{}")},
    }
    return engine.engine_params_from_variant(variant)


class QueryServer:
    def __init__(
        self,
        engine: Engine,
        engine_params: EngineParams,
        models: list[Any],
        ctx: WorkflowContext,
        config: ServerConfig | None = None,
        instance_id: str = "",
        manifest: EngineManifest | None = None,
        registry_store: ArtifactStore | None = None,
        model_version: str | None = None,
        plugin_context: EngineServerPluginContext | None = None,
    ):
        self.engine = engine
        self.engine_params = engine_params
        self.config = config or ServerConfig()
        self.ctx = ctx
        self.instance_id = instance_id
        self.manifest = manifest or EngineManifest(
            engine_id="", version="", variant="", engine_factory=""
        )
        self.plugin_context = plugin_context or EngineServerPluginContext()
        # the card a replacement worker thread must take (current device is per thread)
        self._device_index = (
            torch.cuda.current_device()
            if self.ctx.device.type == "cuda" and self.ctx.device.index is None else self.ctx.device.index
        )
        self.registry_store = registry_store or (
            ArtifactStore(self.config.registry_dir) if self.config.registry_dir else None
        )
        self.metrics = MetricsRegistry()
        self.tracer: Tracer = get_tracer()
        # the pio_ann_* family exists from start; lanes loaded from the
        # registry bind their attached index to it in _warmup_components,
        # and the collector retires a reloaded lane's version gauges
        self.ann_instruments = AnnInstruments(self.metrics)
        self.metrics.register_collector(self._collect_ann_indexes)
        m = self.metrics
        self._m_requests = m.counter(
            "pio_requests_total", "HTTP requests served, by route and status", labelnames=("endpoint", "status")
        )
        self._m_latency = m.histogram(
            "pio_request_seconds", "HTTP request wall time, by route", labelnames=("endpoint",)
        )
        self._m_queue_wait = m.histogram(
            "pio_queue_wait_seconds", "time queries spend in the micro-batch admission queue"
        )
        self._m_dispatch = m.histogram(
            "pio_dispatch_seconds", "micro-batch dispatch phase (decode + device enqueue) wall time"
        )
        self._m_fetch = m.histogram(
            "pio_fetch_seconds", "micro-batch fetch phase (device->host transport + serve) wall time"
        )
        self._m_stall = m.counter(
            "pio_device_stall_seconds_total",
            "cumulative seconds spent blocked on device->host synchronization",
            labelnames=("where",),
        )
        # per-request latency attribution (obs/waterfall.py)
        self.waterfall = PhaseWaterfall(m)
        # the version-keyed result cache: the pio_cache_* counters mirror
        # its monotonic stats at scrape time
        self._result_cache: ResultCache | None = (
            ResultCache(self.config.result_cache_size, self.config.result_cache_ttl_s)
            if self.config.result_cache_size > 0 else None
        )
        self._m_cache_hits = m.counter(
            "pio_cache_hits_total",
            "queries answered from the version-keyed result cache (never entered the micro-batch queue)",
        )
        self._m_cache_misses = m.counter(
            "pio_cache_misses_total", "cacheable queries that missed and went through dispatch"
        )
        self._m_cache_evictions = m.counter(
            "pio_cache_evictions_total", "result-cache entries dropped by LRU pressure or TTL expiry"
        )
        self._m_cache_invalidations = m.counter(
            "pio_cache_invalidations_total",
            "result-cache entries flushed by model swap/promote/rollback/stage/reload",
        )
        if self._result_cache is not None:
            m.register_collector(self._collect_cache)
        # the kernel builds of this process (the counterpart of the JAX
        # server's jit cache watcher)
        self.build_watcher = KernelBuildWatcher(m)
        m.register_collector(self.build_watcher.sample)
        register_lease_metrics(m)
        self._m_shed = m.counter(
            "pio_load_shed_total", "requests rejected by admission control (503 + Retry-After)"
        )
        self._m_deadline = m.counter(
            "pio_deadline_exceeded_total", "requests failed for blowing their deadline (queued or in flight)"
        )
        self._m_watchdog = m.counter(
            "pio_watchdog_trips_total", "batches abandoned because a device call blew its deadline"
        )
        self._m_breaker_rejected = m.counter(
            "pio_breaker_rejections_total", "requests shed at the door because the dispatch circuit was open"
        )
        queue_depth = m.gauge("pio_queue_depth", "queries waiting in the micro-batch queue")
        m.gauge("pio_queue_high_water", "admission-control shed threshold (0 = unbounded)").set(
            self.config.queue_high_water
        )
        m.register_collector(lambda: queue_depth.set(self.batcher.queue_depth))
        self._breaker_instruments = BreakerInstruments(m)
        m.register_collector(self._breaker_instruments.collect)
        # consecutive watchdog trips open it; while open /queries.json
        # answers 503 + Retry-After instead of feeding a wedged device
        self.dispatch_breaker = self._breaker_instruments.watch(CircuitBreaker(
            name="dispatch",
            failure_threshold=self.config.breaker_threshold,
            recovery_timeout_s=self.config.breaker_recovery_s,
        ))
        # declarative SLOs as multi-window burn rates over the instruments
        # above (obs/slo.py): /slo and the pio_slo_* gauges
        self.slo = SLOEngine(m)
        queries = "/queries.json"
        self.slo.add(
            "latency",
            f"{queries} answered within {self.config.slo_latency_threshold_s * 1000:g} ms",
            self.config.slo_latency_objective,
            histogram_threshold_source(self._m_latency, self.config.slo_latency_threshold_s, endpoint=queries),
        )
        self.slo.add(
            "availability",
            f"{queries} answered without a 5xx",
            self.config.slo_availability_objective,
            counter_ratio_source(
                self._m_requests,
                bad=lambda lab: lab.get("status", "").startswith("5"),
                match=lambda lab: lab.get("endpoint") == queries,
            ),
        )
        self.slo.add(
            "shed",
            f"{queries} arrivals not rejected by admission control",
            self.config.slo_shed_objective,
            paired_counter_source(
                counter_ratio_source(
                    self._m_requests, bad=lambda lab: False, match=lambda lab: lab.get("endpoint") == queries
                ),
                self._m_shed,
            ),
        )
        m.register_collector(self.slo.collect)
        # the always-on host sampler and the single-flight device capture;
        # their pio_profile_* instruments exist from start
        self.sampler = HostSampler(
            period_s=self.config.sampler_period_s if self.config.sampler_period_s > 0 else 0.05, metrics=m
        )
        self.profiler = ProfileSession(
            ProfileStore(self.config.profile_dir, self.config.profile_max_bundles),
            device=str(self.ctx.device),
            default_ms=self.config.profile_default_ms,
            max_ms=self.config.profile_max_ms,
            alert_min_interval_s=self.config.profile_alert_min_interval_s,
            alert_trace_ms=self.config.profile_alert_trace_ms,
            context_fn=self._profile_context,
            counters_fn=kernel_launch_counts if self.ctx.device.type == "cuda" else None,
            metrics=m,
        )
        # SLO alert transitions for profile-on-alert (a long burn captures
        # once per transition, not once per tick)
        self._slo_alerting: dict[str, bool] = {}
        self._candidate: Lane | None = None
        _, _, algorithms, serving = engine.make_components(engine_params)
        self._warmup_components(algorithms, models)
        # the lanes: (algorithms, serving, models, version) per lane, the
        # plan and the generation change together under _rollout_mutex
        self._active = Lane(
            algorithms, serving, models, model_version or instance_id, instance_id, engine_params
        )
        self._plan: RolloutPlan = PLAN_OFF
        # bumped on every stage/promote/rollback/stable swap: work queued
        # for an earlier rollout must not feed the current one's breaker
        self._rollout_gen = 0
        self._rollout_mutex = threading.Lock()
        # serializes the heavy transitions (lane loads, /reload, staging,
        # promote, registry sync) against one another
        self._reload_lock = threading.Lock()
        self._seen_state_gen: int | None = None
        self._rollout_instruments = RolloutInstruments(self.metrics)
        self.rollout_controller = RolloutController(
            self._rollout_instruments,
            PromotionCriteria(
                bake_window_s=self.config.bake_window_s,
                min_requests=self.config.bake_min_requests,
                max_error_ratio=self.config.max_error_ratio,
                max_p95_ratio=self.config.max_p95_ratio,
                max_divergence_rate=self.config.max_divergence_rate,
                auto_promote=self.config.auto_promote,
            ),
        )
        self.candidate_breaker = self._new_candidate_breaker()
        # the pio_bandit_* family registers eagerly (it exists at zero with
        # no policy); the loop exists only when a policy is configured. Its
        # arms are the lanes, its actuator the canary fraction, and promote
        # and retire go through the rollout transitions below
        self.bandit_instruments = BanditInstruments(m)
        self.bandit: BanditLoop | None = (
            BanditLoop(
                self.config.bandit_policy,
                epsilon=self.config.bandit_epsilon,
                criteria=BanditCriteria(
                    min_pulls=float(self.config.bandit_min_pulls),
                    promote_threshold=self.config.bandit_promote_threshold,
                    retire_threshold=self.config.bandit_retire_threshold,
                    min_fraction=self.config.bandit_min_fraction,
                    max_fraction=self.config.bandit_max_fraction,
                ),
                instruments=self.bandit_instruments,
                store=self.registry_store,
                engine_id=self.manifest.engine_id,
                impression_capacity=self.config.bandit_impression_capacity,
                seed=self.config.bandit_seed,
            )
            if self.config.bandit_policy
            else None
        )
        self._shadow_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="pio-shadow", initializer=self.bind_device
        )
        self._shadow_lock = threading.Lock()
        self._shadow_pending = 0
        # sniffers observe off the serving path; feedback and remote-log
        # POSTs are fire-and-forget, each bounded by http_timeout_s
        self._sniffer_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="pio-sniffer", initializer=self.bind_device
        )
        self._http_pool = _PostQueue(BACKGROUND_HTTP_THREADS, "pio-bg-http")
        self._http = urllib.request.build_opener(urllib.request.ProxyHandler({}))
        self._background_lock = threading.Lock()
        self._background_closed = False
        # drain accounting: /queries.json requests in flight, and accepted
        # connections whose first request is not answered yet
        self._drain_lock = threading.Lock()
        self._inflight_requests = 0
        self._unanswered_connections = 0
        self._first_request = threading.local()
        # every open connection, so shutdown can hang up idle keep-alives
        self._open_connections: set = set()
        self._draining = False
        self._exit_by: float | None = None  # a drain's deadline (time.monotonic())
        self.batcher = _MicroBatcher(
            self, self.config.max_batch, MAX_INFLIGHT,
            high_water=self.config.queue_high_water, shed_retry_after_s=self.config.shed_retry_after_s,
        )
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._loops: list[threading.Thread] = []
        self._closing = threading.Event()
        self.stop_requested = threading.Event()

    # -- lanes -------------------------------------------------------------------
    def lanes(self) -> tuple[Lane, Lane | None, RolloutPlan, int]:
        """(stable, candidate, plan, generation), read together."""
        with self._rollout_mutex:
            return self._active, self._candidate, self._plan, self._rollout_gen

    @property
    def model_version(self) -> str:
        return self._active.version

    @property
    def algorithms(self) -> list[Any]:
        return self._active.algorithms

    @property
    def serving(self) -> Any:
        return self._active.serving

    @property
    def models(self) -> list[Any]:
        return self._active.models

    def bind_device(self) -> None:
        """Make this server's card the calling thread's current device."""
        if self._device_index is not None:
            torch.cuda.set_device(self._device_index)

    def _collect_ann_indexes(self) -> None:
        stable, candidate, _, _ = self.lanes()
        self.ann_instruments.sync_indexes(ann_lifecycle.pinned_indexes(
            [stable.models] + ([candidate.models] if candidate is not None else [])
        ))

    def _warmup_components(self, algorithms: list[Any], models: list[Any]) -> None:
        # the lane loader attached any index before this server's
        # instruments were in scope; each engine's warmup launches the
        # search it dispatches
        ann_lifecycle.bind_instruments(models, self.ann_instruments)
        for algo, model in zip(algorithms, models):
            algo.warmup_serving(model, self.config.max_batch)

    # -- the serving pipeline ------------------------------------------------
    def dispatch_batch(self, payloads: list[Any], trace_ids: list[str | None] | None = None):
        """Decode each payload, route it to a lane (sticky canary),
        supplement it on that lane, launch every lane's device work, and
        return the finalize that fetches, serves and encodes one
        ``(result or exception, version)`` per payload. A candidate-lane
        failure never reaches the client: it feeds the candidate breaker
        and the query is answered again on the stable lane. Any other
        per-query failure is that query's result alone.

        Each query's trace id (``trace_ids``) is installed around its
        decode and supplement here and its serve in finalize, so spans
        those stages record join the request's trace. Finalize publishes
        its sub-phases on ``finalize.timings``: ``device_s``, the wall
        time waiting for the lanes' results, and ``serve_s``."""
        stable, cand, plan, gen = self.lanes()
        canary = cand is not None and plan.mode == MODE_CANARY and plan.fraction > 0
        shadow = cand is not None and plan.mode == MODE_SHADOW
        # bandit accounting is snapshotted with the lanes: the answered
        # queries of this batch are pulls of this rollout's arms (the
        # version check in record_impression drops a race with a promote)
        bandit = self.bandit if canary and self.bandit is not None and self.bandit.active else None
        inst = self._rollout_instruments
        n = len(payloads)
        outs: list[Any] = [None] * n
        versions = [stable.version] * n
        queries: list[Any] = [None] * n
        supplemented: list[Any] = [None] * n
        stable_idx: list[int] = []
        cand_idx: list[int] = []
        trace_ids = trace_ids or [None] * n
        for i, payload in enumerate(payloads):
            token = set_trace_id(trace_ids[i])
            try:
                self._route_one(i, payload, stable, cand, plan, gen, canary, queries, supplemented,
                                outs, versions, stable_idx, cand_idx)
            finally:
                reset_trace_id(token)
        dispatched = []
        for lane, lane_name, idxs in ((stable, LANE_STABLE, stable_idx), (cand, LANE_CANDIDATE, cand_idx)):
            if lane is None or not idxs:
                continue
            sup = [supplemented[i] for i in idxs]
            fins = []
            for algo, model in zip(lane.algorithms, lane.models):
                try:
                    fins.append(algo.predict_batch_dispatch(model, sup))
                except Exception:
                    if lane_name == LANE_STABLE:
                        raise
                    logger.exception("candidate dispatch failed; deferring to fetch")
                    fins.append(None)
            dispatched.append((lane, lane_name, idxs, sup, fins))

        timings = {"device_s": 0.0, "serve_s": 0.0}

        def finalize() -> list[tuple[Any, str]]:
            sniffed: list[tuple[Any, Any]] = []
            # every lane's predictions first, then the rows: a lane fetched
            # after the other's rows are served overlaps the next batch's
            # dispatch (its kernels, its host work), which the lane fetched
            # first does not, and reads slower to the bake gate's latency
            # veto (C20)
            fetched = []
            for lane, lane_name, idxs, sup, fins in dispatched:
                t0 = time.perf_counter()
                preds_per_algo = self._lane_predictions(lane, sup, fins)
                lane_predict_s = time.perf_counter() - t0
                timings["device_s"] += lane_predict_s
                inst.observe_predict(lane_predict_s, len(idxs), version=lane.version)
                fetched.append((lane, lane_name, idxs, preds_per_algo))
            for lane, lane_name, idxs, preds_per_algo in fetched:
                for row, i in enumerate(idxs):
                    token = set_trace_id(trace_ids[i])
                    t_serve = time.perf_counter()
                    if lane_name != LANE_CANDIDATE or gen == self._rollout_gen:
                        inst.requests.inc(version=lane.version, lane=lane_name)
                    try:
                        outs[i] = self._serve_one(lane, queries[i], [p[row] for p in preds_per_algo], sniffed)
                        if lane_name == LANE_CANDIDATE and gen == self._rollout_gen:
                            self.candidate_breaker.record_success()
                        if bandit is not None:
                            # an answered query is a pull the moment it is
                            # served; its trace id becomes matchable
                            bandit.record_impression(
                                trace_ids[i], ARM_CANDIDATE if lane_name == LANE_CANDIDATE else ARM_STABLE,
                                lane.version,
                            )
                    except Exception as exc:
                        if lane_name == LANE_CANDIDATE:
                            self._record_candidate_failure(lane.version, gen)
                            outs[i], versions[i] = self._stable_retry(stable, queries[i], sniffed)
                            if bandit is not None and not isinstance(outs[i], BaseException):
                                # re-answered on stable: a stable pull
                                bandit.record_impression(trace_ids[i], ARM_STABLE, stable.version)
                        else:
                            logger.exception("serving a query failed")
                            inst.errors.inc(version=lane.version, lane=lane_name)
                            outs[i] = exc
                    finally:
                        timings["serve_s"] += time.perf_counter() - t_serve
                        reset_trace_id(token)
            if shadow:
                pairs = [
                    (queries[i], outs[i]) for i in stable_idx if not isinstance(outs[i], BaseException)
                ]
                if pairs:
                    self._submit_shadow(cand, pairs, gen)
            if sniffed and self.plugin_context.output_sniffers:
                # a slow or failing sniffer must neither delay the batch's
                # answers nor change one
                self._background(self._sniffer_pool, self._notify_sniffers, sniffed)
            return list(zip(outs, versions))

        finalize.timings = timings
        return finalize

    def _route_one(self, i, payload, stable, cand, plan, gen, canary, queries, supplemented, outs,
                   versions, stable_idx, cand_idx) -> None:
        """Decode query ``i``, route it to a lane and supplement it there
        (see :meth:`dispatch_batch`)."""
        inst = self._rollout_instruments
        try:
            q = self.engine.decode_query(payload)
        except Exception as exc:
            # a bad payload (a list, null, a missing field) fails alone
            outs[i] = exc
            return
        queries[i] = q
        lane = stable
        if canary and choose_lane(plan, routing_key(payload, self.config.sticky_key_field)) == LANE_CANDIDATE:
            try:
                supplemented[i] = cand.serving.supplement(q)
                lane = cand
            except Exception:
                logger.exception("candidate supplement failed")
                if gen == self._rollout_gen:
                    inst.requests.inc(version=cand.version, lane=LANE_CANDIDATE)
                self._record_candidate_failure(cand.version, gen)
        if lane is stable:
            try:
                supplemented[i] = stable.serving.supplement(q)
            except Exception as exc:
                inst.requests.inc(version=stable.version, lane=LANE_STABLE)
                inst.errors.inc(version=stable.version, lane=LANE_STABLE)
                outs[i] = exc
                return
            stable_idx.append(i)
        else:
            versions[i] = cand.version
            cand_idx.append(i)

    def _lane_predictions(self, lane: Lane, sup: list[Any], fins: list[Any]) -> list[list[Any]]:
        """One lane's per-algorithm predictions; a batch that fails falls
        back to per-query predicts, so one poisonous query cannot fail its
        batch mates."""
        preds_per_algo: list[list[Any]] = []
        for fin, algo, model in zip(fins, lane.algorithms, lane.models):
            try:
                preds = list(fin() if fin is not None else algo.predict_batch(model, sup))
                if len(preds) != len(sup):
                    raise RuntimeError(f"predict_batch returned {len(preds)} results for {len(sup)} queries")
            except Exception:
                logger.exception("batched predict failed; falling back to per-query")
                preds = []
                for s in sup:
                    try:
                        preds.append(algo.predict(model, s))
                    except Exception as exc:
                        preds.append(exc)
            preds_per_algo.append(preds)
        return preds_per_algo

    def _serve_one(self, lane: Lane, query: Any, plist: list[Any], sniffed: list) -> Any:
        """Serve, the output blockers (which may rewrite or veto), encode;
        raises the first per-query prediction failure."""
        for p in plist:
            if isinstance(p, BaseException):
                raise p
        result = lane.serving.serve(query, plist)
        result = self.plugin_context.apply_output_blockers(self.manifest.variant, query, result)
        sniffed.append((query, result, current_trace_id()))
        return self.engine.encode_result(result)

    def _notify_sniffers(self, sniffed: list) -> None:
        for query, result, trace_id in sniffed:
            token = set_trace_id(trace_id)
            try:
                self.plugin_context.notify_output_sniffers(self.manifest.variant, query, result)
            finally:
                reset_trace_id(token)

    def _stable_retry(self, stable: Lane, query: Any, sniffed: list) -> tuple[Any, str]:
        """Answer a candidate-lane query again on the stable lane."""
        inst = self._rollout_instruments
        inst.requests.inc(version=stable.version, lane=LANE_STABLE)
        try:
            s = stable.serving.supplement(query)
            plist = [algo.predict(model, s) for algo, model in zip(stable.algorithms, stable.models)]
            return self._serve_one(stable, query, plist, sniffed), stable.version
        except Exception as exc:
            logger.exception("stable retry after candidate failure failed")
            inst.errors.inc(version=stable.version, lane=LANE_STABLE)
            return exc, stable.version

    def _record_candidate_failure(self, version: str, gen: int | None = None) -> None:
        """One candidate failure against the breaker, unless the work
        belongs to an earlier rollout. A trip rolls the candidate back at
        once."""
        if gen is not None and gen != self._rollout_gen:
            return
        self._rollout_instruments.errors.inc(version=version, lane=LANE_CANDIDATE)
        self.candidate_breaker.record_failure()
        if self.candidate_breaker.state == OPEN:
            self._rollback_candidate("breaker-trip")

    def _submit_shadow(self, cand: Lane, pairs: list[tuple[Any, Any]], gen: int) -> None:
        """Queue one batch for shadow scoring, bounded: a candidate slower
        than live traffic drops samples (counted) instead of queueing."""
        with self._shadow_lock:
            if self._shadow_pending >= self.config.shadow_max_backlog:
                self._rollout_instruments.shadow_dropped.inc(len(pairs), version=cand.version)
                return
            self._shadow_pending += 1
        self._shadow_pool.submit(self._shadow_score, cand, pairs, gen)

    def _shadow_score(self, cand: Lane, pairs: list[tuple[Any, Any]], gen: int) -> None:
        """Score the candidate on answered stable traffic, off the serving
        path (the shadow thread launches on the same card): the answer is
        compared with stable's on the host and discarded. A failure feeds
        the candidate breaker; work of an ended rollout is skipped."""
        inst = self._rollout_instruments
        try:
            for query, stable_body in pairs:
                if gen != self._rollout_gen:
                    return
                try:
                    t0 = time.perf_counter()
                    s = cand.serving.supplement(query)
                    plist = [algo.predict(model, s) for algo, model in zip(cand.algorithms, cand.models)]
                    body = self._serve_one(cand, query, plist, [])
                    scored_s = time.perf_counter() - t0
                    if gen != self._rollout_gen:
                        return
                    inst.observe_predict(scored_s, 1, version=cand.version)
                    inst.shadow_scored.inc(version=cand.version)
                    if _canonical_json(body) != _canonical_json(stable_body):
                        inst.divergence.inc(version=cand.version)
                    self.candidate_breaker.record_success()
                except Exception:
                    logger.exception("shadow scoring failed")
                    if gen != self._rollout_gen:
                        return
                    inst.shadow_scored.inc(version=cand.version)
                    inst.errors.inc(version=cand.version, lane=LANE_SHADOW)
                    self.candidate_breaker.record_failure()
                    if self.candidate_breaker.state == OPEN:
                        self._rollback_candidate("breaker-trip")
        finally:
            with self._shadow_lock:
                self._shadow_pending -= 1

    # -- rollout transitions ---------------------------------------------------
    def _new_candidate_breaker(self) -> CircuitBreaker:
        breaker = CircuitBreaker(name="candidate", failure_threshold=self.config.candidate_breaker_threshold)
        breaker.chain_listener(self._on_candidate_transition)
        return breaker

    def _on_candidate_transition(self, name: str, old: str, new: str) -> None:
        """A candidate-breaker trip captures the host stacks that show what
        the serving threads were doing (profile-on-alert); the rollback
        itself is :meth:`_record_candidate_failure`'s."""
        if new == OPEN:
            self._profile_on_alert("breaker-trip", {"breaker": name, "from": old, "to": new})

    def stage_candidate_lane(
        self, lane: Lane, mode: str = MODE_CANARY, fraction: float = 0.1, persist: bool = True
    ) -> None:
        """Install a candidate lane and begin the bake. The sticky salt is
        the candidate version, so every replica canaries the same users."""
        if mode not in (MODE_CANARY, MODE_SHADOW):
            raise ValueError(f"rollout mode must be canary|shadow, got {mode!r}")
        if lane.version == self._active.version:
            raise ValueError(f"{lane.version} is already the stable version")
        fraction = max(0.0, min(1.0, float(fraction)))
        with self._rollout_mutex:
            self._rollout_gen += 1
            self.candidate_breaker = self._new_candidate_breaker()
            self._candidate = lane
            self._plan = RolloutPlan(mode, fraction if mode == MODE_CANARY else 0.0, lane.version)
            stable_version = self._active.version
            self.rollout_controller.begin(stable_version, lane.version, mode)
            plan = self._plan
        if self.bandit is not None and mode == MODE_CANARY:
            # engage the two-arm bandit on this rollout (a persisted
            # posterior of the same version pair resumes); a failure (no
            # reward app, storage down) leaves the plain bake gate in charge
            # and never blocks the stage itself
            try:
                self.bandit.begin(stable_version, lane.version, self._bandit_tailer())
            except Exception:
                logger.exception("bandit engage failed; plain bake gate governs this rollout")
        # a re-staged candidate must not inherit entries of an earlier life
        # of its version (lookups are bypassed for the whole bake anyway)
        self._cache_flush(lane.version, f"stage {lane.version}")
        self._rollout_instruments.set_plan(plan)
        if persist and self.registry_store is not None:
            try:
                self.registry_store.stage_candidate(
                    self.manifest.engine_id, lane.version, mode=mode, fraction=fraction
                )
            except Exception:
                logger.exception("registry stage bookkeeping failed")
        logger.info("staged candidate %s (%s, fraction %.3f)", lane.version, mode, fraction)

    def _promote_candidate(self, persist: bool = True) -> str | None:
        """Candidate becomes stable. Returns its version, or None when none
        is staged. ``persist=False``: the registry already records it."""
        with self._rollout_mutex:
            cand = self._candidate
            if cand is None:
                return None
            self._rollout_gen += 1
            retired = self._active.version
            self._active = cand
            if cand.instance_id:
                self.instance_id = cand.instance_id
            if cand.engine_params is not None:
                self.engine_params = cand.engine_params
            self._candidate = None
            self._plan = PLAN_OFF
            self.rollout_controller.end()
        # the retired stable's entries stop being addressable: flush them
        self._cache_flush(retired, f"promote {cand.version}")
        self._rollout_instruments.set_plan(PLAN_OFF)
        self._rollout_instruments.promotions.inc()
        if self.bandit is not None and self.bandit.active:
            self.bandit.end("promote")
        if persist and self.registry_store is not None:
            try:
                self.registry_store.promote(self.manifest.engine_id, cand.version)
            except Exception:
                logger.exception("registry promote bookkeeping failed")
        logger.info("promoted candidate %s to stable", cand.version)
        return cand.version

    def _rollback_candidate(self, reason: str, detail: str = "", persist: bool = True) -> str | None:
        """Drop the candidate lane; stable serves on untouched. The
        registry is unstaged, never rolled back: its rollback would revert
        the stable pin when no candidate is recorded there."""
        with self._rollout_mutex:
            cand = self._candidate
            if cand is None:
                return None
            self._rollout_gen += 1
            self._candidate = None
            self._plan = PLAN_OFF
            self.rollout_controller.end()
        # candidate answers are never cached; this flush guards any path
        # that would put them there
        self._cache_flush(cand.version, f"rollback {cand.version} ({reason})")
        self._rollout_instruments.set_plan(PLAN_OFF)
        self._rollout_instruments.rollbacks.inc(reason=reason)
        if self.bandit is not None and self.bandit.active:
            self.bandit.end("retire" if reason == "bandit-retire" else "rollback")
        if persist and self.registry_store is not None:
            try:
                self.registry_store.unstage(
                    self.manifest.engine_id, reason=f"{reason}: {detail}" if detail else reason
                )
            except Exception:
                logger.exception("registry rollback bookkeeping failed")
        logger.warning("candidate %s rolled back (%s) %s", cand.version, reason, detail)
        return cand.version

    def _bandit_tailer(self) -> RewardTailer:
        """The reward tail of one rollout: feedback events of the
        configured app, matched to served impressions by the trace id
        echoed into their properties. The cursor seeds at the current
        sequence head, so history never credits an arm."""
        from predictionio_tpu_torch.data.store.event_store import resolve_app

        app_name = self.config.bandit_app_name
        if not app_name:
            raise ValueError(
                "bandit policy configured without bandit_app_name (the app whose events carry rewards)"
            )
        app_id, channel_id = resolve_app(self.ctx.storage, app_name, self.config.bandit_channel_name)
        return RewardTailer(
            self.ctx.storage.get_l_events(),
            app_id,
            channel_id,
            event_names=tuple(self.config.bandit_reward_events),
            trace_property=self.config.bandit_trace_property,
            reward_property=self.config.bandit_reward_property,
        )

    def _bandit_apply_fraction(self, fraction: float) -> None:
        """Move the live canary fraction to the policy's choice. The salt
        (the candidate version) stays, so a fraction change flips only the
        users whose sticky bucket the boundary crossed."""
        with self._rollout_mutex:
            plan = self._plan
            if self._candidate is None or plan.mode != MODE_CANARY:
                return
            if abs(plan.fraction - fraction) < 1e-9:
                return
            self._plan = plan = RolloutPlan(MODE_CANARY, fraction, plan.salt)
        self._rollout_instruments.set_plan(plan)

    def _adopt_stable(self, lane: Lane) -> None:
        """Swap in a new stable lane (``/reload``, or a stable pin another
        process moved); a bake in flight is rebased on the new stable."""
        with self._rollout_mutex:
            self._rollout_gen += 1
            retired = self._active.version
            self._active = lane
            if lane.instance_id:
                self.instance_id = lane.instance_id
            if lane.engine_params is not None:
                self.engine_params = lane.engine_params
            cand = self._candidate
            if cand is not None:
                self.rollout_controller.begin(lane.version, cand.version, self._plan.mode)
        # the version that just stopped serving answers nothing more from cache
        self._cache_flush(retired, f"stable -> {lane.version}")

    def _version_for_instance(self, instance_id: str) -> str:
        """Registry version whose lineage points at this engine instance;
        the instance id itself when the registry does not know it."""
        if self.registry_store is not None:
            for m in self.registry_store.list_versions(self.manifest.engine_id):
                if m.instance_id == instance_id:
                    return m.version
        return instance_id

    def _load_lane_from_registry(self, version: str) -> Lane:
        """Registry artifact -> servable lane: verified blob, deserialize,
        prepare_deploy on this server's device, fresh components, warmup.
        Engine params come from the manifest's engine instance when the
        metadata store still has it."""
        store = self.registry_store
        if store is None:
            raise RuntimeError("no model registry configured (registry_dir)")
        manifest = store.get_manifest(self.manifest.engine_id, version)
        if manifest is None:
            raise ValueError(f"unknown model version {version!r}")
        persisted = model_io.deserialize_models(store.load_blob(self.manifest.engine_id, version))
        engine_params = self.engine_params
        if manifest.instance_id:
            instance = self.ctx.storage.get_meta_data_engine_instances().get(manifest.instance_id)
            if instance is not None:
                engine_params = _engine_params_of_instance(self.engine, instance)
        models = self.engine.prepare_deploy(self.ctx, engine_params, persisted)
        # pin the version's ANN index (when its manifest carries one) onto
        # the model before warmup launches the serving path
        ann_lifecycle.attach_from_registry(store, self.manifest.engine_id, version, models,
                                           device=self.ctx.device)
        _, _, algorithms, serving = self.engine.make_components(engine_params)
        self._warmup_components(algorithms, models)
        return Lane(algorithms, serving, models, version, manifest.instance_id, engine_params)

    def reload(self) -> dict[str, Any]:
        """Swap in the latest COMPLETED instance (ref MasterActor reload):
        load and warm first, then commit in one swap."""
        with self._reload_lock:
            latest = self.ctx.storage.get_meta_data_engine_instances().get_latest_completed(
                self.manifest.engine_id, self.manifest.version, self.manifest.variant
            )
            if latest is None:
                raise LookupError("no completed engine instance found")
            engine_params = _engine_params_of_instance(self.engine, latest)
            models = load_models_for_instance(self.engine, engine_params, latest.id, self.ctx)
            _, _, algorithms, serving = self.engine.make_components(engine_params)
            self._warmup_components(algorithms, models)
            version = self._version_for_instance(latest.id)
            self._adopt_stable(Lane(algorithms, serving, models, version, latest.id, engine_params))
        logger.info("reloaded engine instance %s", latest.id)
        return {"message": "Reload successful", "instanceId": latest.id}

    def stage_from_registry(self, version: str, mode: str = MODE_CANARY, fraction: float = 0.1) -> None:
        with self._reload_lock:
            self.stage_candidate_lane(self._load_lane_from_registry(version), mode=mode, fraction=fraction)

    # -- result cache plumbing -----------------------------------------------
    def _cache_lookup_version(self) -> str | None:
        """The version whose entries may answer now: the stable version
        with no rollout active, None (bypass) while one is."""
        if self._candidate is not None or self._plan is not PLAN_OFF:
            return None
        return self._active.version

    def _cache_store(self, version: str, key: bytes, body: Any) -> None:
        """Insert one answered body; only the current stable version's
        answers are cacheable (a swap or stage between dispatch and store
        orphans the write)."""
        cache = self._result_cache
        if cache is None or self._candidate is not None or version != self._active.version:
            return
        cache.put(version, key, body)

    def _cache_flush(self, version: str | None, why: str) -> None:
        """Invalidate one version's entries (``None``: all of them)."""
        cache = self._result_cache
        if cache is None:
            return
        n = cache.clear() if version is None else cache.flush_version(version)
        if n:
            logger.info("result cache: flushed %d entries (%s)", n, why)

    def _collect_cache(self) -> None:
        """Scrape-time mirror of the cache's monotonic stats into the
        pio_cache_* counters (set_total clamps monotonic)."""
        stats = self._result_cache.stats()
        self._m_cache_hits.set_total(stats["hits"])
        self._m_cache_misses.set_total(stats["misses"])
        self._m_cache_evictions.set_total(stats["evictions"])
        self._m_cache_invalidations.set_total(stats["invalidations"])

    # -- profiling -----------------------------------------------------------
    def _profile_context(self) -> dict[str, Any]:
        """Manifest enrichment of every profile bundle: which engine and
        model served, at which registry generation."""
        generation = None
        if self.registry_store is not None:
            try:
                generation = self.registry_store.state_generation(self.manifest.engine_id)
            except Exception:  # enrichment, not evidence
                generation = None
        return {
            "engine": self.manifest.engine_id,
            "engineVersion": self.manifest.version,
            "modelVersion": self._active.version,
            "instanceId": self.instance_id,
            "registryGeneration": generation,
        }

    def _profile_parts(self) -> dict[str, Any]:
        """Host-side evidence of every bundle: the waterfall and the
        sampler's folded stacks at capture time."""
        return {"waterfall": self.waterfall.snapshot(), "stacks": self.sampler.snapshot()}

    def capture_profile(self, ms: int | None, trigger: str = "manual") -> str:
        """One bounded capture (blocking: runs on the handler thread)."""
        return self.profiler.capture(ms=ms, trigger=trigger, parts=self._profile_parts())

    def _profile_on_alert(self, trigger: str, context: dict[str, Any]) -> None:
        """Rate-limited background capture for alert paths; never blocks
        or raises into the caller."""
        if not self.config.profile_on_alert:
            return
        parts = self._profile_parts()
        texts = {"stacks_folded": self.sampler.folded()}
        threading.Thread(
            target=self.profiler.capture_alert,
            args=(trigger,),
            kwargs={"context": context, "parts": parts, "texts": texts},
            name="pio-profile-alert",
            daemon=True,
        ).start()

    def _check_slo_alerts(self) -> None:
        """SLO alert transitions capture a profile bundle (rides the
        rollout loop's tick)."""
        for rpt in self.slo.evaluate():
            name = rpt.get("name", "?")
            was = self._slo_alerting.get(name, False)
            now_alerting = bool(rpt.get("alerting"))
            self._slo_alerting[name] = now_alerting
            if now_alerting and not was:
                self._profile_on_alert(
                    "slo-alert", {"slo": name, "objective": rpt.get("objective")}
                )

    # -- the background loops --------------------------------------------------
    def _loop(self, interval_s: float, tick) -> None:
        while not self._closing.wait(interval_s):
            try:
                tick()
            except Exception:
                logger.exception("%s failed", getattr(tick, "__name__", "tick"))

    def _rollout_tick(self) -> None:
        """The bake gate, the bandit when one is engaged, and the SLO alert
        transitions. The gate's health veto outranks the bandit: a
        reward-winning arm that fails or blows the latency ratio still
        rolls back."""
        if self.config.profile_on_alert:
            self._check_slo_alerts()
        if self._candidate is None:
            return
        verdict, reason = self.rollout_controller.evaluate()
        if verdict == VERDICT_ROLLBACK:
            self._rollback_candidate(reason.split(" ")[0], reason)
            return
        bandit = self.bandit
        if bandit is None or not bandit.active:
            # the plain bake gate: time and health decide
            if verdict == VERDICT_PROMOTE:
                with self._reload_lock:
                    version = self._promote_candidate()
                if version:
                    logger.info("auto-promoted %s: %s", version, reason)
            return
        # the bandit is engaged: the tick drains new reward events from the
        # store (no lock held), credits the posteriors and re-chooses the
        # fraction. The reward posterior owns promote and retire; the gate's
        # promote verdict is the health-and-window precondition
        decision = bandit.tick()
        if decision is None:
            return  # the rollout flipped underneath the tick
        if decision.verdict == DECIDE_PROMOTE and verdict == VERDICT_PROMOTE:
            with self._reload_lock:
                version = self._promote_candidate()
            if version:
                logger.info("bandit promoted %s: %s", version, decision.reason)
        elif decision.verdict == DECIDE_RETIRE:
            self._rollback_candidate("bandit-retire", decision.reason)
        else:
            self._bandit_apply_fraction(decision.fraction)

    def _registry_sync_tick(self) -> None:
        """Adopt what other processes did to the registry's rollout state;
        a generation whose lane failed to load is retried next tick."""
        store = self.registry_store
        if store is None:
            return
        if store.state_generation(self.manifest.engine_id) == self._seen_state_gen:
            return
        with self._reload_lock:
            state = store.get_state(self.manifest.engine_id)
            if self._reconcile_registry_state(state):
                self._seen_state_gen = state.generation

    def _reconcile_registry_state(self, state) -> bool:
        if state.stable and state.stable != self._active.version:
            cand = self._candidate
            if cand is not None and cand.version == state.stable:
                self._promote_candidate(persist=False)
                logger.info("registry sync: adopted promote of %s", state.stable)
            else:
                try:
                    lane = self._load_lane_from_registry(state.stable)
                except Exception:
                    logger.exception("registry sync: stable %s unloadable", state.stable)
                    return False
                self._adopt_stable(lane)
        cand = self._candidate
        if state.candidate and state.candidate != self._active.version:
            plan_changed = cand is not None and (
                self._plan.mode != state.mode
                or (state.mode == MODE_CANARY and abs(self._plan.fraction - state.fraction) > 1e-9)
            )
            if cand is not None and cand.version == state.candidate and not plan_changed:
                return True
            if cand is not None and cand.version == state.candidate:
                lane = cand  # plan change only: reuse the loaded lane
            else:
                try:
                    lane = self._load_lane_from_registry(state.candidate)
                except Exception:
                    logger.exception("registry sync: candidate %s unloadable", state.candidate)
                    return False
            self.stage_candidate_lane(lane, mode=state.mode, fraction=state.fraction, persist=False)
            logger.info("registry sync: adopted candidate %s (%s)", state.candidate, state.mode)
        elif not state.candidate and cand is not None:
            self._rollback_candidate(
                "registry-sync", "registry candidate cleared by another process", persist=False
            )
        return True

    # -- views ---------------------------------------------------------------------
    def models_snapshot(self) -> dict[str, Any]:
        stable, cand, plan, _ = self.lanes()
        inst = self._rollout_instruments

        def lane_json(lane: Lane) -> dict[str, Any]:
            return {
                "version": lane.version,
                "instanceId": lane.instance_id,
                "counters": inst.lane_counts(lane.version),
                "p95PredictMs": round(inst.p95_seconds(lane.version) * 1e3, 3),
            }

        out: dict[str, Any] = {
            "stable": lane_json(stable),
            "candidate": lane_json(cand) if cand is not None else None,
            "mode": plan.mode,
            "fraction": plan.fraction,
            "stickyKeyField": self.config.sticky_key_field,
            "candidateBreaker": self.candidate_breaker.snapshot(),
            "controller": self.rollout_controller.snapshot(),
        }
        if self.registry_store is not None:
            state = self.registry_store.get_state(self.manifest.engine_id)
            out["registry"] = {
                "dir": self.registry_store.base_dir,
                "stateGeneration": state.generation,
                "state": state.to_json_dict(),
                "versions": [m.summary_row() for m in self.registry_store.list_versions(self.manifest.engine_id)],
            }
        return out

    def status(self) -> dict[str, Any]:
        b = self.batcher
        return {
            "status": "alive",
            "engineInstanceId": self.instance_id,
            "modelVersion": self.model_version,
            "device": str(self.ctx.device),
            "batches": b.batches_dispatched,
            "queries": b.queries_dispatched,
            "largestBatch": b.largest_batch,
            "batching": {
                "batches": b.batches_dispatched,
                "queries": b.queries_dispatched,
                "avgBatchSize": b.queries_dispatched / max(1, b.batches_dispatched),
            },
            "bandit": self.bandit.snapshot() if self.bandit is not None else None,
            "resultCache": self._result_cache.stats() if self._result_cache is not None else None,
            "profiling": {"ready": self.profiler.ready, "captureInFlight": self.profiler._flight.locked(),
                          "capturing": self.profiler.capturing},
            "latency": self._latency_summary_ms(),
            "resilience": self._resilience_snapshot(),
        }

    def _latency_summary_ms(self) -> dict[str, Any]:
        """The status page's latency block, from the histogram /metrics
        exports (every /queries.json answer, resilience 503s included)."""
        s = self._m_latency.summary(endpoint="/queries.json")
        if s["count"] == 0:
            return {"count": 0}
        return {
            "count": s["count"],
            "mean_ms": 1000.0 * s["mean"],
            "p50_ms": 1000.0 * s["p50"],
            "p95_ms": 1000.0 * s["p95"],
            "p99_ms": 1000.0 * s["p99"],
            "max_ms": 1000.0 * s["max"],
        }

    def _resilience_snapshot(self) -> dict[str, Any]:
        b = self.batcher
        return {
            "queueDepth": b.queue_depth,
            "queueHighWater": b.high_water,
            "watchdogTrips": b.watchdog_trips,
            "loadShedCount": b.shed_count,
            "breakers": {"dispatch": self.dispatch_breaker.snapshot()},
        }

    def healthz(self) -> tuple[int, dict[str, Any]]:
        """Readiness, distinct from the ``/`` status page: not ready while
        draining, closed, at high water or with the dispatch circuit open,
        so a load balancer routes around this replica."""
        snap = self._resilience_snapshot()
        shedding = snap["queueHighWater"] > 0 and snap["queueDepth"] >= snap["queueHighWater"]
        ready = (
            not self._draining
            and not self.batcher._closed
            and not shedding
            and snap["breakers"]["dispatch"]["state"] != OPEN
        )
        return (200 if ready else 503), {"ready": ready, "draining": self._draining, **snap}

    # -- background work -------------------------------------------------------
    def _background(self, pool: concurrent.futures.ThreadPoolExecutor | _PostQueue, fn, *args) -> None:
        """Fire and forget on ``pool``; dropped (logged) once shut down."""
        with self._background_lock:
            if self._background_closed:
                logger.warning("server shutting down: %s dropped", getattr(fn, "__name__", fn))
                return
            pool.submit(self._with_trace, current_trace_id(), fn, *args)

    @staticmethod
    def _with_trace(trace_id: str | None, fn, *args) -> None:
        """Run background work under the trace id of the request that
        queued it (a pool thread does not inherit the caller's context)."""
        token = set_trace_id(trace_id)
        try:
            fn(*args)
        finally:
            reset_trace_id(token)

    def _post(self, url: str, data: bytes, content_type: str, what: str) -> None:
        req = urllib.request.Request(url, data=data, method="POST", headers={"Content-Type": content_type})
        try:
            with self._http.open(req, timeout=self.config.http_timeout_s) as resp:
                resp.read()
        except Exception:
            logger.exception("%s POST to %s failed", what, url)

    def _remote_log(self, payload: Any, exc: BaseException) -> None:
        """Ship a serving error to the collector: ``log_prefix`` + JSON of
        {engineInstance, message} (ref ``CreateServer.remoteLog``)."""
        tb = "".join(traceback.format_exception(exc))
        message = f"Query:\n{payload}\n\nStack Trace:\n{tb}\n\n"
        body = self.config.log_prefix + json.dumps({"engineInstance": self.instance_id, "message": message})
        self._background(self._http_pool, self._post, self.config.log_url, body.encode(),
                         "text/plain; charset=utf-8", "remote log")

    def _send_feedback(self, query: Any, prediction: Any) -> None:
        """A ``predict`` event back to the event server
        (ref CreateServer.scala:500-570)."""
        url, key = self.config.event_server_url, self.config.feedback_access_key
        if not url or not key:
            return
        event = {
            "event": "predict",
            "entityType": "pio_pr",
            "entityId": self.manifest.engine_id,
            "properties": {"query": query, "prediction": prediction},
        }
        target = f"{url}/events.json?" + urllib.parse.urlencode({"accessKey": key})
        self._background(self._http_pool, self._post, target, json.dumps(event).encode(),
                         "application/json", "feedback")

    # -- drain accounting ------------------------------------------------------
    def _connection_accepted(self, sock) -> None:
        with self._drain_lock:
            self._unanswered_connections += 1
            self._open_connections.add(sock)

    def _connection_closed(self, sock) -> None:
        with self._drain_lock:
            self._open_connections.discard(sock)

    def _hang_up_connections(self) -> None:
        """End the read side of every open connection, as aiohttp's
        cleanup closes its keep-alives: a handler waiting for its next
        request reads end of stream and returns, and its thread lets go
        of the server (and the server of its lanes); a handler still
        writing an answer finishes it first. Bypasses ``SSLSocket``'s
        ``shutdown``, which would drop the TLS state under a writer."""
        with self._drain_lock:
            conns = list(self._open_connections)
        for sock in conns:
            try:
                socket.socket.shutdown(sock, socket.SHUT_RD)
            except OSError:  # the client hung up first
                pass

    def _first_request_done(self) -> None:
        """The calling handler thread's connection has had its first
        request answered (or closed without one); later requests on a
        keep-alive connection count only while they are in flight."""
        if getattr(self._first_request, "pending", False):
            self._first_request.pending = False
            with self._drain_lock:
                self._unanswered_connections -= 1

    def _request_began(self) -> None:
        with self._drain_lock:
            self._inflight_requests += 1

    def _request_ended(self) -> None:
        with self._drain_lock:
            self._inflight_requests -= 1

    # -- HTTP ------------------------------------------------------------------
    def _handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # headers and body go out in two writes: with Nagle's algorithm on,
            # the body would wait for the client's delayed ACK (~40 ms)
            disable_nagle_algorithm = True

            def log_message(self, fmt, *args):  # quiet: one line per request is noise
                logger.debug("%s " + fmt, self.address_string(), *args)

            def handle_one_request(self):
                self._trace_id = None  # one connection serves many requests
                self._status = 500
                self._deferred = None  # a /queries.json answer held until its span is recorded
                super().handle_one_request()
                server._first_request_done()

            def _reply(self, code: int, body: Any, headers: dict[str, str] | None = None) -> None:
                self._reply_raw(code, json.dumps(body).encode(), "application/json", headers)

            def _reply_raw(self, code: int, data: bytes, content_type: str,
                           headers: dict[str, str] | None = None, defer: bool = True) -> None:
                self._status = code
                if defer and self._deferred is not None:
                    self._deferred = (code, data, content_type, headers)
                    return
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                if self._trace_id is not None:
                    self.send_header(TRACE_HEADER, self._trace_id)
                self.end_headers()
                self.wfile.write(data)

            def _query_params(self) -> dict[str, str]:
                return dict(urllib.parse.parse_qsl(urllib.parse.urlsplit(self.path).query))

            def _unavailable(self, message: str, retry_after_s: float) -> None:
                """503 with the Retry-After clients and load balancers back off by."""
                self._reply(503, {"message": message}, {"Retry-After": str(max(1, round(retry_after_s)))})

            def _stop(self) -> None:
                self._reply(200, {"message": "Stopping."})
                server.stop_requested.set()

            def _reload(self) -> None:
                try:
                    self._reply(200, server.reload())
                except LookupError as exc:
                    self._reply(404, {"message": str(exc)})
                except Exception as exc:
                    logger.exception("reload failed")
                    self._reply(500, {"message": str(exc)})

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    self._reply(200, server.status())
                elif path == "/healthz":
                    self._reply(*server.healthz())
                elif path == "/plugins.json":
                    self._reply(200, server.plugin_context.to_json_dict())
                elif path == "/stop":
                    self._stop()
                elif path == "/models":
                    self._reply(200, server.models_snapshot())
                elif path == "/metrics":
                    code, ctype, data = metrics_response(server.metrics, self._query_params(), self.headers)
                    self._reply_raw(code, data, ctype)
                elif path == "/slo":
                    code, ctype, data = slo_response(server.slo, {"phases": server.waterfall.snapshot()})
                    self._reply_raw(code, data, ctype)
                elif path == "/traces/recent":
                    code, ctype, data = traces_response(server.tracer, self._query_params())
                    self._reply_raw(code, data, ctype)
                elif path == "/profile/stacks":
                    if self._query_params().get("format") == "json":
                        body = server.sampler.snapshot()
                        body["hotspots"] = server.sampler.hotspots()
                        self._reply(200, body)
                    else:
                        self._reply_raw(200, server.sampler.folded().encode(), "text/plain; charset=utf-8")
                elif path == "/reload":
                    logger.warning("GET /reload is deprecated (state-mutating GET); use POST /reload")
                    self._reload()
                else:
                    self._reply(404, {"message": "not found"})

            def do_POST(self):
                path = self.path.split("?")[0]
                try:  # a malformed frame is answered before any route, as aiohttp's parser does
                    framing(self.headers)
                except BodyError as exc:
                    reply_bad_framing(self, exc)
                    return
                if path == "/queries.json":
                    server._request_began()
                    try:
                        self._traced_queries()
                    finally:
                        server._request_ended()
                    return
                try:
                    body = read_body(self.headers, self.rfile, server.config.max_payload_bytes)
                except BodyTooLarge:
                    self.close_connection = True  # the rest stays unread
                    self._reply(413, {"message": "payload too large"})
                    return
                except BodyError as exc:
                    reply_bad_framing(self, exc)
                    return
                routes = {
                    "/profile/capture": self._profile_capture,
                    "/stop": self._stop,
                    "/reload": self._reload,
                    "/models/candidate": lambda: self._models_candidate(body),
                    "/models/promote": lambda: self._models_promote(body),
                    "/models/rollback": self._models_rollback,
                }
                if path in routes:
                    routes[path]()
                else:
                    self._reply(404, {"message": "not found"})

            def _profile_capture(self) -> None:
                """``POST /profile/capture?ms=``: one bounded capture on this
                handler thread; 409 while another runs."""
                raw = self._query_params().get("ms")
                try:
                    ms = int(raw) if raw is not None else None
                except ValueError:
                    self._reply(400, {"message": "ms must be an integer"})
                    return
                try:
                    path = server.capture_profile(ms)
                except ProfileBusyError:
                    self._reply(409, {"message": "a profile capture is already in flight"})
                    return
                except Exception as exc:
                    logger.exception("profile capture failed")
                    self._reply(500, {"message": f"capture failed: {exc}"})
                    return
                traced = server.profiler.clamp_ms(ms) > 0
                self._reply(200, {
                    "bundle": os.path.basename(path),
                    "path": path,
                    "durationMs": server.profiler.clamp_ms(ms),
                    "modelVersion": server.model_version,
                    "kernels": server.profiler.last_kernels if traced else {},
                    "launchesCounted": server.profiler.last_counted if traced else None,
                })

            def _traced_queries(self) -> None:
                """The trace and metrics envelope of the query path: accept
                or mint the trace id (echoed), record the ingress span, and
                count and time every status. One end timestamp anchors the
                latency histogram and the respond phase, so the phases tile
                what the histogram reads."""
                t0 = time.perf_counter()
                trace_id = self.headers.get(TRACE_HEADER) or mint_trace_id()
                self._trace_id = trace_id
                token = set_trace_id(trace_id)
                phases: dict[str, float] = {"t_start": t0}
                # the answer is written after the ingress span, the counters
                # and the respond phase are recorded, as the JAX envelope
                # records them before aiohttp writes the response
                self._deferred = ()
                try:
                    with server.tracer.span("http.query", kind="ingress", endpoint="/queries.json") as sp:
                        self._queries(phases)
                        sp.tags["status"] = self._status
                        if phases.get("t_done") is not None:
                            phases["respond_s"] = time.perf_counter() - phases["t_done"]
                        sp.tags.update(phase_tags_ms(
                            ingress_parse=phases.get("parse_s"), respond=phases.get("respond_s")
                        ))
                finally:
                    reset_trace_id(token)
                    t_end = time.perf_counter()
                    server._m_requests.inc(endpoint="/queries.json", status=str(self._status))
                    server._m_latency.observe(t_end - t0, endpoint="/queries.json")
                    t_done = phases.get("t_done")
                    if t_done is not None:
                        server.waterfall.observe(PHASE_RESPOND, t_end - t_done, trace_id)
                answer, self._deferred = self._deferred, None
                if answer:
                    self._reply_raw(*answer, defer=False)

            def _queries(self, phases: dict[str, float]) -> None:
                """The JAX handler's order: access key, size, JSON, the
                result cache, the dispatch breaker, then the batcher under
                the deadline."""
                cfg = server.config
                if cfg.accesskey:
                    query = urllib.parse.parse_qs(urllib.parse.urlsplit(self.path).query)
                    supplied = (query.get("accessKey") or [""])[0] or (
                        self.headers.get("Authorization", "").removeprefix("Bearer ").strip()
                    )
                    if supplied != cfg.accesskey:
                        self.close_connection = True  # the body stays unread
                        self._reply(401, {"message": "Invalid accessKey."})
                        return
                try:
                    body = read_body(self.headers, self.rfile, cfg.max_payload_bytes)
                except BodyTooLarge as exc:
                    self.close_connection = True  # the rest stays unread
                    self._reply(413, {"message": f"query payload too large ({exc.length} > {cfg.max_payload_bytes} bytes)"})
                    return
                except BodyError as exc:  # a chunked body cut short
                    self.close_connection = True
                    self._reply_raw(exc.status, f"{exc.message}\n".encode(), "text/plain; charset=utf-8")
                    return
                try:
                    payload = json.loads(body.decode("utf-8"))
                except ValueError as exc:
                    self._reply(400, {"message": str(exc)})
                    return
                t_parse_end = time.perf_counter()
                phases["parse_s"] = parse_s = t_parse_end - phases["t_start"]
                server.waterfall.observe(PHASE_INGRESS_PARSE, parse_s, self._trace_id)
                # the result cache, before admission and before the breaker:
                # a wedged device must not block answers the cache holds
                cache, cache_key, t_anchor = server._result_cache, None, t_parse_end
                if cache is not None:
                    entry, version = None, server._cache_lookup_version()
                    if version is not None:
                        try:
                            cache_key = _canonical_query_bytes(payload)
                        except (TypeError, ValueError):
                            cache_key = None
                        if cache_key is not None:
                            entry = cache.get(version, cache_key)
                    t_anchor = time.perf_counter()
                    server.waterfall.observe(PHASE_CACHE, t_anchor - t_parse_end, self._trace_id)
                    if entry is not None:
                        server._m_cache_hits.inc()
                        phases["t_done"] = t_anchor
                        if entry.text is None:  # serialized once per entry
                            entry.text = json.dumps(entry.body)
                        if cfg.feedback:
                            server._send_feedback(payload, entry.body)
                        self._reply_raw(200, entry.text.encode(), "application/json",
                                        {VERSION_HEADER: entry.version})
                        return
                    if cache_key is not None:
                        server._m_cache_misses.inc()
                try:
                    server.dispatch_breaker.allow()
                except CircuitOpenError as exc:
                    server._m_breaker_rejected.inc()
                    self._unavailable("serving temporarily unavailable (dispatch circuit open)", exc.retry_after_s)
                    return
                try:
                    out, version = server.batcher.submit(
                        payload, Deadline.after(cfg.request_timeout_s),
                        phases=phases, t_submit=t_anchor, cache_key=cache_key,
                    ).result()
                except LoadShedError as exc:
                    # it died before any dispatch could record against the
                    # breaker: free its half-open probe slot (else the probe
                    # stays unresolved and the circuit half-open)
                    server.dispatch_breaker.release_probe()
                    self._unavailable(str(exc), exc.retry_after_s)
                except DeadlineExceeded as exc:
                    server.dispatch_breaker.release_probe()
                    server._m_deadline.inc()
                    logger.warning("query deadline exceeded: %s", exc)
                    self._unavailable(str(exc), cfg.shed_retry_after_s)
                except ShuttingDownError as exc:
                    server.dispatch_breaker.release_probe()
                    self._unavailable(str(exc), cfg.shed_retry_after_s)
                except Exception as exc:
                    logger.exception("query failed")
                    if cfg.log_url:
                        server._remote_log(payload, exc)
                    self._reply(400, {"message": str(exc)})
                else:
                    if cfg.feedback:
                        server._send_feedback(payload, out)
                    self._reply(200, out, {VERSION_HEADER: version})

            def _models_candidate(self, body: bytes) -> None:
                try:
                    req = json.loads(body or b"null")
                    version = str(req["version"])
                    mode = req.get("mode", MODE_CANARY)
                    fraction = float(req.get("fraction", 0.1))
                except Exception:
                    self._reply(400, {"message": "body must be JSON with a 'version' key"})
                    return
                try:
                    server.stage_from_registry(version, mode=mode, fraction=fraction)
                except (ValueError, RuntimeError) as exc:
                    self._reply(400, {"message": str(exc)})
                    return
                except Exception as exc:
                    logger.exception("staging candidate failed")
                    self._reply(500, {"message": str(exc)})
                    return
                self._reply(
                    200,
                    {"message": "Candidate staged", "version": version, "mode": mode, "fraction": fraction},
                )

            def _models_promote(self, body: bytes) -> None:
                # an explicit version is a guard, not a selector: it must
                # name the staged candidate, or nothing happens (409)
                try:
                    requested = (json.loads(body) or {}).get("version") if body else None
                except (ValueError, AttributeError):
                    requested = None
                with server._reload_lock:
                    cand = server._candidate
                    if requested is not None and (cand is None or cand.version != requested):
                        staged = cand.version if cand is not None else "none"
                        self._reply(
                            409,
                            {"message": f"version {requested} is not the staged candidate (staged: {staged})"},
                        )
                        return
                    version = server._promote_candidate()
                if version is None:
                    self._reply(404, {"message": "no candidate staged"})
                    return
                self._reply(200, {"message": "Promoted", "version": version, "instanceId": server.instance_id})

            def _models_rollback(self) -> None:
                version = server._rollback_candidate("manual")
                if version is None:
                    self._reply(404, {"message": "no candidate staged"})
                    return
                self._reply(200, {"message": "Rolled back", "version": version})

        return Handler

    def start(self) -> int:
        """Bind and serve on a background thread (TLS when configured, the
        handshake on each connection's own thread), start the bake loop
        (and registry sync when configured); returns the bound port."""
        httpd = _HTTPServer((self.config.ip, self.config.port), self._handler(), self)
        httpd.ssl_context = self.config.ssl_context()
        self._httpd = httpd
        self._thread = threading.Thread(target=httpd.serve_forever, name="pio-http", daemon=True)
        self._thread.start()
        if self.config.sampler_period_s > 0:
            self.sampler.start()
        loops = [("pio-rollout", self.config.bake_check_interval_s, self._rollout_tick)]
        if self.registry_store is not None and self.config.registry_sync_interval_s > 0:
            loops.append(("pio-registry-sync", self.config.registry_sync_interval_s, self._registry_sync_tick))
        for name, interval, tick in loops:
            t = threading.Thread(target=self._loop, args=(interval, tick), name=name, daemon=True)
            t.start()
            self._loops.append(t)
        return httpd.server_address[1]

    def drain(self) -> None:
        """Graceful drain (the SIGTERM path): mark draining, so /healthz
        answers 503 and a load balancer routes around us; close the
        listener, so new connections are refused (not a 5xx); then wait,
        at most ``drain_grace_s``, for the queue, the batches in flight and
        every accepted connection's request to be answered. The batcher
        runs on the whole time. Call :meth:`shutdown` after it."""
        if self._draining:
            return
        self._draining = True
        # the grace counts from the signal: closing the listener spends it
        until = self._exit_by = time.monotonic() + max(0.0, self.config.drain_grace_s)
        logger.info("drain: closing the listener, answering what was accepted")
        self._close_listener()
        b = self.batcher
        while time.monotonic() < until:
            with self._drain_lock:
                pending = self._inflight_requests + self._unanswered_connections
            if pending == 0 and b.queue_depth == 0 and b.batches_in_flight == 0:
                logger.info("drain complete: nothing in flight")
                return
            time.sleep(0.02)
        logger.warning("drain grace (%.1f s) expired with %d requests in flight",
                       self.config.drain_grace_s, self._inflight_requests)

    def _close_listener(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=10)
            self._httpd = None

    def shutdown(self) -> None:
        """Stop the loops and the listener, answer the batches in flight,
        fail what is queued, hang up the keep-alive connections, and close
        every pool. The feedback and remote-log POSTs still queued get what
        is left of a drain's grace (less ``EXIT_RESERVE_S``), else
        ``http_timeout_s``; what they do not finish by then is abandoned
        and logged, so a slow or silent event server cannot hold the
        process past its grace."""
        t0 = time.monotonic()
        posts_by = (
            self._exit_by - EXIT_RESERVE_S
            if self._exit_by is not None
            else t0 + self.config.http_timeout_s
        )
        self._closing.set()
        self.sampler.stop()
        for t in self._loops:
            t.join(timeout=10)
        self._loops = []
        self._close_listener()
        self.batcher.close()
        self._hang_up_connections()
        with self._background_lock:
            self._background_closed = True
        self._sniffer_pool.shutdown(wait=True)
        t_posts = time.monotonic()
        left = self._http_pool.close(posts_by)
        if left:
            logger.warning("shutdown: %d feedback / remote-log POST(s) unsent at the deadline", left)
        t_after = time.monotonic()
        self._shadow_pool.shutdown(wait=True)
        t_end = time.monotonic()
        if self._exit_by is not None and t_end > self._exit_by:
            # the evidence a supervisor's slow-exit report needs
            logger.warning(
                "shutdown ended %.2f s past the drain grace (%.1f s): %.2f s before the "
                "background POSTs, %.2f s for them, %.2f s after",
                t_end - self._exit_by, self.config.drain_grace_s, t_posts - t0,
                t_after - t_posts, t_end - t_after,
            )


def create_query_server(
    engine_dir: str,
    ctx: WorkflowContext,
    config: ServerConfig | None = None,
    variant_path: str | None = None,
) -> QueryServer:
    """Load the engine and what serves, lay the models out on
    ``ctx.device`` and build the server (ref commands/Engine.deploy). With a
    registry configured its pinned stable version serves; without one, or
    when it cannot be read, the latest COMPLETED instance in the metadata
    repository and that instance's model blob."""
    config = config or ServerConfig()
    manifest, engine = load_engine(engine_dir, variant_path)
    store = ArtifactStore(config.registry_dir) if config.registry_dir else None
    if store is not None:
        state = store.get_state(manifest.engine_id)
        if state.stable:
            try:
                return _query_server_from_registry(engine, manifest, store, state.stable, ctx, config)
            except Exception:
                logger.exception(
                    "registry stable %s unusable; falling back to the latest COMPLETED instance",
                    state.stable,
                )
    instance = ctx.storage.get_meta_data_engine_instances().get_latest_completed(
        manifest.engine_id, manifest.version, manifest.variant
    )
    if instance is None:
        raise RuntimeError(
            f"no COMPLETED engine instance for {manifest.engine_id} "
            f"{manifest.version} {manifest.variant}; run train first"
        )
    engine_params = engine.engine_params_from_variant(manifest.variant_json)
    models = load_models_for_instance(engine, engine_params, instance.id, ctx)
    return QueryServer(
        engine, engine_params, models, ctx, config, instance.id, manifest=manifest, registry_store=store
    )


def _query_server_from_registry(
    engine: Engine,
    manifest: EngineManifest,
    store: ArtifactStore,
    version: str,
    ctx: WorkflowContext,
    config: ServerConfig,
) -> QueryServer:
    """Deploy the registry's stable version: verified blob, deserialize,
    prepare_deploy; params from the lineage manifest's instance."""
    reg_manifest = store.get_manifest(manifest.engine_id, version)
    if reg_manifest is None:
        raise RuntimeError(f"registry stable {version} has no manifest")
    persisted = model_io.deserialize_models(store.load_blob(manifest.engine_id, version))
    engine_params = None
    if reg_manifest.instance_id:
        instance = ctx.storage.get_meta_data_engine_instances().get(reg_manifest.instance_id)
        if instance is not None:
            engine_params = _engine_params_of_instance(engine, instance)
    if engine_params is None:
        engine_params = engine.engine_params_from_variant(manifest.variant_json)
    models = engine.prepare_deploy(ctx, engine_params, persisted)
    ann_lifecycle.attach_from_registry(store, manifest.engine_id, version, models, device=ctx.device)
    logger.info("deploying registry stable %s (instance %s)", version, reg_manifest.instance_id or "?")
    return QueryServer(
        engine,
        engine_params,
        models,
        ctx,
        config,
        reg_manifest.instance_id or version,
        manifest=manifest,
        registry_store=store,
        model_version=version,
    )


def run_query_server(
    engine_dir: str,
    variant_path: str | None = None,
    config: ServerConfig | None = None,
    device: str | torch.device = "cuda",
) -> None:
    """Blocking entry point: deploy the engine in ``engine_dir`` on
    ``device`` from ``Storage.instance()`` and serve until a signal.
    SIGTERM drains (in-flight queries answer, then the listener closes), as
    a supervisor's rolling restart relies on; SIGINT and POST /stop stop at
    once. Call from the main thread."""
    import signal

    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.utils.device import resolve_device
    from predictionio_tpu_torch.utils.platform import wait_for_signal

    ctx = WorkflowContext(mode="serving", device=resolve_device(device), _storage=Storage.instance())
    server = create_query_server(engine_dir, ctx, config, variant_path)
    server.start()
    try:
        if wait_for_signal(server.stop_requested) == signal.SIGTERM:
            server.drain()
    finally:
        server.shutdown()
