"""StreamPipeline: drain -> fold-in -> publish registry candidates.

The ``pio stream`` loop. Each cycle drains bounded micro-batches from
the :class:`~predictionio_tpu_torch.stream.tailer.EventTailer`, folds them
into the :class:`~predictionio_tpu_torch.stream.trainers.IncrementalTrainer`,
and — when enough new events accumulated and the drift guard is clean —
snapshots the model and publishes it to the model registry as a
*candidate* (lineage parent = the current stable, train-span = the cursor
interval). The rollout machinery (bake gates, candidate breaker) then
decides promote/rollback; the speed layer never hot-swaps stable.

Exactly-once publish on at-least-once reads: the cursor checkpoints after
every absorbed drain, and each publish carries a deterministic span id
derived from the cursor interval it covers. Before publishing, the
registry's manifests are consulted for that span id — a crash replay of
the same interval recognizes the existing candidate instead of minting a
second one.

Each candidate publish carries the stable version's ANN index forward
(``ann.lifecycle.refresh_for_publish``, on the trainer's device) before it
is staged.

Port of ``predictionio_tpu/stream/pipeline.py``, with its tracing spans
(``stream.foldin`` per drain, ``stream.publish`` per publish attempt), the
``pio_seq_*`` family bound to a sequential trainer, and its drift signal: a
breached guard appends a ``kind="drift"`` record to the telemetry ring
(``ring=``) and triggers a rate-limited ``stream-drift`` incident bundle
(``incidents=``), which ``pio stream --obs-dir`` wires in. The JAX
``CompileWatcher`` has no counterpart (eager PyTorch has no jit cache).
The step profiler records phases only. ``publish_seconds`` times each publish's four parts (snapshot, serialize,
the store's sha256 and write), ``ann_refreshes`` each index refresh's
path, drift and seconds.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import deque
from typing import Any, Callable

from predictionio_tpu_torch.obs import xray
from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.obs.tracing import get_tracer
from predictionio_tpu_torch.registry import ArtifactStore, ModelManifest
from predictionio_tpu_torch.registry.store import MODE_CANARY, MODE_SHADOW
from predictionio_tpu_torch.resilience import CircuitOpenError
from predictionio_tpu_torch.stream.cursor import CursorStore, span_id_of
from predictionio_tpu_torch.stream.tailer import EventTailer
from predictionio_tpu_torch.stream.trainers import IncrementalTrainer
from predictionio_tpu_torch.workflow import model_io

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class StreamConfig:
    """Pipeline knobs."""

    engine_id: str
    engine_version: str = ""
    engine_variant: str = ""
    engine_factory: str = ""
    # rollout shape of published candidates
    mode: str = MODE_CANARY
    fraction: float = 0.1
    # publish when at least this many new events folded since last publish
    publish_min_events: int = 1
    # drains per run_once cycle (bounds a catch-up burst after downtime)
    max_batches_per_cycle: int = 100
    keep_versions: int = 20
    # run_forever pacing
    interval_s: float = 5.0
    breaker_pause_s: float = 5.0

    def __post_init__(self):
        if self.mode not in (MODE_CANARY, MODE_SHADOW):
            raise ValueError(f"mode must be canary|shadow, got {self.mode!r}")


class StreamInstruments:
    """The ``pio_stream_*`` metric family (rendered by both servers'
    /metrics when the pipeline shares their registry, and by ``pio top``)."""

    def __init__(self, registry: MetricsRegistry | None = None):
        self.registry = registry or MetricsRegistry()
        r = self.registry
        self.events = r.counter(
            "pio_stream_events_total", "events drained from the event store"
        )
        self.drains = r.counter("pio_stream_drains_total", "micro-batch drains")
        self.publishes = r.counter(
            "pio_stream_publishes_total", "registry candidates published"
        )
        self.drift_suppressed = r.counter(
            "pio_stream_drift_suppressed_total",
            "publishes suppressed by the drift guard",
        )
        self.errors = r.counter(
            "pio_stream_errors_total", "pipeline cycle errors", labelnames=("stage",)
        )
        self.lag_events = r.gauge(
            "pio_stream_lag_events", "events behind the store head (probe-capped)"
        )
        self.lag_seconds = r.gauge(
            "pio_stream_lag_seconds", "age of the oldest unprocessed event"
        )
        self.last_publish_ts = r.gauge(
            "pio_stream_last_publish_timestamp",
            "unix time of the last registry publish",
        )
        self.foldin_seconds = r.histogram(
            "pio_stream_foldin_seconds", "fold-in wall time per drained batch"
        )
        self.drain_seconds = r.histogram(
            "pio_stream_drain_seconds", "drain wall time per micro-batch"
        )
        # the pio_train_* family exists (zero series) from process start:
        # the fold-in profiler fills it
        xray.register_train_metrics(r)
        # the pio_ann_* family: the stream layer is the index's refresh
        # producer (the serving-side instruments ride the query server's)
        from predictionio_tpu_torch.ann.metrics import AnnInstruments

        self.ann = AnnInstruments(r)
        # the pio_seq_* family: the stream layer is where sessions fold in
        # (the sequential trainer binds to this on pipeline construction)
        from predictionio_tpu_torch.models.sequential.metrics import SeqInstruments

        self.seq = SeqInstruments(r)


class StreamPipeline:
    """One tailed (app, channel) feeding one incremental trainer."""

    def __init__(
        self,
        tailer: EventTailer,
        trainer: IncrementalTrainer,
        cursors: CursorStore,
        store: ArtifactStore | None,
        config: StreamConfig,
        *,
        instruments: StreamInstruments | None = None,
        tracer=None,
        stage_hook: Callable[[str, str, float], None] | None = None,
        clock: Callable[[], float] = time.time,
        ring=None,  # obs.tsring.TelemetryRing
        incidents=None,  # obs.incidents.IncidentRecorder
    ):
        self.tailer = tailer
        self.trainer = trainer
        self.cursors = cursors
        self.store = store
        self.config = config
        self.instruments = instruments or StreamInstruments()
        # bind the pio_seq_* family to a sequential trainer that was built
        # without one (only SequentialStreamTrainer carries the slot)
        if getattr(trainer, "_instruments", False) is None:
            trainer._instruments = self.instruments.seq
        self.tracer = tracer or get_tracer()
        # stage_hook(version, mode, fraction) overrides direct registry
        # staging — `pio stream --notify-url` posts /models/candidate to a
        # live server so the candidate lane starts baking immediately
        self.stage_hook = stage_hook
        self._clock = clock
        # drift breaches are structured signals, not just a counter: each
        # lands on the telemetry ring (kind="drift") and fires a
        # rate-limited incident bundle
        self.ring = ring
        self.incidents = incidents
        self.cursor = cursors.load(tailer.app_id, tailer.channel_id)
        # Restart rewind: events folded and checkpointed but never
        # PUBLISHED live only in the dead process's trainer, so resume
        # from the last published position (or the initial seed) and
        # re-fold them into this fresh trainer — at-least-once reads in
        # exchange for never losing events to the speed layer. The span
        # dedup keeps the replay from double-publishing.
        if self.cursor.position != self.cursor.published_position:
            logger.info(
                "rewinding cursor to the last published position "
                "(re-folding the unpublished tail)"
            )
            self.cursor.position = (
                list(self.cursor.published_position)
                if self.cursor.published_position
                else None
            )
            cursors.save(self.cursor)
        # events folded since the last publish attempt's span start
        self._span_from = self.cursor.pos()
        self._pending_events = 0
        self._pending_absorbed = 0
        # the fold-in step profiler: one TrainProfile per publish span
        # (created at the first drain after a publish, finished into the
        # candidate's manifest) — wall accumulates only inside run_once,
        # so run_forever's sleeps never dilute the tiling contract
        self._profile: xray.TrainProfile | None = None
        self._stop = threading.Event()
        # per publish: the four parts' seconds (snapshot, serialize,
        # sha256, write) and the blob's bytes, newest last
        self.publish_seconds: deque[dict[str, float]] = deque(maxlen=256)
        # per candidate whose parent pins an index: the refresh's path,
        # drift and seconds, newest last
        self.ann_refreshes: deque[dict[str, Any]] = deque(maxlen=256)

    # ------------------------------------------------------------------ run
    def _ensure_profile(self) -> xray.TrainProfile:
        if self._profile is None or self._profile.finished:
            self._profile = xray.TrainProfile(
                trainer=self.trainer.name,
                registry=self.instruments.registry,
            )
        return self._profile

    def run_once(self) -> dict[str, Any]:
        """One cycle: drain until caught up (bounded), fold, maybe publish.
        Returns a JSON-ready summary.

        Profiler phases (obs/xray): drains, checkpoints, and the lag
        probe account as ``host_etl``; each fold-in is ``sweep``; the
        drift guard is ``eval``; snapshot+serialize is ``host_etl`` again
        — together they tile the cycle's wall clock."""
        prof = self._ensure_profile()
        with xray.use_profile(prof), prof.measure():
            return self._cycle(prof)

    def _cycle(self, prof: xray.TrainProfile) -> dict[str, Any]:
        ins = self.instruments
        drained = 0
        backlog = False
        for _ in range(self.config.max_batches_per_cycle):
            t0 = time.perf_counter()
            with prof.phase(xray.PHASE_HOST_ETL):
                result = self.tailer.drain(self.cursor.pos())
            if not result.events:
                break
            # empty polls don't count: drains_total means batches that
            # actually moved events (pio top derives drains/s from it)
            ins.drain_seconds.observe(time.perf_counter() - t0)
            ins.drains.inc()
            with self.tracer.span("stream.foldin", kind="stream", trainer=self.trainer.name) as sp:
                t1 = time.perf_counter()
                with prof.phase(xray.PHASE_SWEEP):
                    absorbed = self.trainer.absorb(result.events)
                ins.foldin_seconds.observe(time.perf_counter() - t1)
                sp.tags["events"] = len(result.events)
                sp.tags["absorbed"] = absorbed
                stats = getattr(self.trainer, "last_absorb_stats", None)
                if stats:
                    sp.tags["rows"] = stats.get("rows")
                    sp.tags["entities"] = stats.get("entities")
            prof.add_rows(absorbed)
            drained += len(result.events)
            ins.events.inc(len(result.events))
            self._pending_events += len(result.events)
            self._pending_absorbed += absorbed
            # checkpoint AFTER the fold: a crash between fold and save
            # re-reads this drain (at-least-once); a crash before the fold
            # loses nothing
            with prof.phase(xray.PHASE_HOST_ETL):
                self.cursor.advance(result.position, len(result.events))
                self.cursors.save(self.cursor)
            backlog = result.more
            if not result.more:
                break
        with prof.phase(xray.PHASE_HOST_ETL):
            lag_n, lag_s = self.tailer.lag(
                self.cursor.pos(), assume_backlog=backlog
            )
        ins.lag_events.set(lag_n)
        ins.lag_seconds.set(lag_s)
        published, suppressed = None, False
        if (
            self.store is not None
            and self._pending_events >= self.config.publish_min_events
            # at least one event must have actually FOLDED: a span of
            # unusable events (wrong shape, held out) would republish an
            # unchanged — or for a fresh NB trainer, unbuildable — model
            and self._pending_absorbed > 0
            and self.cursor.pos() is not None
        ):
            published, suppressed = self._maybe_publish()
        return {
            "drained": drained,
            "pendingEvents": self._pending_events,
            "lagEvents": lag_n,
            "lagSeconds": round(lag_s, 3),
            "published": published,
            "driftSuppressed": suppressed,
            "cursor": self.cursor.to_json_dict(),
        }

    def run_forever(
        self, max_cycles: int | None = None, sleep: Callable[[float], None] = time.sleep
    ) -> None:
        """The ``pio stream`` loop: cycle, pause, repeat. A tripped tail
        breaker pauses for its recovery window instead of spinning; other
        errors are counted and the loop keeps going."""
        cycles = 0
        while not self._stop.is_set():
            try:
                summary = self.run_once()
                if summary["published"]:
                    logger.info(
                        "stream published %s (%d events this cycle)",
                        summary["published"],
                        summary["drained"],
                    )
            except CircuitOpenError as exc:
                logger.warning("tail breaker open, pausing: %s", exc)
                self.instruments.errors.inc(stage="drain")
                sleep(self.config.breaker_pause_s)
            except Exception:
                logger.exception("stream cycle failed")
                self.instruments.errors.inc(stage="cycle")
            cycles += 1
            if max_cycles is not None and cycles >= max_cycles:
                return
            if self._stop.is_set():
                return
            sleep(self.config.interval_s)

    def stop(self) -> None:
        self._stop.set()

    # -------------------------------------------------------------- publish
    def _find_published_span(self, span_id: str) -> ModelManifest | None:
        """Registry-side dedup: the manifest already covering this cursor
        interval, if a crashed prior run published it."""
        for m in self.store.list_versions(self.config.engine_id):
            if m.data_span.get("stream", {}).get("spanId") == span_id:
                return m
        return None

    def _signal_drift(self, report) -> None:
        """A breached guard: one ring record per suppressed publish
        (engine, trainer, guard, measured against threshold) and a
        rate-limited incident bundle. Never raises: the publish is already
        suppressed and the stream loop must keep folding."""
        detail = {
            "engine": self.config.engine_id,
            "trainer": self.trainer.name,
            "guard": report.metric,
            "measured": report.current,
            "threshold": report.baseline,
            "reason": report.reason,
        }
        if self.ring is not None:
            try:
                self.ring.append({"kind": "drift", **detail})
            except Exception:
                logger.exception("drift signal: ring append failed")
        if self.incidents is not None:
            self.incidents.trigger("stream-drift", context=detail)

    def _maybe_publish(self) -> tuple[str | None, bool]:
        with self.tracer.span("stream.publish", kind="stream", engine_id=self.config.engine_id) as sp:
            sp.tags["spanId"] = span_id_of(self._span_from, self.cursor.pos())
            version, suppressed = self._publish()
            if suppressed:
                sp.status = "drift-suppressed"
            elif version is not None:
                sp.tags["version"] = version
            return version, suppressed

    def _publish(self) -> tuple[str | None, bool]:
        cfg = self.config
        span_to = self.cursor.pos()
        span_id = span_id_of(self._span_from, span_to)
        prof = self._profile
        with xray.phase(xray.PHASE_EVAL):
            report = self.trainer.drift()
        if not report.ok:
            self.instruments.drift_suppressed.inc()
            logger.warning("drift guard breached; publish suppressed: %s", report.reason)
            self._signal_drift(report)
            return None, True
        existing = self._find_published_span(span_id)
        if existing is not None:
            # a crashed prior run already published this interval:
            # recognize it instead of minting a duplicate candidate — but
            # DO re-stage it (the crash may have landed between publish and
            # stage; _stage is a no-op for the auto-stable first publish and
            # tolerates an already-staged version). The replayed span keeps
            # the manifest's original profile.
            version = existing.version
            if prof is not None:
                prof.finish()
                self._profile = None
            self._stage(version)
        else:
            t0 = time.perf_counter()
            with xray.phase(xray.PHASE_HOST_ETL):
                models = self.trainer.snapshot()
                t1 = time.perf_counter()
                blob = model_io.serialize_models(models)
            t2 = time.perf_counter()
            # the fold-in profile is this candidate's training evidence:
            # finished here, attached both as the manifest's train_profile
            # and under data_span.stream
            profile_json: dict[str, Any] = {}
            if prof is not None:
                profile_json = prof.finish().to_json_dict()
                self._profile = None
            state = self.store.get_state(cfg.engine_id)
            timing: dict[str, float] = {}
            manifest = self.store.publish(
                ModelManifest(
                    version="",
                    engine_id=cfg.engine_id,
                    engine_version=cfg.engine_version,
                    engine_variant=cfg.engine_variant,
                    engine_factory=cfg.engine_factory,
                    parent_version=state.stable,
                    data_span={
                        "stream": {
                            "spanId": span_id,
                            "from": list(self._span_from) if self._span_from else None,
                            "to": list(span_to),
                            "events": self._pending_events,
                            "trainer": self.trainer.name,
                            "drift": report.to_json_dict(),
                            "profile": profile_json,
                        }
                    },
                    metrics={"driftMetric": report.metric},
                    train_profile=profile_json,
                ),
                blob,
                keep_last=cfg.keep_versions,
                timing=timing,
            )
            self.publish_seconds.append(
                {
                    "snapshot_s": t1 - t0,
                    "serialize_s": t2 - t1,
                    "sha256_s": timing.get("sha256_s", 0.0),
                    "write_s": timing.get("write_s", 0.0),
                    "bytes": float(len(blob)),
                }
            )
            version = manifest.version
            # the index is pinned before staging: the lane loader reads the
            # manifest at stage time. It bakes with its candidate and never
            # reaches stable on its own
            self._refresh_ann(state.stable, version, models)
            self._stage(version)
        self.cursor.record_publish(version, span_id, span_to)
        self.cursors.save(self.cursor)
        self.instruments.publishes.inc()
        self.instruments.last_publish_ts.set(self._clock())
        self._span_from = span_to
        self._pending_events = 0
        self._pending_absorbed = 0
        return version, False

    def _refresh_ann(self, parent_version: str, version: str, models) -> None:
        """Carry the stable version's ANN index onto the candidate just
        published (an incremental rebucket, or a drift-guarded rebuild).
        Best-effort, as in the reference: a failed refresh leaves the
        candidate serving exact, is counted in ``errors{stage="ann"}`` and
        never blocks the publish."""
        from predictionio_tpu_torch.ann import lifecycle as ann_lifecycle

        t0 = time.perf_counter()
        try:
            report = ann_lifecycle.refresh_for_publish(
                self.store, self.config.engine_id, parent_version, version, models,
                instruments=self.instruments.ann, device=getattr(self.trainer, "device", "cuda"),
            )
        except Exception:
            logger.exception("ann index refresh failed (candidate %s serves exact)", version)
            self.instruments.errors.inc(stage="ann")
            return
        if report is not None:
            self.ann_refreshes.append(
                {"version": version, **report, "seconds": time.perf_counter() - t0}
            )

    def _stage(self, version: str) -> None:
        """Hand the published version to the rollout path. The first ever
        publish auto-became stable inside ``ArtifactStore.publish`` (there
        is nothing to canary against), so only stage when it didn't."""
        state = self.store.get_state(self.config.engine_id)
        if state.stable == version:
            return
        if self.stage_hook is not None:
            self.stage_hook(version, self.config.mode, self.config.fraction)
            return
        try:
            self.store.stage_candidate(
                self.config.engine_id,
                version,
                mode=self.config.mode,
                fraction=self.config.fraction,
            )
        except ValueError as exc:
            # e.g. an operator staged something else concurrently; the
            # candidate stays published and listable either way
            logger.warning("stage skipped for %s: %s", version, exc)

    # ------------------------------------------------------------- snapshot
    def snapshot(self) -> dict[str, Any]:
        return {
            "engineId": self.config.engine_id,
            "trainer": self.trainer.name,
            "cursor": self.cursor.to_json_dict(),
            "pendingEvents": self._pending_events,
            "tailer": self.tailer.snapshot(),
        }


def serve_metrics(registry: MetricsRegistry, port: int, host: str = "0.0.0.0"):
    """Expose a registry at ``GET /metrics`` (Prometheus text) from a
    daemon thread — the scrape surface for a standalone ``pio stream``
    process. Stdlib http.server. Returns the server; ``shutdown()`` stops
    it."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - http.server contract
            if self.path.split("?")[0] not in ("/metrics", "/"):
                self.send_response(404)
                self.end_headers()
                return
            body = registry.render_prometheus().encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # scrapes are not operator news
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(
        target=server.serve_forever, name="stream-metrics", daemon=True
    )
    thread.start()
    return server


def trainer_for_models(
    models: list[Any], device: str = "cuda", **kwargs: Any
) -> IncrementalTrainer:
    """Pick the incremental trainer matching a deserialized models list
    (what the registry blob holds), seeded from the stable model so the
    stream continues FROM what serves rather than from scratch. The ALS
    fold-in solves on ``device``; the other trainers are host code. Raises
    when no model type has a fold-in implementation."""
    from predictionio_tpu_torch.e2.naive_bayes import CategoricalNaiveBayesModel
    from predictionio_tpu_torch.models.recommendation.engine import ALSModel
    from predictionio_tpu_torch.models.sequential.engine import SequentialModel
    from predictionio_tpu_torch.models.similarproduct.engine import CooccurrenceModel
    from predictionio_tpu_torch.stream.trainers import (
        FoldInALSTrainer,
        SequentialStreamTrainer,
        StreamingCooccurrenceTrainer,
        StreamingNaiveBayesTrainer,
    )

    for m in models:
        if isinstance(m, SequentialModel):
            return SequentialStreamTrainer(m, **kwargs)
    for m in models:
        if isinstance(m, ALSModel):
            return FoldInALSTrainer(models, device=device, **kwargs)
    for m in models:
        if isinstance(m, CategoricalNaiveBayesModel):
            # counts are unrecoverable from a log-prob model: the stream
            # model rebuilds from stream counts, with the stable model
            # anchoring the divergence drift guard (trainers.py)
            return StreamingNaiveBayesTrainer(m, **kwargs)
    for m in models:
        if isinstance(m, CooccurrenceModel):
            return StreamingCooccurrenceTrainer(m, **kwargs)
    raise ValueError(
        "no incremental trainer for model types "
        f"{[type(m).__name__ for m in models]}; fold-in is implemented for "
        "SequentialModel, ALSModel, CategoricalNaiveBayesModel, and "
        "CooccurrenceModel"
    )
