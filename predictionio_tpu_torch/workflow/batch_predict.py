"""Offline batch prediction (``pio batchpredict``): port of
``predictionio_tpu/workflow/batch_predict.py``.

    source ──read──▶ raw queries ──assemble──▶ mega-batch ──dispatch──▶ card
                                                                          │
    sink  ◀──write── served results ◀──fetch── packed [B,2,k] top-k ◀─────┘

- **Streaming sources**: :func:`iter_query_file` reads the query file line
  by line; :func:`iter_event_users` streams distinct users off the event
  store in ``find_after`` order (bounded pages) as ``{"user", "num"}``
  queries. Neither holds the corpus on the host.
- **Mega-batches**: :func:`run_pipeline` hands fixed batches to
  :meth:`Engine.dispatch_batch` (every algorithm's
  ``predict_batch_dispatch``: the kernels launch, nothing waits) and
  double-buffers: batch N is dispatched, then batch N-1 is fetched and
  written while the card computes N.
- **Sinks**: :class:`FileSink` writes line-aligned JSONL atomically (tmp +
  rename); :class:`EventStoreSink` writes the results back into the event
  store behind a retry policy and a circuit breaker.
- **Evidence**: the run records under a :class:`~predictionio_tpu_torch.obs
  .xray.TrainProfile` whose five phases (read, assemble, dispatch, fetch,
  write) tile the run's wall clock. ``fetch`` holds the wait for the card
  (the engines' finalize copies the top-k to the host), ``dispatch`` only
  the launches. A throttled atomic status file reports progress.

A malformed query line becomes a line-aligned ``{"error", "line"}`` object
in the output instead of aborting the run; the CLI exits nonzero only when
every line failed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import statistics
import tempfile
import time
from typing import Any, Callable, Iterable, Iterator

from predictionio_tpu_torch.controller.engine import Engine, EngineParams
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import LEvents, event_seq_key
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.obs import xray
from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.resilience import CircuitBreaker, RetryPolicy
from predictionio_tpu_torch.workflow.context import WorkflowContext
from predictionio_tpu_torch.workflow.core_workflow import load_models_for_instance
from predictionio_tpu_torch.workflow.engine_loader import load_engine

logger = logging.getLogger(__name__)

# the offline phase vocabulary; the phases tile the run wall clock
PHASE_READ = "read"  # pulling the next query from the source (file IO / event-store paging)
PHASE_ASSEMBLE = "assemble"  # JSON parse + engine query decode into the pending batch
PHASE_DISPATCH = "dispatch"  # supplement + upload + kernel launch
PHASE_FETCH = "fetch"  # wait for the card, packed [B,2,k] fetch, decode, serve
PHASE_WRITE = "write"  # result encode + sink write (file/event-store)

BATCH_PHASES: tuple[str, ...] = (
    PHASE_READ,
    PHASE_ASSEMBLE,
    PHASE_DISPATCH,
    PHASE_FETCH,
    PHASE_WRITE,
)

DEFAULT_MEGA_BATCH = 512
DEFAULT_EVENT_PAGE = 2048
DEFAULT_RESULT_EVENT = "batchpredict.result"


# ---------------------------------------------------------------------------
# instruments
# ---------------------------------------------------------------------------


def register_batchpredict_metrics(registry: MetricsRegistry) -> dict[str, Any]:
    """Get-or-create the ``pio_batchpredict_*`` family (idempotent)."""
    return {
        "queries": registry.counter(
            "pio_batchpredict_queries_total",
            "offline queries pulled from the source (ok + errored)",
        ),
        "errors": registry.counter(
            "pio_batchpredict_errors_total",
            "query lines that failed (malformed JSON, decode or batch "
            "failure) — each emitted as a line-aligned error object",
        ),
        "batches": registry.counter(
            "pio_batchpredict_batches_total",
            "mega-batches dispatched",
        ),
        "rows": registry.counter(
            "pio_batchpredict_rows_written_total",
            "result rows streamed to a writeback sink",
            labelnames=("sink",),
        ),
        "write_retries": registry.counter(
            "pio_batchpredict_write_retries_total",
            "writeback attempts retried by the resilience policy",
        ),
        "active": registry.gauge(
            "pio_batchpredict_active",
            "1 while an offline batch-predict run is executing",
        ),
    }


class BatchPredictInstruments:
    """Counter bundle for one offline run (own registry by default)."""

    def __init__(self, registry: MetricsRegistry | None = None):
        self.registry = registry or MetricsRegistry()
        m = register_batchpredict_metrics(self.registry)
        self.queries = m["queries"]
        self.errors = m["errors"]
        self.batches = m["batches"]
        self.rows = m["rows"]
        self.write_retries = m["write_retries"]
        self.active = m["active"]


# ---------------------------------------------------------------------------
# streaming query sources
# ---------------------------------------------------------------------------


def iter_query_file(path: str) -> Iterator[tuple[int, Any]]:
    """Stream ``(lineno, raw_json_line)`` from a multi-line query file, one
    line at a time. Blank lines are skipped; line numbers are 1-based file
    positions, so error objects point at the input."""
    with open(path) as fh:
        for lineno, raw in enumerate(fh, start=1):
            if raw.strip():
                yield lineno, raw


def iter_event_users(
    levents: LEvents,
    app_id: int,
    channel_id: int | None = None,
    *,
    num: int = 10,
    entity_type: str = "user",
    page: int = DEFAULT_EVENT_PAGE,
    limit: int = 0,
) -> Iterator[tuple[int, Any]]:
    """Stream distinct ``entity_type`` ids off the event store as
    ``{"user": id, "num": num}`` queries (the ``--from-events`` source),
    in ``find_after`` order with bounded pages; only the dedup id set
    lives on the host. ``limit`` > 0 caps the distinct users."""
    # bound the scan at the head as of run start: a --to-events run writes
    # its results into the same store and must not page over them
    head = levents.seq_head(app_id, channel_id)
    if head is None:
        return
    cursor: tuple[int, str] | None = None
    seen: set[str] = set()
    row = 0
    while True:
        events = levents.find_after(
            app_id, channel_id=channel_id, cursor=cursor, limit=page
        )
        if not events:
            return
        cursor = event_seq_key(events[-1])
        for e in events:
            if event_seq_key(e) > head:
                return
            if e.entity_type != entity_type or not e.entity_id:
                continue
            if e.entity_id in seen:
                continue
            seen.add(e.entity_id)
            row += 1
            yield row, {"user": e.entity_id, "num": num}
            if limit and row >= limit:
                return


# ---------------------------------------------------------------------------
# writeback sinks
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OutRow:
    """One line-aligned output row: a served result or an error object."""

    lineno: int
    query: Any  # the decoded query (None when the line never parsed)
    result: dict[str, Any]  # encode_result output, or {"error", "line"}
    ok: bool


class BatchPredictSink:
    """Streaming writeback target: ``write_batch`` per mega-batch, then
    ``close(success)`` exactly once. ``close(False)`` must leave no
    half-written artifact behind."""

    name = "sink"

    def write_batch(self, rows: list[OutRow]) -> None:
        raise NotImplementedError

    def close(self, success: bool) -> None:  # noqa: B027 - optional hook
        pass


class FileSink(BatchPredictSink):
    """Line-aligned JSONL output written atomically: rows stream into a tmp
    file in the destination directory and ``os.replace`` publishes it only
    on a successful close, so a killed run never leaves a truncated file
    that looks complete."""

    name = "file"

    def __init__(self, path: str):
        self.path = path
        directory = os.path.dirname(os.path.abspath(path))
        fd, self._tmp = tempfile.mkstemp(
            dir=directory, prefix=".tmp-batchpredict-"
        )
        self._fh = os.fdopen(fd, "w")
        self._closed = False

    def write_batch(self, rows: list[OutRow]) -> None:
        for row in rows:
            self._fh.write(json.dumps(row.result, sort_keys=True) + "\n")

    def close(self, success: bool) -> None:
        if self._closed:
            return
        self._closed = True
        if not success:
            try:
                self._fh.close()
            finally:
                with contextlib.suppress(OSError):
                    os.unlink(self._tmp)
            return
        # publish only after flush, fsync and close succeeded: a failed
        # flush (disk full) leaves the destination untouched
        try:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._fh.close()
        except BaseException:
            with contextlib.suppress(OSError):
                self._fh.close()
            with contextlib.suppress(OSError):
                os.unlink(self._tmp)
            raise
        os.replace(self._tmp, self.path)


class EventStoreSink(BatchPredictSink):
    """Stream scored rows into the event-store DAO (whatever backend the
    storage env selects) behind a retry policy and a circuit breaker, one
    ``insert_batch`` per mega-batch. Error rows
    have no entity to attach to and are skipped (they still reach the file
    sink and the error counter)."""

    name = "events"

    def __init__(
        self,
        levents: LEvents,
        app_id: int,
        channel_id: int | None = None,
        event_name: str = DEFAULT_RESULT_EVENT,
        model_version: str = "",
        retry: RetryPolicy | None = None,
        breaker: CircuitBreaker | None = None,
        on_retry: Callable[[], None] | None = None,
    ):
        self._levents = levents
        self._app_id = app_id
        self._channel_id = channel_id
        self._event_name = event_name
        self._model_version = model_version
        self._retry = retry or RetryPolicy(
            max_attempts=3,
            on_retry=(lambda *_a, **_k: on_retry()) if on_retry else None,
        )
        self._breaker = breaker or CircuitBreaker(name="batchpredict.writeback")

    def write_batch(self, rows: list[OutRow]) -> None:
        events = []
        for row in rows:
            if not row.ok:
                continue
            user = getattr(row.query, "user", None)
            if user is None and isinstance(row.query, dict):
                user = row.query.get("user")
            events.append(
                Event(
                    event=self._event_name,
                    entity_type="user",
                    entity_id=str(user) if user is not None else f"line{row.lineno}",
                    properties={
                        "prediction": row.result,
                        "modelVersion": self._model_version,
                        "line": row.lineno,
                    },
                )
            )
        if not events:
            return

        def _insert():
            return self._breaker.call(
                self._levents.insert_batch, events, self._app_id, self._channel_id
            )

        self._retry.call(_insert)


class MemorySink(BatchPredictSink):
    """Collects rows in memory (tests and :func:`run_batch_predict_on`)."""

    name = "memory"

    def __init__(self):
        self.rows: list[OutRow] = []

    def write_batch(self, rows: list[OutRow]) -> None:
        self.rows.extend(rows)


# ---------------------------------------------------------------------------
# progress status file
# ---------------------------------------------------------------------------


class StatusFile:
    """Throttled atomic progress snapshots; the final ``state: done``
    record survives the process."""

    def __init__(
        self,
        path: str,
        interval_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.path = path
        self.interval_s = interval_s
        self._clock = clock
        self._last = float("-inf")
        self.fields: dict[str, Any] = {
            "state": "starting",
            "pid": os.getpid(),
            "startedUnix": time.time(),
        }

    def update(self, force: bool = False, **fields: Any) -> None:
        self.fields.update(fields)
        now = self._clock()
        if not force and now - self._last < self.interval_s:
            return
        self._last = now
        self.fields["updatedUnix"] = time.time()
        directory = os.path.dirname(os.path.abspath(self.path)) or "."
        try:
            fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp-status-")
            with os.fdopen(fd, "w") as fh:
                json.dump(self.fields, fh)
            os.replace(tmp, self.path)
        except OSError:  # progress evidence must never kill the run
            logger.warning("batchpredict status write failed", exc_info=True)


# ---------------------------------------------------------------------------
# the mega-batch pipeline
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Row:
    lineno: int
    query: Any
    error: str | None = None


@dataclasses.dataclass
class BatchPredictReport:
    """One run's evidence: counts, throughput, and the phase timeline."""

    queries: int = 0
    ok: int = 0
    errors: int = 0
    batches: int = 0
    distinct_users: int = 0
    batch_size: int = 0
    wall_s: float = 0.0
    warmup_s: float = 0.0
    qps: float = 0.0
    users_per_s: float = 0.0
    tiling_ratio: float = 0.0
    phase_p50_ms: dict[str, float] = dataclasses.field(default_factory=dict)
    phase_total_s: dict[str, float] = dataclasses.field(default_factory=dict)
    profile: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def all_failed(self) -> bool:
        return self.queries > 0 and self.ok == 0

    def to_json_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["allFailed"] = self.all_failed
        return d


class _PhaseClock:
    """Times a block into both the profile (tiling contract) and a
    per-phase sample list (per-batch p50s). Double-buffering splits a
    batch's phases across loop iterations, so the sample lists are what
    give per-batch percentiles."""

    def __init__(self, profile: xray.TrainProfile):
        self.profile = profile
        self.samples: dict[str, list[float]] = {p: [] for p in BATCH_PHASES}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        with self.profile.phase(name):
            yield
        self.samples.setdefault(name, []).append(time.perf_counter() - t0)

    def p50_ms(self) -> dict[str, float]:
        return {
            name: round(statistics.median(vals) * 1000.0, 4)
            for name, vals in self.samples.items()
            if vals
        }


def _assemble_batches(
    source: Iterable[tuple[int, Any]],
    engine: Engine,
    batch_size: int,
    clock: _PhaseClock,
    instruments: BatchPredictInstruments,
) -> Iterator[list[_Row]]:
    """read + assemble: pull one mega-batch's queries from the source,
    decode them, yield. A malformed line becomes an errored row (counted),
    never an abort. Phases are timed per batch, not per item: a context
    manager per item would leave its own cost unattributed."""
    it = iter(source)
    done = False
    while not done:
        raw: list[tuple[int, Any]] = []
        with clock.phase(PHASE_READ):
            while len(raw) < batch_size:
                item = next(it, None)
                if item is None:
                    done = True
                    break
                raw.append(item)
        if not raw:
            return
        rows: list[_Row] = []
        with clock.phase(PHASE_ASSEMBLE):
            for lineno, payload in raw:
                instruments.queries.inc()
                try:
                    obj = (
                        json.loads(payload)
                        if isinstance(payload, str)
                        else payload
                    )
                    rows.append(_Row(lineno, engine.decode_query(obj)))
                except Exception as exc:  # noqa: BLE001 - line-aligned error object
                    instruments.errors.inc()
                    rows.append(
                        _Row(lineno, None, error=f"{type(exc).__name__}: {exc}")
                    )
        yield rows


def run_pipeline(
    engine: Engine,
    components: tuple,
    models: list,
    source: Iterable[tuple[int, Any]],
    sinks: list[BatchPredictSink],
    batch_size: int = DEFAULT_MEGA_BATCH,
    instruments: BatchPredictInstruments | None = None,
    status: StatusFile | None = None,
    warmup: bool = True,
) -> BatchPredictReport:
    """Drive the full offline pipeline; returns the run report.

    Double-buffering: iteration N dispatches batch N's device work
    (``predict_batch_dispatch`` returns before the kernels finish), then
    drains batch N-1 (fetch + write) while the card computes N. The
    engines stage each batch's indices in a buffer they reuse and copy it
    to the card synchronously, so batch N's staging cannot change what
    batch N-1's in-flight launch reads."""
    _, _, algorithms, serving = components
    instruments = instruments or BatchPredictInstruments()
    report = BatchPredictReport(batch_size=batch_size)
    profile = xray.TrainProfile(trainer="batchpredict", registry=instruments.registry)
    clock = _PhaseClock(profile)

    t0 = time.perf_counter()
    if warmup:
        # first launches of every batch bucket before the measured window
        for algo, model in zip(algorithms, models):
            algo.warmup_serving(model, batch_size)
    report.warmup_s = round(time.perf_counter() - t0, 4)

    instruments.active.set(1.0)
    if status is not None:
        status.update(force=True, state="running", batchSize=batch_size)

    # distinct users for the users/s field (id strings only)
    users_seen: set[Any] = set()

    def drain(pending: tuple[Callable[[], list] | None, list[_Row]]) -> None:
        fin, rows = pending
        served: list[Any] = []
        batch_error: str | None = None
        if fin is not None:
            with clock.phase(PHASE_FETCH):
                try:
                    served = fin()
                except Exception as exc:  # noqa: BLE001 - batch fails, run survives
                    batch_error = f"{type(exc).__name__}: {exc}"
                    logger.exception("mega-batch finalize failed")
        with clock.phase(PHASE_WRITE):
            out: list[OutRow] = []
            it = iter(served)
            for row in rows:
                if row.error is not None:
                    out.append(
                        OutRow(
                            row.lineno,
                            row.query,
                            {"error": row.error, "line": row.lineno},
                            ok=False,
                        )
                    )
                elif batch_error is not None:
                    instruments.errors.inc()
                    out.append(
                        OutRow(
                            row.lineno,
                            row.query,
                            {"error": batch_error, "line": row.lineno},
                            ok=False,
                        )
                    )
                else:
                    result = Engine.encode_result(next(it))
                    report.ok += 1
                    out.append(OutRow(row.lineno, row.query, result, ok=True))
            for sink in sinks:
                sink.write_batch(out)
                instruments.rows.inc(len(out), sink=sink.name)
        for r in rows:
            if r.query is not None:
                user = getattr(r.query, "user", None)
                if user is None and isinstance(r.query, dict):
                    user = r.query.get("user")
                if user is not None:
                    users_seen.add(user)
        report.queries += len(rows)
        report.errors += sum(1 for r in out if not r.ok)
        report.batches += 1
        instruments.batches.inc()
        profile.add_rows(len(rows))
        if status is not None:
            wall = profile.wall_s
            status.update(
                queries=report.queries,
                ok=report.ok,
                errors=report.errors,
                batches=report.batches,
                qps=round(report.queries / wall, 1) if wall > 0 else 0.0,
            )

    success = False
    try:
        with profile.measure():
            pending: tuple[Callable[[], list] | None, list[_Row]] | None = None
            for rows in _assemble_batches(
                source, engine, batch_size, clock, instruments
            ):
                queries = [r.query for r in rows if r.error is None]
                fin = None
                if queries:
                    with clock.phase(PHASE_DISPATCH):
                        try:
                            fin = engine.dispatch_batch(
                                algorithms, serving, models, queries
                            )
                        except Exception as exc:  # noqa: BLE001
                            logger.exception("mega-batch dispatch failed")
                            err = f"{type(exc).__name__}: {exc}"
                            for r in rows:
                                if r.error is None:
                                    r.error = err
                                    instruments.errors.inc()
                if pending is not None:
                    drain(pending)
                pending = (fin, rows)
            if pending is not None:
                drain(pending)
        success = True
    finally:
        profile.finish()
        instruments.active.set(0.0)
        for sink in sinks:
            if success:
                sink.close(True)  # a failed atomic publish must surface
            else:
                # already unwinding: cleanup must not mask the original
                with contextlib.suppress(Exception):
                    sink.close(False)

    report.wall_s = round(profile.wall_s, 4)
    report.qps = (
        round(report.queries / report.wall_s, 2) if report.wall_s > 0 else 0.0
    )
    report.distinct_users = len(users_seen)
    # distinct users per second: differs from qps when queries repeat a
    # user or carry none
    report.users_per_s = (
        round(report.distinct_users / report.wall_s, 2)
        if report.wall_s > 0
        else 0.0
    )
    report.tiling_ratio = (
        round(profile.attributed_s / profile.wall_s, 4)
        if profile.wall_s > 0
        else 0.0
    )
    report.phase_p50_ms = clock.p50_ms()
    report.phase_total_s = {
        name: round(agg.wall_s, 4) for name, agg in sorted(profile.phases.items())
    }
    report.profile = profile.to_json_dict()
    if status is not None:
        status.update(
            force=True,
            state="done" if success and not report.all_failed else "failed",
            queries=report.queries,
            ok=report.ok,
            errors=report.errors,
            batches=report.batches,
            qps=report.qps,
            phaseP50Ms=report.phase_p50_ms,
            wallS=report.wall_s,
        )
    return report


# ---------------------------------------------------------------------------
# pure core and the file-level entry
# ---------------------------------------------------------------------------


def run_batch_predict_on(
    engine: Engine,
    engine_params: EngineParams,
    models: list,
    queries: Iterable[str],
) -> list[str]:
    """JSON query lines in, JSON prediction lines out, through the
    mega-batch pipeline."""
    components = engine.make_components(engine_params)
    sink = MemorySink()
    source = (
        (i, line)
        for i, line in enumerate(queries, start=1)
        if line.strip()
    )
    run_pipeline(
        engine, components, models, source, [sink], warmup=False
    )
    return [json.dumps(r.result, sort_keys=True) for r in sink.rows]


def run_batch_predict(
    engine_dir: str,
    input_path: str | None = None,
    output_path: str | None = None,
    variant_path: str | None = None,
    storage: Storage | None = None,
    instance_id: str | None = None,
    *,
    device: str = "cuda",
    from_events: bool = False,
    app_name: str = "",
    channel: str = "",
    query_num: int = 10,
    to_events: bool = False,
    event_name: str = DEFAULT_RESULT_EVENT,
    batch_size: int = DEFAULT_MEGA_BATCH,
    limit: int = 0,
    status_path: str | None = None,
    instruments: BatchPredictInstruments | None = None,
) -> BatchPredictReport:
    """File-level entry (ref BatchPredict.run). Sources: ``input_path``
    or ``from_events`` (distinct users off the app's event store). Sinks:
    ``output_path`` (atomic line-aligned JSONL) and/or ``to_events``
    (event-store writeback). The models go onto ``device``. Raises only on
    setup failures; a failing query line is an error row."""
    storage = storage or Storage.instance()
    manifest, engine = load_engine(engine_dir, variant_path)
    instances = storage.get_meta_data_engine_instances()
    instance = (
        instances.get(instance_id)
        if instance_id
        else instances.get_latest_completed(
            manifest.engine_id, manifest.version, manifest.variant
        )
    )
    if instance is None:
        raise RuntimeError("no COMPLETED engine instance; run train first")
    engine_params = engine.engine_params_from_variant(manifest.variant_json)
    ctx = WorkflowContext(mode="serving", device=device, _storage=storage)
    models = load_models_for_instance(engine, engine_params, instance.id, ctx)
    components = engine.make_components(engine_params)

    # --from-events / --to-events need the app; default to the variant's
    # datasource appName so the CLI matches `pio train`'s resolution
    app_id = channel_id = None
    if from_events or to_events:
        app_name = app_name or getattr(
            components[0].params, "app_name", ""
        )
        if not app_name:
            raise RuntimeError(
                "--from-events/--to-events need --app-name (or a datasource "
                "appName in the engine variant)"
            )
        app = storage.get_meta_data_apps().get_by_name(app_name)
        if app is None:
            raise RuntimeError(f"app not found: {app_name}")
        app_id = app.id
        if channel:
            chans = storage.get_meta_data_channels().get_by_app_id(app_id)
            match = [c for c in chans if c.name == channel]
            if not match:
                raise RuntimeError(f"channel not found: {channel}")
            channel_id = match[0].id

    levents = storage.get_l_events() if (from_events or to_events) else None
    if from_events:
        source: Iterable[tuple[int, Any]] = iter_event_users(
            levents, app_id, channel_id, num=query_num, limit=limit
        )
    else:
        if not input_path:
            raise RuntimeError("need an --input query file or --from-events")
        if not os.path.isfile(input_path):
            # checked here: the generator opens the file only on its
            # first pull, and a missing file is a setup error
            raise RuntimeError(f"query file not found: {input_path}")
        source = iter_query_file(input_path)
        if limit:
            source = _take(source, limit)

    instruments = instruments or BatchPredictInstruments()
    sinks: list[BatchPredictSink] = []
    if output_path:
        sinks.append(FileSink(output_path))
    if to_events:
        sinks.append(
            EventStoreSink(
                levents,
                app_id,
                channel_id,
                event_name=event_name,
                model_version=instance.id,
                on_retry=instruments.write_retries.inc,
            )
        )
    if not sinks:
        raise RuntimeError("need an --output file and/or --to-events")

    status = (
        StatusFile(status_path) if status_path else None
    )
    if status is not None:
        status.update(
            force=True,
            engineId=manifest.engine_id,
            instanceId=instance.id,
            source="events" if from_events else (input_path or ""),
            output=output_path or "",
        )
    report = run_pipeline(
        engine,
        components,
        models,
        source,
        sinks,
        batch_size=batch_size,
        instruments=instruments,
        status=status,
    )
    logger.info(
        "batch predict: %d queries (%d ok, %d errors) in %.2fs (%.0f q/s) -> %s",
        report.queries,
        report.ok,
        report.errors,
        report.wall_s,
        report.qps,
        ", ".join(s.name for s in sinks),
    )
    return report


def _take(
    source: Iterable[tuple[int, Any]], limit: int
) -> Iterator[tuple[int, Any]]:
    for n, item in enumerate(source):
        if n >= limit:
            return
        yield item
