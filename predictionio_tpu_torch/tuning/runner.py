"""The grid runner: schedule cells over workers, persist the ledger, pick
the winner and, asked to, publish its refit to the model registry as a
candidate with the grid's evidence (port of
``predictionio_tpu/tuning/runner.py``).

Flow::

    GridSpec ──build_cells──▶ cells ──minus ledger──▶ pending
        pending ──process pool (or in-process)──▶ CellScorer.score_cell
            each finished cell ──append──▶ ledger.jsonl   (fsync'd)
    all cells ──aggregate per params──▶ winner

Resume: cells are content-addressed (params × fold × data span) and
finished cells live in the JSONL ledger; a killed run restarted with
``resume=True`` retrains exactly the cells with no ledger line. The
scheduler is the only ledger writer: workers return records, the parent
appends.

Parallelism: a ``spawn`` process pool. Each worker initialises CUDA on its
own and loads the kernels from ``build/kernels/`` (the libraries are
published by atomic rename, so concurrent loaders are safe). The
``cpu-fallback`` worker class is asked for by name, never taken on the
code's own: its workers see no card (``CUDA_VISIBLE_DEVICES=""``) and run
on ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import json
import logging
import math
import os
import time
from concurrent.futures import FIRST_COMPLETED, ProcessPoolExecutor, wait
from typing import Any, Sequence

import torch

from predictionio_tpu_torch.controller.engine import EngineParams
from predictionio_tpu_torch.eval.evaluator import MetricEvaluatorResult, MetricScores
from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.tuning.cells import (
    DEFAULT_CELL_BATCH,
    CellScorer,
    GridJob,
    init_worker,
    resolve_evaluation,
    run_cell,
)
from predictionio_tpu_torch.tuning.grid import CellKey, GridSpec, build_cells
from predictionio_tpu_torch.tuning.ledger import TrialLedger
from predictionio_tpu_torch.workflow.context import WorkflowContext

logger = logging.getLogger(__name__)

LEDGER_NAME = "ledger.jsonl"

# the JAX package's fleet replica class of the same name
WORKER_CLASS_CPU_FALLBACK = "cpu-fallback"
# a cpu-fallback grid is a background citizen: bounded worker count so a
# wide grid can't starve the serving host of cores
CPU_FALLBACK_MAX_WORKERS = 4


def grid_worker_env(
    worker_class: str, env: dict[str, str] | None = None
) -> dict[str, str]:
    """The env grid workers boot with for a worker class. The cpu-fallback
    class hides every card (``CUDA_VISIBLE_DEVICES=""``; an explicit
    caller value wins), so a background retune never initialises CUDA out
    from under the serving path; :func:`worker_device` pairs it with
    ``device="cpu"``."""
    merged = dict(env or {})
    if worker_class == WORKER_CLASS_CPU_FALLBACK:
        merged.setdefault("CUDA_VISIBLE_DEVICES", "")
    return merged


def worker_device(worker_class: str, device: Any) -> str:
    """The device a grid worker's WorkflowContext gets: ``cpu`` for the
    cpu-fallback class, else the caller's (``cuda`` by default)."""
    if worker_class == WORKER_CLASS_CPU_FALLBACK:
        return "cpu"
    return str(torch.device(device)) if device is not None else "cuda"


# ---------------------------------------------------------------------------
# instruments
# ---------------------------------------------------------------------------


def register_eval_metrics(registry: MetricsRegistry) -> dict[str, Any]:
    """Get-or-create the ``pio_eval_*`` family (idempotent)."""
    return {
        "cells": registry.counter(
            "pio_eval_cells_total",
            "grid cells finished this run (scored or failed)",
        ),
        "failed": registry.counter(
            "pio_eval_cells_failed_total",
            "grid cells whose train/score raised (recorded in the ledger "
            "as NaN-scored error cells; never retried on resume)",
        ),
        "skipped": registry.counter(
            "pio_eval_cells_skipped_total",
            "cells skipped on resume because the ledger already holds them",
        ),
        "queries": registry.counter(
            "pio_eval_queries_total",
            "held-out queries scored through the mega-batch path",
        ),
        "active": registry.gauge(
            "pio_eval_active", "1 while an evaluation grid run is executing"
        ),
        "workers": registry.gauge(
            "pio_eval_workers", "parallel cell workers of the active run"
        ),
        "best_score": registry.gauge(
            "pio_eval_best_score",
            "best per-params aggregate score seen so far (primary metric)",
        ),
    }


class EvalGridInstruments:
    """Counter bundle for one grid run (own registry by default)."""

    def __init__(self, registry: MetricsRegistry | None = None):
        self.registry = registry or MetricsRegistry()
        m = register_eval_metrics(self.registry)
        self.cells = m["cells"]
        self.failed = m["failed"]
        self.skipped = m["skipped"]
        self.queries = m["queries"]
        self.active = m["active"]
        self.workers = m["workers"]
        self.best_score = m["best_score"]


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ParamsScore:
    """One engine-params' aggregate over its folds."""

    params_index: int
    score: float  # query-weighted mean over finite fold scores
    fold_scores: list[float]
    other_scores: list[float]
    queries: int
    failed_cells: int


def params_score_of(
    recs: Sequence[dict[str, Any]], params_index: int
) -> ParamsScore:
    """One params' aggregate from its (finished) fold records.

    Fold scores combine by a held-out-query-count-weighted mean. For
    per-query-average metrics where every query counts, that EQUALS the
    pooled calculate over the concatenated folds; for metrics that skip
    queries (Option*/ranking metrics with unratable actuals) or pool
    non-linearly (stdev) it is an approximation — the fold weights are
    the folds' total held-out queries, not the metric's internal counts,
    which a per-fold scalar cannot recover. Exact-pooled scoring remains
    available via the sequential ``MetricEvaluator``. NaN/failed cells
    are excluded from the mean but counted; an all-NaN params aggregates
    to NaN (the evaluator's NaN guard keeps it from winning)."""
    recs = sorted(recs, key=lambda r: r.get("fold", 0))
    fold_scores = [float(r.get("score", float("nan"))) for r in recs]
    weights = [max(1, int(r.get("queries", 0) or 0)) for r in recs]
    finite = [
        (s, w) for s, w in zip(fold_scores, weights) if not math.isnan(s)
    ]
    if finite:
        total_w = sum(w for _, w in finite)
        score = sum(s * w for s, w in finite) / total_w
    else:
        score = float("nan")
    n_other = max((len(r.get("otherScores", [])) for r in recs), default=0)
    other: list[float] = []
    for j in range(n_other):
        vals = [
            (float(r["otherScores"][j]), w)
            for r, w in zip(recs, weights)
            if len(r.get("otherScores", [])) > j
            and not math.isnan(float(r["otherScores"][j]))
        ]
        other.append(
            sum(s * w for s, w in vals) / sum(w for _, w in vals)
            if vals
            else float("nan")
        )
    return ParamsScore(
        params_index=params_index,
        score=score,
        fold_scores=fold_scores,
        other_scores=other,
        queries=sum(int(r.get("queries", 0) or 0) for r in recs),
        failed_cells=sum(1 for r in recs if r.get("error")),
    )


def aggregate_params(
    records: dict[str, dict[str, Any]],
    cells: Sequence[CellKey],
    n_params: int,
) -> list[ParamsScore]:
    """Fold cell records up to per-params scores (see
    :func:`params_score_of` for the weighting semantics)."""
    by_params: dict[int, list[dict[str, Any]]] = {i: [] for i in range(n_params)}
    for key in cells:
        rec = records.get(key.cell_id)
        if rec is not None:
            by_params[key.params_index].append(rec)
    return [params_score_of(by_params[pi], pi) for pi in range(n_params)]


def pick_best(scores: list[ParamsScore], metric) -> int:
    """Best params index under the metric's ordering. NaN never wins;
    ties keep the FIRST-seen index (strict compare > 0 to displace), so
    the winner is stable across runs and resumes."""
    best = 0
    for i in range(1, len(scores)):
        best_nan = math.isnan(scores[best].score)
        cur = scores[i].score
        if math.isnan(cur):
            continue
        if best_nan or metric.compare(cur, scores[best].score) > 0:
            best = i
    return best


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GridReport:
    """One grid run's evidence — the JSON ``pio eval --out`` writes and
    the programmatic return value."""

    metric: str = ""
    other_metrics: list[str] = dataclasses.field(default_factory=list)
    folds: int = 0
    cells_total: int = 0
    cells_run: int = 0
    cells_skipped: int = 0
    cells_failed: int = 0
    best_params_index: int = 0
    best_score: float = float("nan")
    scores: list[dict[str, Any]] = dataclasses.field(default_factory=list)
    ledger_path: str = ""
    ledger_sha256: str = ""
    wall_s: float = 0.0
    cells_per_hour: float = 0.0
    workers: int = 0
    engine_id: str = ""
    published_version: str = ""
    evaluator_result: MetricEvaluatorResult | None = None

    def to_json_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d.pop("evaluator_result", None)
        return d

    def one_liner(self) -> str:
        return (
            f"[{self.metric}] best: {self.best_score:.6f} "
            f"(params set {self.best_params_index} of {len(self.scores)}; "
            f"{self.cells_total} cells = {len(self.scores)} params x "
            f"{self.folds} folds, {self.cells_skipped} resumed, "
            f"{self.cells_failed} failed)"
        )


def grid_evidence(report: GridReport, records: dict[str, dict[str, Any]]) -> dict:
    """The eval-evidence block the winner's manifest carries: scores
    table, fold layout, metric, and the ledger's content hash as the
    integrity anchor."""
    return {
        "metric": report.metric,
        "otherMetrics": report.other_metrics,
        "folds": report.folds,
        "cellsTotal": report.cells_total,
        "cellsFailed": report.cells_failed,
        "bestParamsIndex": report.best_params_index,
        "bestScore": report.best_score,
        "scoresTable": report.scores,
        "ledgerSha256": report.ledger_sha256,
        "gridWallS": report.wall_s,
        "workers": report.workers,
        "cells": [
            {
                "cellId": r["cellId"],
                "paramsIndex": r.get("paramsIndex"),
                "fold": r.get("fold"),
                "score": r.get("score"),
                "queries": r.get("queries"),
                "wallS": r.get("wallS"),
                **({"error": r["error"]} if r.get("error") else {}),
            }
            for r in sorted(records.values(), key=lambda r: (r.get("paramsIndex", 0), r.get("fold", 0)))
        ],
        "evaluatedAt": _dt.datetime.now(tz=_dt.timezone.utc).isoformat(),
    }


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------


def run_grid(
    source: Any,
    *,
    workdir: str,
    workers: int = 0,
    folds: int | None = None,
    resume: bool = False,
    batch_size: int = DEFAULT_CELL_BATCH,
    data_span: dict[str, Any] | None = None,
    publish: bool = False,
    registry_dir: str | None = None,
    engine_manifest: Any = None,
    stage_mode: str = "canary",
    stage_fraction: float = 0.1,
    keep_versions: int = 5,
    status_path: str | None = None,
    instruments: EvalGridInstruments | None = None,
    cwd: str = "",
    env: dict[str, str] | None = None,
    nice: int = 0,
    worker_class: str = "",
    ctx: Any = None,
    device: str = "cuda",
    evaluation: Any = None,
    on_validated: Any = None,
) -> GridReport:
    """Run (or resume) one evaluation grid end to end.

    ``source`` is a dotted ``module.attr`` path to an Evaluation (the
    ``pio eval`` contract), a picklable zero-arg factory, or — with
    ``workers=0`` only — a live Evaluation instance (process workers must
    rebuild it by name). A caller that already resolved the source may
    pass the instance via ``evaluation`` to skip re-construction.
    ``publish=True`` refits the winning params on the full training data
    and ships it to the registry as a CANDIDATE carrying the grid
    evidence; it requires ``engine_manifest`` (the engine identity) and a
    registry dir (``registry_dir`` or ``$PIO_REGISTRY_DIR``). ``on_validated`` (zero-arg) fires after
    every argument/ledger validation passed, just before cells start —
    the hook bookkeeping callers use to avoid recording runs that never
    validated.

    ``nice`` > 0 re-nices every pool worker (a background retune must
    lose scheduling contests against serving); ``worker_class`` names the
    class the workers run as: cpu-fallback hides every card from them, runs
    them (and an in-process grid) on ``device="cpu"`` and bounds
    ``workers`` at :data:`CPU_FALLBACK_MAX_WORKERS`. Otherwise cells run on
    ``device`` (``ctx.device`` when a ``ctx`` is given).
    """
    from predictionio_tpu_torch.workflow.batch_predict import StatusFile

    evaluation = evaluation if evaluation is not None else resolve_evaluation(source)
    device = worker_device(worker_class, ctx.device if ctx is not None else device)
    if ctx is None or str(ctx.device) != device:
        ctx = WorkflowContext(
            mode="evaluation",
            device=device,
            _storage=getattr(ctx, "_storage", None),
            batch=getattr(ctx, "batch", ""),
        )
    scorer = CellScorer.from_evaluation(evaluation, ctx=ctx, batch_size=batch_size)
    params_list: list[EngineParams] = scorer.params_list
    metric = scorer.metric
    if workers < 0:
        raise ValueError(f"workers must be >= 0, got {workers}")
    if nice < 0:
        raise ValueError(f"nice must be >= 0 (priority only drops), got {nice}")
    env = grid_worker_env(worker_class, env)
    if (
        worker_class == WORKER_CLASS_CPU_FALLBACK
        and workers > CPU_FALLBACK_MAX_WORKERS
    ):
        logger.info(
            "cpu-fallback grid: clamping workers %d -> %d",
            workers,
            CPU_FALLBACK_MAX_WORKERS,
        )
        workers = CPU_FALLBACK_MAX_WORKERS
    if workers > 0 and not (
        isinstance(source, str) or (callable(source) and not hasattr(source, "run"))
    ):
        raise ValueError(
            "process workers rebuild the evaluation by name: pass a dotted "
            "path or a picklable factory as source (got a live instance); "
            "use workers=0 for in-process scoring"
        )
    if publish:
        if engine_manifest is None:
            raise ValueError(
                "publish needs the engine identity (engine_manifest) — pass --engine-dir to `eval`"
            )
        registry_dir = registry_dir or os.environ.get("PIO_REGISTRY_DIR")
        if not registry_dir:
            raise ValueError("publish needs a registry dir (--registry-dir or $PIO_REGISTRY_DIR)")

    # fold count: explicit, or probed ONCE from the data source (the
    # probe's read stays warm in the parent's cache and is reused when
    # workers=0)
    n_folds = folds if folds is not None else scorer.n_folds()
    if n_folds <= 0:
        raise ValueError("data source yielded zero eval folds")
    spec = GridSpec(params_list, folds=n_folds, data_span=data_span or {})
    cells = build_cells(spec, n_folds)

    os.makedirs(workdir, exist_ok=True)
    ledger = TrialLedger(os.path.join(workdir, LEDGER_NAME))
    if os.path.exists(ledger.path) and not resume:
        raise ValueError(
            f"workdir already holds a trial ledger ({ledger.path}); pass "
            "resume=True (--resume) to continue it or use a fresh workdir"
        )
    finished = ledger.load() if resume else {}
    known = {c.cell_id for c in cells}
    stale = set(finished) - known
    if stale:
        # content addressing at work: a ledger from a different grid
        # (other params/folds/span) can share the workdir without being
        # trusted — its cells simply don't match
        logger.warning(
            "ledger holds %d cell(s) not in this grid (different "
            "params/folds/data span); ignoring them",
            len(stale),
        )
    pending = [c for c in cells if c.cell_id not in finished]
    skipped = len(cells) - len(pending)

    if on_validated is not None:
        on_validated()
    instruments = instruments or EvalGridInstruments()
    instruments.skipped.inc(skipped)
    instruments.workers.set(float(workers))
    status = StatusFile(status_path) if status_path else None
    records: dict[str, dict[str, Any]] = {
        cid: rec for cid, rec in finished.items() if cid in known
    }
    report = GridReport(
        metric=metric.header(),
        other_metrics=[m.header() for m in scorer.other_metrics],
        folds=n_folds,
        cells_total=len(cells),
        cells_skipped=skipped,
        workers=workers,
        ledger_path=ledger.path,
    )

    # incremental per-params aggregation: a finished cell re-scores ONLY
    # its own params set (O(folds)), and best-so-far is a pick over the
    # cached per-params scores (O(params)) — re-aggregating the whole
    # grid per cell made parent bookkeeping O(cells²)
    recs_by_params: dict[int, list[dict[str, Any]]] = {
        i: [] for i in range(len(params_list))
    }
    for key in cells:
        rec = records.get(key.cell_id)
        if rec is not None:
            recs_by_params[key.params_index].append(rec)
    agg_cache: list[ParamsScore] = [
        params_score_of(recs_by_params[i], i) for i in range(len(params_list))
    ]

    def best_so_far() -> tuple[int, float]:
        bi = pick_best(agg_cache, metric)
        return bi, agg_cache[bi].score

    cell_walls: list[float] = []

    def push_status(state: str, running: int = 0, force: bool = False) -> None:
        if status is None:
            return
        done = len(records)
        eta = (
            round((len(cells) - done) * (sum(cell_walls) / len(cell_walls))
                  / max(1, workers or 1), 1)
            if cell_walls and done < len(cells)
            else 0.0
        )
        bi, bs = best_so_far() if records else (0, float("nan"))
        status.update(
            force=force,
            state=state,
            cellsDone=done,
            cellsTotal=len(cells),
            cellsSkipped=skipped,
            cellsFailed=report.cells_failed,
            running=running,
            workers=workers,
            bestScore=None if math.isnan(bs) else bs,
            bestParams=bi,
            metric=report.metric,
            folds=n_folds,
            etaS=eta,
        )

    def take(rec: dict[str, Any]) -> None:
        records[rec["cellId"]] = rec
        ledger.append(rec)
        pi = int(rec.get("paramsIndex", 0))
        recs_by_params[pi].append(rec)
        agg_cache[pi] = params_score_of(recs_by_params[pi], pi)
        cell_walls.append(float(rec.get("wallS", 0.0)))
        report.cells_run += 1
        instruments.cells.inc()
        instruments.queries.inc(int(rec.get("queries", 0) or 0))
        if rec.get("error"):
            report.cells_failed += 1
            instruments.failed.inc()
            logger.warning(
                "cell %s (params %s, fold %s) failed: %s",
                rec["cellId"],
                rec.get("paramsIndex"),
                rec.get("fold"),
                rec["error"],
            )
        _, bs = best_so_far()
        if not math.isnan(bs):
            instruments.best_score.set(bs)

    t0 = time.perf_counter()
    instruments.active.set(1.0)
    push_status("running", force=True)
    try:
        with ledger:
            if workers == 0:
                for key in pending:
                    take(scorer.score_cell(key))
                    push_status("running")
            else:
                import multiprocessing

                job = GridJob(
                    source=source,
                    cwd=cwd,
                    env=dict(env or {}),
                    batch_size=batch_size,
                    nice=nice,
                    device=device,
                )
                # spawn, never fork: a parent that initialised CUDA
                # cannot fork
                mp_ctx = multiprocessing.get_context("spawn")
                with ProcessPoolExecutor(
                    max_workers=workers,
                    mp_context=mp_ctx,
                    initializer=init_worker,
                    initargs=(job,),
                ) as pool:
                    # params-major submission order is preserved by the
                    # pool, so each worker sees params groups mostly
                    # adjacently and its model-cache clearing bounds memory
                    futures = {pool.submit(run_cell, key): key for key in pending}
                    not_done = set(futures)
                    while not_done:
                        done, not_done = wait(
                            not_done, timeout=1.0, return_when=FIRST_COMPLETED
                        )
                        for fut in done:
                            take(fut.result())
                        push_status("running", running=len(not_done))
        report.wall_s = round(time.perf_counter() - t0, 4)
        report.ledger_sha256 = ledger.sha256()

        missing = [c for c in cells if c.cell_id not in records]
        if missing:
            raise RuntimeError(
                f"{len(missing)} cell(s) never produced a record "
                "(scheduler bug or worker pool died)"
            )
        agg = aggregate_params(records, cells, len(params_list))
        best = pick_best(agg, metric)
        report.best_params_index = best
        report.best_score = agg[best].score
        report.scores = [
            {
                "paramsIndex": s.params_index,
                "score": s.score,
                "foldScores": s.fold_scores,
                "otherScores": s.other_scores,
                "queries": s.queries,
                "failedCells": s.failed_cells,
            }
            for s in agg
        ]
        report.cells_per_hour = (
            round(report.cells_run / (report.wall_s / 3600.0), 1)
            if report.wall_s > 0 and report.cells_run
            else 0.0
        )
        report.evaluator_result = MetricEvaluatorResult(
            best_score=report.best_score,
            best_engine_params=params_list[best],
            best_index=best,
            metric_header=report.metric,
            other_metric_headers=report.other_metrics,
            engine_params_scores=[
                MetricScores(params_list[s.params_index], s.score, s.other_scores)
                for s in agg
            ],
        )
        if not math.isnan(report.best_score):
            instruments.best_score.set(report.best_score)
        # reference parity (MetricEvaluator.scala outputPath): an
        # Evaluation carrying output_path still gets its best-params JSON
        # — downstream scripts consume this file
        output_path = getattr(evaluation, "output_path", None)
        if output_path:
            from predictionio_tpu_torch.eval.evaluator import _params_json

            os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
            with open(output_path, "w") as fh:
                json.dump(
                    {
                        "score": report.best_score,
                        "engineParams": _params_json(params_list[best]),
                    },
                    fh,
                    indent=2,
                    sort_keys=True,
                )
            logger.info("best engine params written to %s", output_path)

        if publish:
            if math.isnan(report.best_score):
                logger.warning("every params aggregated to NaN — refusing to publish a degenerate winner")
            else:
                report.published_version = _publish_winner(
                    evaluation,
                    params_list[best],
                    engine_manifest,
                    registry_dir,
                    grid_evidence(report, records),
                    ctx=ctx,
                    stage_mode=stage_mode,
                    stage_fraction=stage_fraction,
                    keep_versions=keep_versions,
                )
        push_status("done", force=True)
        return report
    except BaseException:
        report.wall_s = round(time.perf_counter() - t0, 4)
        push_status("failed", force=True)
        raise
    finally:
        instruments.active.set(0.0)
        instruments.workers.set(0.0)


def _publish_winner(
    evaluation: Any,
    winner: EngineParams,
    engine_manifest: Any,
    registry_dir: str,
    evidence: dict[str, Any],
    *,
    ctx: WorkflowContext,
    stage_mode: str = "canary",
    stage_fraction: float = 0.1,
    keep_versions: int = 5,
) -> str:
    """Refit the winning params on the FULL training data through
    ``run_train`` (the metadata ledger and the registry publish every
    trained version takes), attach the grid evidence to its manifest and
    stage it, so the bake gates (or an operator) decide promotion."""
    from predictionio_tpu_torch.registry import ArtifactStore
    from predictionio_tpu_torch.workflow.core_workflow import run_train

    train_ctx = WorkflowContext(
        mode="training", device=ctx.device, _storage=ctx._storage, batch="evalgrid"
    )
    instance_id = run_train(
        evaluation.engine,
        engine_manifest,
        winner,
        train_ctx,
        batch="evalgrid",
        registry_dir=registry_dir,
        keep_versions=keep_versions,
    )
    store = ArtifactStore(registry_dir)
    engine_id = engine_manifest.engine_id
    published = [m for m in store.list_versions(engine_id) if m.instance_id == instance_id]
    if not published:
        raise RuntimeError(
            f"winner refit trained (instance {instance_id}) but never reached the registry — "
            "publish failed, metadata store remains authoritative"
        )
    version = published[-1].version
    store.attach_eval_evidence(engine_id, version, evidence)
    state = store.get_state(engine_id)
    if state.stable and state.stable != version:
        store.stage_candidate(engine_id, version, mode=stage_mode, fraction=stage_fraction)
        logger.info("grid winner %s staged as %s candidate (fraction %g)", version, stage_mode, stage_fraction)
    else:
        logger.info("grid winner %s is the first stable version", version)
    return version
