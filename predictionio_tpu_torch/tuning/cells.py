"""Cell execution: train one (params, fold) cell and score its held-out
queries through the offline mega-batch path (port of
``predictionio_tpu/tuning/cells.py``).

Held-out queries go through :meth:`Engine.dispatch_batch` in fixed
mega-batches, two-slot overlapped (dispatch batch N, then drain batch N-1
while the card computes N, the ``pio batchpredict`` idiom): one launch per
mega-batch, no per-query ``predict`` loop.

Prefix caching: each worker wraps the evaluation's engine in a
:class:`~predictionio_tpu_torch.eval.fast_eval.FastEvalEngine`, so cells
sharing data-source params read their folds once per worker, cells sharing
(data source, preparator) prepare once, and repeated algorithm params reuse
trained models. Between params groups (cells run params-major) the model
cache is cleared to bound worker memory; the data caches survive.

``init_worker`` / ``run_cell`` are the process-pool entry points. A worker
lays its models out on :attr:`GridJob.device`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import json
import os
import sys
import time
from typing import Any, Callable, Sequence

from predictionio_tpu_torch.controller.base import BaseAlgorithm, BaseServing, Doer
from predictionio_tpu_torch.controller.engine import Engine, EngineParams
from predictionio_tpu_torch.eval.fast_eval import FastEvalEngine, _key
from predictionio_tpu_torch.eval.metric import Metric
from predictionio_tpu_torch.obs import xray
from predictionio_tpu_torch.tuning.grid import CellKey, params_json_of
from predictionio_tpu_torch.workflow.context import WorkflowContext

DEFAULT_CELL_BATCH = 512


class FoldRangeError(ValueError):
    """The cell's fold index exceeds what the data source yields — a
    config error (e.g. ``--folds 5`` against a 3-fold read_eval), not a
    data error: it must FAIL THE RUN rather than be ledgered as a
    durable never-retried failed cell."""


def resolve_evaluation(source: Any) -> Any:
    """An Evaluation from a dotted ``module.attr`` path (instance, class,
    or zero-arg factory — the ``pio eval`` contract) or a callable."""
    if isinstance(source, str):
        module_name, _, attr = source.rpartition(".")
        obj = getattr(importlib.import_module(module_name), attr)
    else:
        obj = source
    if isinstance(obj, type) or (callable(obj) and not hasattr(obj, "run")):
        obj = obj()
    return obj


def caching_engine(engine: Engine) -> FastEvalEngine:
    """Wrap (or pass through) the evaluation's engine as a FastEvalEngine
    so the grid gets the stage-memoization caches."""
    if isinstance(engine, FastEvalEngine):
        return engine
    return FastEvalEngine(
        engine.data_source_classes,
        engine.preparator_classes,
        engine.algorithm_classes,
        engine.serving_classes,
        query_class=engine.query_class,
    )


def dispatch_scores(
    engine: Engine,
    algorithms: Sequence[BaseAlgorithm],
    serving: BaseServing,
    models: Sequence[Any],
    queries: Sequence[Any],
    batch_size: int = DEFAULT_CELL_BATCH,
) -> list[Any]:
    """Score ``queries`` in fixed mega-batches through
    ``Engine.dispatch_batch``, two-slot overlapped: batch N's device work
    is dispatched before batch N-1's finalize fetches — the device never
    waits on host-side decode. Returns served results, query-aligned."""
    served: list[Any] = []
    pending: Callable[[], list[Any]] | None = None
    for start in range(0, len(queries), batch_size):
        chunk = queries[start : start + batch_size]
        fin = engine.dispatch_batch(algorithms, serving, models, chunk)
        if pending is not None:
            served.extend(pending())
        pending = fin
    if pending is not None:
        served.extend(pending())
    return served


@dataclasses.dataclass
class GridJob:
    """Picklable bootstrap for a pool worker: how to rebuild the
    evaluation (dotted path or picklable factory), where user modules
    live, and any env the worker's storage selection needs."""

    source: Any
    cwd: str = ""
    env: dict[str, str] = dataclasses.field(default_factory=dict)
    batch_size: int = DEFAULT_CELL_BATCH
    # worker niceness: a background retune must lose every scheduling
    # contest against serving; 0 = inherit
    nice: int = 0
    device: str = "cuda"  # the workers' WorkflowContext device


class CellScorer:
    """Per-worker cell executor: prefix-cached fold data + mega-batch
    scoring. One instance per worker process (or one in-process for
    ``workers=0``)."""

    def __init__(
        self,
        engine: Engine,
        metric: Metric,
        params_list: Sequence[EngineParams],
        other_metrics: Sequence[Metric] = (),
        ctx: WorkflowContext | None = None,
        batch_size: int = DEFAULT_CELL_BATCH,
    ):
        self.engine = caching_engine(engine)
        self.metric = metric
        self.other_metrics = list(other_metrics)
        self.params_list = list(params_list)
        self.ctx = ctx or WorkflowContext(mode="evaluation", device="cuda")
        self.batch_size = batch_size
        self._group_key: str | None = None

    @classmethod
    def from_evaluation(
        cls,
        evaluation: Any,
        ctx: WorkflowContext | None = None,
        batch_size: int = DEFAULT_CELL_BATCH,
    ) -> "CellScorer":
        # getattr, not attribute access: Evaluation-shaped objects without
        # the fields (FakeRun) must get the clean ValueError the CLI
        # routes on, never an AttributeError
        if (
            getattr(evaluation, "engine", None) is None
            or getattr(evaluation, "metric", None) is None
        ):
            raise ValueError("evaluation must define engine and metric")
        return cls(
            evaluation.engine,
            evaluation.metric,
            list(evaluation.params_list()),
            other_metrics=list(evaluation.other_metrics or ()),
            ctx=ctx,
            batch_size=batch_size,
        )

    # ----------------------------------------------------------- caching
    def _maybe_new_group(self, ep: EngineParams) -> None:
        """Bound worker memory: entering a new params group (different
        data_source/preparator/algorithm params) drops cached MODELS;
        the data caches survive so later groups still share the
        read/prepare prefix."""
        group = _key(
            ep.data_source[0],
            ep.data_source[1],
            ep.preparator[0],
            ep.preparator[1],
            [(n, p) for n, p in (ep.algorithms or [("", None)])],
        )
        if self._group_key is not None and group != self._group_key:
            self.engine.clear_caches(keep_data=True)
        self._group_key = group

    def n_folds(self, params_index: int = 0) -> int:
        return len(self.engine._eval_folds(self.ctx, self.params_list[params_index]))

    # ----------------------------------------------------------- scoring
    def score_cell(self, key: CellKey) -> dict[str, Any]:
        """Train + score one cell; returns the ledger record. A failing
        cell returns an ``error`` record (the grid survives; the cell is
        NOT retried on resume — its failure is a durable result)."""
        t0 = time.perf_counter()
        ep = self.params_list[key.params_index]
        record: dict[str, Any] = {
            "cellId": key.cell_id,
            "paramsIndex": key.params_index,
            "fold": key.fold,
            "paramsHash": _cell_params_hash(ep),
            "pid": os.getpid(),
        }
        try:
            self._maybe_new_group(ep)
            profile = xray.TrainProfile(trainer=f"evalgrid:{key.cell_id}")
            with xray.use_profile(profile), profile.measure():
                with xray.phase(xray.PHASE_HOST_ETL):
                    folds = self.engine._eval_folds(self.ctx, ep)
                    if key.fold >= len(folds):
                        raise FoldRangeError(
                            f"fold {key.fold} out of range: data source "
                            f"yields {len(folds)} folds (check --folds)"
                        )
                    _td, ei, qa_list = folds[key.fold]
                    # touch the prepared cache before training so the
                    # prepare stage accounts as host_etl, not solve
                    self.engine._prepared(self.ctx, ep)
                algo_list = ep.algorithms or [("", None)]
                with xray.phase(xray.PHASE_SOLVE):
                    models = [
                        self.engine._trained_model(self.ctx, ep, i, key.fold)
                        for i in range(len(algo_list))
                    ]
                algorithms = [
                    Doer.apply(
                        self.engine._pick(
                            self.engine.algorithm_classes, name, "algorithm"
                        ),
                        p,
                    )
                    for name, p in algo_list
                ]
                serving = Doer.apply(
                    self.engine._pick(
                        self.engine.serving_classes, ep.serving[0], "serving"
                    ),
                    ep.serving[1],
                )
                with xray.phase(xray.PHASE_EVAL):
                    queries = [q for q, _ in qa_list]
                    served = dispatch_scores(
                        self.engine,
                        algorithms,
                        serving,
                        models,
                        queries,
                        self.batch_size,
                    )
                profile.add_rows(len(qa_list))
            profile.finish()
            if len(served) != len(qa_list):
                # a silent zip truncation here would score the cell on a
                # prefix and look healthy
                raise RuntimeError(
                    f"dispatch_batch returned {len(served)} results for "
                    f"{len(qa_list)} held-out queries"
                )
            eval_data = [
                (ei, [(q, p, a) for (q, a), p in zip(qa_list, served)])
            ]
            record.update(
                score=self.metric.calculate(eval_data),
                otherScores=[m.calculate(eval_data) for m in self.other_metrics],
                queries=len(qa_list),
                trainProfile=profile.to_json_dict(),
            )
        except FoldRangeError:
            raise  # config error: fail the run, never the ledger
        except Exception as exc:  # noqa: BLE001 - a failed cell is a result
            record.update(
                score=float("nan"),
                otherScores=[],
                queries=0,
                error=f"{type(exc).__name__}: {exc}",
            )
        record["wallS"] = round(time.perf_counter() - t0, 4)
        return record


def params_hash_of(params: Any) -> str:
    """Canonical sha256 of an engine-params JSON structure (own copy of
    ``predictionio_tpu/registry/manifest.py:params_hash_of``)."""
    canonical = json.dumps(params, sort_keys=True, separators=(",", ":"), default=str)
    return hashlib.sha256(canonical.encode("utf-8")).hexdigest()


def _cell_params_hash(ep: EngineParams) -> str:
    return params_hash_of(params_json_of(ep))


# ---------------------------------------------------------------------------
# process-pool entry points (must be module-level: spawn pickles by name)
# ---------------------------------------------------------------------------

_SCORER: CellScorer | None = None


def init_worker(job: GridJob) -> None:
    """Pool initializer: env first (storage selection and
    ``CUDA_VISIBLE_DEVICES`` must precede any ``Storage.instance()`` and
    CUDA initialisation), then the user's cwd on sys.path (evaluations
    live in engine project dirs), then this worker's scorer on
    ``job.device``."""
    global _SCORER
    if job.nice > 0:
        try:
            os.nice(job.nice)
        except OSError:  # pragma: no cover - privilege-restricted hosts
            pass
    os.environ.update(job.env)
    if job.cwd and job.cwd not in sys.path:
        sys.path.insert(0, job.cwd)
    evaluation = resolve_evaluation(job.source)
    ctx = WorkflowContext(mode="evaluation", device=job.device)
    _SCORER = CellScorer.from_evaluation(evaluation, ctx=ctx, batch_size=job.batch_size)


def run_cell(key: CellKey) -> dict[str, Any]:
    if _SCORER is None:
        raise RuntimeError("worker not initialized (init_worker must run)")
    return _SCORER.score_cell(key)
