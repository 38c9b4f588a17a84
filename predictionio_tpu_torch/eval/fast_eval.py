"""FastEvalEngine — grid-search memoization by parameter prefix.

Reference parity: ``core/.../controller/FastEvalEngine.scala:46-346`` —
during grid search, candidate EngineParams often share a prefix
(same datasource -> same folds; same datasource+preparator -> same prepared
data; same +algorithm params -> same trained models). The reference caches
each pipeline stage keyed by its param prefix; this does the same with
plain dicts keyed on params JSON.
"""

from __future__ import annotations

import json
import logging
from typing import Any, Sequence

from predictionio_tpu_torch.controller.base import BaseDataSource, BasePreparator, Doer
from predictionio_tpu_torch.controller.engine import Engine, EngineParams
from predictionio_tpu_torch.workflow.context import WorkflowContext

logger = logging.getLogger(__name__)


def _key(*parts: Any) -> str:
    def enc(p):
        if p is None:
            return "null"
        if hasattr(p, "to_json"):
            return p.to_json()
        return json.dumps(p, sort_keys=True, default=str)

    return "|".join(enc(p) for p in parts)


class FastEvalEngine(Engine):
    """Drop-in Engine whose ``eval`` memoizes shared stages across calls.

    Use with MetricEvaluator over a params grid: data is read once per
    distinct datasource params, prepared once per (ds, prep) pair, and each
    algorithm is trained once per (ds, prep, algo-params, fold) tuple.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._eval_data_cache: dict[str, list] = {}
        self._prepared_cache: dict[str, list] = {}
        self._model_cache: dict[str, Any] = {}
        # hit/miss accounting per stage — the evaluation grid's tests
        # assert its prefix sharing on these, and
        # they make "did the cache actually help" a measurable question
        self.cache_stats: dict[str, int] = {
            "read_hits": 0,
            "read_misses": 0,
            "prepare_hits": 0,
            "prepare_misses": 0,
            "train_hits": 0,
            "train_misses": 0,
            "model_clears": 0,
        }

    def clear_caches(self, keep_data: bool = False) -> None:
        """Drop memoized stages. ``keep_data=True`` clears only the model
        cache — the grid scheduler calls this between params groups to
        bound worker memory (trained models are the big objects) while
        cells in later groups still share the data_source/preparator
        prefix reads."""
        if not keep_data:
            self._eval_data_cache.clear()
            self._prepared_cache.clear()
        if self._model_cache:
            self.cache_stats["model_clears"] += 1
        self._model_cache.clear()

    def _eval_folds(self, ctx: WorkflowContext, ep: EngineParams) -> list:
        key = _key("ds", ep.data_source[0], ep.data_source[1])
        if key not in self._eval_data_cache:
            self.cache_stats["read_misses"] += 1
            ds: BaseDataSource = Doer.apply(
                self._pick(self.data_source_classes, ep.data_source[0], "datasource"),
                ep.data_source[1],
            )
            self._eval_data_cache[key] = [
                (td, ei, list(qa)) for td, ei, qa in ds.read_eval(ctx)
            ]
            logger.debug("fast-eval: read_eval MISS %s", key[:80])
        else:
            self.cache_stats["read_hits"] += 1
        return self._eval_data_cache[key]

    def _prepared(self, ctx: WorkflowContext, ep: EngineParams) -> list:
        key = _key(
            "prep", ep.data_source[0], ep.data_source[1], ep.preparator[0], ep.preparator[1]
        )
        if key not in self._prepared_cache:
            self.cache_stats["prepare_misses"] += 1
            prep: BasePreparator = Doer.apply(
                self._pick(self.preparator_classes, ep.preparator[0], "preparator"),
                ep.preparator[1],
            )
            folds = self._eval_folds(ctx, ep)
            self._prepared_cache[key] = [prep.prepare(ctx, td) for td, _, _ in folds]
        else:
            self.cache_stats["prepare_hits"] += 1
        return self._prepared_cache[key]

    def _trained_model(
        self, ctx: WorkflowContext, ep: EngineParams, algo_idx: int, fold_idx: int
    ):
        name, params = (ep.algorithms or [("", None)])[algo_idx]
        key = _key(
            "model",
            ep.data_source[0],
            ep.data_source[1],
            ep.preparator[0],
            ep.preparator[1],
            name,
            params,
            fold_idx,
        )
        if key not in self._model_cache:
            self.cache_stats["train_misses"] += 1
            algo = Doer.apply(
                self._pick(self.algorithm_classes, name, "algorithm"), params
            )
            pd = self._prepared(ctx, ep)[fold_idx]
            self._model_cache[key] = algo.train(ctx, pd)
        else:
            self.cache_stats["train_hits"] += 1
        return self._model_cache[key]

    def eval(
        self, ctx: WorkflowContext, engine_params: EngineParams
    ) -> list[tuple[Any, list[tuple[Any, Any, Any]]]]:
        folds = self._eval_folds(ctx, engine_params)
        algo_list = engine_params.algorithms or [("", None)]
        algorithms = [
            Doer.apply(self._pick(self.algorithm_classes, name, "algorithm"), p)
            for name, p in algo_list
        ]
        serving = Doer.apply(
            self._pick(self.serving_classes, engine_params.serving[0], "serving"),
            engine_params.serving[1],
        )
        results = []
        for fold_idx, (td, ei, qa_list) in enumerate(folds):
            models = [
                self._trained_model(ctx, engine_params, i, fold_idx)
                for i in range(len(algorithms))
            ]
            supplemented = [
                (i, serving.supplement(q)) for i, (q, _) in enumerate(qa_list)
            ]
            per_query: list[list] = [[] for _ in qa_list]
            for algo, model in zip(algorithms, models):
                for i, p in algo.batch_predict(model, supplemented):
                    per_query[i].append(p)
            joined = [
                (qa_list[i][0], serving.serve(qa_list[i][0], preds), qa_list[i][1])
                for i, preds in enumerate(per_query)
            ]
            results.append((ei, joined))
        return results
