"""Batched ranking metrics: precision@k / recall@k / ndcg@k (port of
``predictionio_tpu/tuning/metrics.py``).

These score the *ranked lists* the fused top-k serving path produces (the
``ops/topk`` pack format, decoded by each engine's finalize into
``item_scores``-shaped results) against held-out actuals — the metric
vocabulary a fold×params grid search optimizes. Unlike the per-query
``calculate_score`` metrics in :mod:`predictionio_tpu_torch.eval.metric`, one
``calculate`` call vectorizes the whole evaluation set through numpy: the
hit matrix for every (query, rank) pair is built once and reduced in one
pass — no per-query Python scoring loop on a path that sees one row per
held-out user per cell.

They remain :class:`~predictionio_tpu_torch.eval.metric.Metric` subclasses, so
they drop into ``MetricEvaluator`` and the grid runner interchangeably.
Queries with no actuals are excluded (``OptionAverageMetric`` semantics:
an unratable query must not dilute the mean); an empty evaluation set
scores NaN, which the evaluator's NaN guard keeps out of the best slot.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from predictionio_tpu_torch.eval.metric import EvalDataSet, Metric


def predicted_items(p: Any) -> list[str]:
    """Ranked item ids from a prediction — the decoded pack-format shapes:
    ``item_scores`` tuples (engine dataclasses), ``itemScores`` dicts
    (wire JSON), or a plain id sequence."""
    scores = getattr(p, "item_scores", None)
    if scores is None and isinstance(p, dict):
        scores = p.get("itemScores")
    if scores is None:
        scores = p
    out: list[str] = []
    for s in scores or ():
        item = getattr(s, "item", None)
        if item is None and isinstance(s, dict):
            item = s.get("item")
        out.append(str(s if item is None else item))
    return out


def actual_items(a: Any) -> set[str]:
    """Relevant item ids from an actual: ``ratings`` tuples (the
    recommendation template's ``ActualResult``), dicts, or id iterables."""
    ratings = getattr(a, "ratings", None)
    if ratings is None and isinstance(a, dict):
        ratings = a.get("ratings", a.get("items"))
    if ratings is None:
        ratings = a
    out: set[str] = set()
    for r in ratings or ():
        item = getattr(r, "item", None)
        if item is None and isinstance(r, dict):
            item = r.get("item")
        out.add(str(r if item is None else item))
    return out


class RankingMetric(Metric):
    """Shared batched scaffolding: pool every fold's (q, p, a), build one
    [n_queries, k] boolean hit matrix, reduce in the subclass."""

    def __init__(self, k: int = 10):
        if k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        self.k = k

    def header(self) -> str:
        return f"{type(self).__name__.replace('AtK', '').lower()}@{self.k}"

    def _reduce(self, hits: np.ndarray, n_actuals: np.ndarray) -> float:
        raise NotImplementedError

    def calculate(self, eval_data_set: EvalDataSet) -> float:
        # one flat pass building plain-bool rows, ONE numpy materialization
        # at the end: per-row array allocs dominated this loop at 100k+
        # held-out queries per grid
        pad = [False] * self.k
        hit_rows: list[list[bool]] = []
        n_actuals: list[int] = []
        for _ei, qpas in eval_data_set:
            for _q, p, a in qpas:
                actual = actual_items(a)
                if not actual:
                    continue  # None-actual filtering: unratable query
                ranked = predicted_items(p)[: self.k]
                row = [item in actual for item in ranked]
                if len(row) < self.k:
                    row += pad[len(row) :]
                hit_rows.append(row)
                n_actuals.append(len(actual))
        if not hit_rows:
            return float("nan")
        return float(
            self._reduce(
                np.asarray(hit_rows, dtype=bool),
                np.asarray(n_actuals, dtype=np.float64),
            )
        )


class PrecisionAtK(RankingMetric):
    """Mean fraction of the top-k that is relevant."""

    def _reduce(self, hits: np.ndarray, n_actuals: np.ndarray) -> float:
        return hits.sum(axis=1).mean() / self.k


class RecallAtK(RankingMetric):
    """Mean fraction of each query's relevant set retrieved in the top-k."""

    def _reduce(self, hits: np.ndarray, n_actuals: np.ndarray) -> float:
        return (hits.sum(axis=1) / n_actuals).mean()


class NDCGAtK(RankingMetric):
    """Mean normalized discounted cumulative gain at k (binary gains):
    DCG over the hit matrix with the standard log2 rank discount,
    normalized per query by the ideal DCG of min(|actual|, k) hits."""

    def _reduce(self, hits: np.ndarray, n_actuals: np.ndarray) -> float:
        discounts = 1.0 / np.log2(np.arange(2, self.k + 2, dtype=np.float64))
        dcg = (hits * discounts).sum(axis=1)
        ideal_hits = np.minimum(n_actuals, self.k).astype(np.int64)
        cum_ideal = np.concatenate(([0.0], np.cumsum(discounts)))
        idcg = cum_ideal[ideal_hits]
        return (dcg / np.where(idcg > 0, idcg, 1.0)).mean()


def ranking_eval_set(
    queries: Sequence[Any],
    served: Sequence[Any],
    actuals: Sequence[Any],
    eval_info: Any = None,
) -> EvalDataSet:
    """Zip a scored mega-batch back into the ``Engine.eval`` data-set
    shape the Metric contract consumes (one synthetic fold)."""
    if not (len(queries) == len(served) == len(actuals)):
        raise ValueError(
            f"queries/served/actuals length mismatch: "
            f"{len(queries)}/{len(served)}/{len(actuals)}"
        )
    return [(eval_info, list(zip(queries, served, actuals)))]
