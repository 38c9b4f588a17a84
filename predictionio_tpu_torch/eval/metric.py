"""Metric base classes.

Reference parity: ``core/.../controller/Metric.scala:39-269`` —
``Metric[EI, Q, P, A, R]`` with a ``compare`` ordering, plus the stock
subclasses ``AverageMetric``, ``OptionAverageMetric`` (None scores excluded),
``StdevMetric``, ``OptionStdevMetric``, ``SumMetric``, ``ZeroMetric``.

``calculate`` receives the evaluation dataset as
``[(EI, [(Q, P, A), ...]), ...]`` — one entry per fold — exactly the shape
``Engine.eval`` produces.
"""

from __future__ import annotations

import math
from typing import Any, Generic, Sequence, TypeVar

EI = TypeVar("EI")
Q = TypeVar("Q")
P = TypeVar("P")
A = TypeVar("A")

EvalDataSet = Sequence[tuple[Any, Sequence[tuple[Any, Any, Any]]]]


class Metric(Generic[EI, Q, P, A]):
    def header(self) -> str:
        return type(self).__name__

    def calculate(self, eval_data_set: EvalDataSet) -> float:
        raise NotImplementedError

    def compare(self, r0: float, r1: float) -> int:
        """Default ordering: bigger is better (ref Metric.scala:56-66)."""
        if r0 == r1:
            return 0
        return 1 if r0 > r1 else -1


class AverageMetric(Metric[EI, Q, P, A]):
    """Mean of per-(q,p,a) scores pooled over all folds."""

    def calculate_score(self, ei: Any, q: Any, p: Any, a: Any) -> float:
        raise NotImplementedError

    def calculate(self, eval_data_set: EvalDataSet) -> float:
        scores = [
            self.calculate_score(ei, q, p, a)
            for ei, qpas in eval_data_set
            for q, p, a in qpas
        ]
        return sum(scores) / len(scores) if scores else float("nan")


class OptionAverageMetric(Metric[EI, Q, P, A]):
    """Mean over scores that are not None (ref OptionAverageMetric)."""

    def calculate_score(self, ei: Any, q: Any, p: Any, a: Any) -> float | None:
        raise NotImplementedError

    def calculate(self, eval_data_set: EvalDataSet) -> float:
        scores = [
            s
            for ei, qpas in eval_data_set
            for q, p, a in qpas
            if (s := self.calculate_score(ei, q, p, a)) is not None
        ]
        return sum(scores) / len(scores) if scores else float("nan")


class StdevMetric(Metric[EI, Q, P, A]):
    """Population standard deviation of scores (ref StdevMetric)."""

    def calculate_score(self, ei: Any, q: Any, p: Any, a: Any) -> float:
        raise NotImplementedError

    def calculate(self, eval_data_set: EvalDataSet) -> float:
        scores = [
            self.calculate_score(ei, q, p, a)
            for ei, qpas in eval_data_set
            for q, p, a in qpas
        ]
        if not scores:
            return float("nan")
        mean = sum(scores) / len(scores)
        return math.sqrt(sum((s - mean) ** 2 for s in scores) / len(scores))


class OptionStdevMetric(Metric[EI, Q, P, A]):
    def calculate_score(self, ei: Any, q: Any, p: Any, a: Any) -> float | None:
        raise NotImplementedError

    def calculate(self, eval_data_set: EvalDataSet) -> float:
        scores = [
            s
            for ei, qpas in eval_data_set
            for q, p, a in qpas
            if (s := self.calculate_score(ei, q, p, a)) is not None
        ]
        if not scores:
            return float("nan")
        mean = sum(scores) / len(scores)
        return math.sqrt(sum((s - mean) ** 2 for s in scores) / len(scores))


class SumMetric(Metric[EI, Q, P, A]):
    def calculate_score(self, ei: Any, q: Any, p: Any, a: Any) -> float:
        raise NotImplementedError

    def calculate(self, eval_data_set: EvalDataSet) -> float:
        return sum(
            self.calculate_score(ei, q, p, a)
            for ei, qpas in eval_data_set
            for q, p, a in qpas
        )


class ZeroMetric(Metric[EI, Q, P, A]):
    """Always 0 — placeholder for secondary metric slots (ref ZeroMetric)."""

    def calculate(self, eval_data_set: EvalDataSet) -> float:
        return 0.0
