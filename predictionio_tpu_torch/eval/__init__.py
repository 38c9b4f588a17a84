"""Evaluation stack: metrics, evaluator, grid search, fast-eval memoization.

Reference parity: ``core/.../controller/Metric.scala``,
``Evaluation.scala``, ``MetricEvaluator.scala``,
``EngineParamsGenerator.scala``, ``FastEvalEngine.scala``.
"""

from predictionio_tpu_torch.eval.metric import (
    AverageMetric,
    Metric,
    OptionAverageMetric,
    OptionStdevMetric,
    StdevMetric,
    SumMetric,
    ZeroMetric,
)
from predictionio_tpu_torch.eval.evaluator import (
    Evaluation,
    MetricEvaluator,
    MetricEvaluatorResult,
)
from predictionio_tpu_torch.eval.generator import EngineParamsGenerator, grid_search
from predictionio_tpu_torch.eval.fast_eval import FastEvalEngine

__all__ = [
    "AverageMetric",
    "EngineParamsGenerator",
    "Evaluation",
    "FastEvalEngine",
    "Metric",
    "MetricEvaluator",
    "MetricEvaluatorResult",
    "OptionAverageMetric",
    "OptionStdevMetric",
    "StdevMetric",
    "SumMetric",
    "ZeroMetric",
    "grid_search",
]
