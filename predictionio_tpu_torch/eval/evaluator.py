"""Evaluation + MetricEvaluator.

Reference parity: ``core/.../controller/Evaluation.scala:34-125`` (binds an
engine with metrics), ``MetricEvaluator.scala:48-263`` (scores every
EngineParams in the candidate list, tracks the best, writes ``best.json``,
renders one-liner / JSON / HTML results).
"""

from __future__ import annotations

import dataclasses
import html as _html
import json
import logging
import os
from typing import Any, Sequence

from predictionio_tpu_torch.controller.engine import Engine, EngineParams
from predictionio_tpu_torch.eval.generator import EngineParamsGenerator
from predictionio_tpu_torch.eval.metric import Metric
from predictionio_tpu_torch.workflow.context import WorkflowContext

logger = logging.getLogger(__name__)


def _params_json(ep: EngineParams) -> dict[str, Any]:
    """Decoded (non-double-encoded) JSON view of EngineParams."""
    flat = Engine.engine_params_to_json(ep)
    return {k: json.loads(v) for k, v in flat.items()}


@dataclasses.dataclass
class MetricScores:
    engine_params: EngineParams
    score: float
    other_scores: list[float]


@dataclasses.dataclass
class MetricEvaluatorResult:
    best_score: float
    best_engine_params: EngineParams
    best_index: int
    metric_header: str
    other_metric_headers: list[str]
    engine_params_scores: list[MetricScores]

    def one_liner(self) -> str:
        return (
            f"[{self.metric_header}] best: {self.best_score:.6f} "
            f"(params set {self.best_index} of {len(self.engine_params_scores)})"
        )

    def to_json_dict(self) -> dict[str, Any]:
        params_json = _params_json
        return {
            "metricHeader": self.metric_header,
            "otherMetricHeaders": self.other_metric_headers,
            "bestScore": self.best_score,
            "bestIndex": self.best_index,
            "bestEngineParams": params_json(self.best_engine_params),
            "engineParamsScores": [
                {
                    "score": s.score,
                    "otherScores": s.other_scores,
                    "engineParams": params_json(s.engine_params),
                }
                for s in self.engine_params_scores
            ],
        }

    def to_html(self) -> str:
        rows = "".join(
            f"<tr><td>{i}</td><td>{s.score:.6f}</td>"
            f"<td>{', '.join(f'{x:.6f}' for x in s.other_scores)}</td>"
            f"<td><pre>{_html.escape(json.dumps(_params_json(s.engine_params), indent=1))}</pre></td></tr>"
            for i, s in enumerate(self.engine_params_scores)
        )
        return (
            f"<h2>{_html.escape(self.metric_header)}</h2>"
            f"<p>Best score: {self.best_score:.6f} (index {self.best_index})</p>"
            f"<table border=1><tr><th>#</th><th>{_html.escape(self.metric_header)}</th>"
            f"<th>{_html.escape(', '.join(self.other_metric_headers))}</th>"
            f"<th>Engine Params</th></tr>{rows}</table>"
        )


class MetricEvaluator:
    """Scores each candidate EngineParams with the primary metric
    (+ optional secondary metrics); optionally writes best.json
    (ref MetricEvaluator.scala ``outputPath``)."""

    def __init__(
        self,
        metric: Metric,
        other_metrics: Sequence[Metric] = (),
        output_path: str | None = None,
    ):
        self.metric = metric
        self.other_metrics = list(other_metrics)
        self.output_path = output_path

    def evaluate_base(
        self,
        ctx: WorkflowContext,
        engine: Engine,
        engine_params_list: Sequence[EngineParams],
    ) -> MetricEvaluatorResult:
        if not engine_params_list:
            raise ValueError("engine_params_list must not be empty")
        scores: list[MetricScores] = []
        best_idx = 0
        for i, ep in enumerate(engine_params_list):
            logger.info("evaluating engine params %d/%d", i + 1, len(engine_params_list))
            eval_data = engine.eval(ctx, ep)
            score = self.metric.calculate(eval_data)
            others = [m.calculate(eval_data) for m in self.other_metrics]
            logger.info("  %s = %s", self.metric.header(), score)
            scores.append(MetricScores(ep, score, others))
            # NaN guard: compare() uses ordering operators, for which NaN
            # answers False both ways — a NaN score in slot 0 (e.g. a grid
            # point whose folds produced no valid queries) could never be
            # displaced and would be persisted as "best". Any finite score
            # beats NaN; NaN never beats anything.
            best_is_nan = scores[best_idx].score != scores[best_idx].score
            score_is_nan = score != score
            if score_is_nan:
                continue
            if best_is_nan or self.metric.compare(score, scores[best_idx].score) > 0:
                best_idx = i
        result = MetricEvaluatorResult(
            best_score=scores[best_idx].score,
            best_engine_params=scores[best_idx].engine_params,
            best_index=best_idx,
            metric_header=self.metric.header(),
            other_metric_headers=[m.header() for m in self.other_metrics],
            engine_params_scores=scores,
        )
        if self.output_path:
            best = {
                "score": result.best_score,
                "engineParams": _params_json(result.best_engine_params),
            }
            os.makedirs(os.path.dirname(self.output_path) or ".", exist_ok=True)
            with open(self.output_path, "w") as f:
                json.dump(best, f, indent=2, sort_keys=True)
            logger.info("best engine params written to %s", self.output_path)
        return result


class Evaluation:
    """Binds an engine, a candidate params source and a metric
    (ref Evaluation.scala). Subclass and set the class attributes, or pass
    everything to the constructor."""

    engine: Engine | None = None
    metric: Metric | None = None
    other_metrics: Sequence[Metric] = ()
    engine_params_generator: EngineParamsGenerator | Sequence[EngineParams] | None = None
    output_path: str | None = None

    def __init__(
        self,
        engine: Engine | None = None,
        metric: Metric | None = None,
        engine_params_generator=None,
        other_metrics: Sequence[Metric] | None = None,
        output_path: str | None = None,
    ):
        if engine is not None:
            self.engine = engine
        if metric is not None:
            self.metric = metric
        if engine_params_generator is not None:
            self.engine_params_generator = engine_params_generator
        if other_metrics is not None:
            self.other_metrics = other_metrics
        if output_path is not None:
            self.output_path = output_path

    def params_list(self) -> Sequence[EngineParams]:
        gen = self.engine_params_generator
        if gen is None:
            raise ValueError("evaluation has no engine_params_generator")
        if isinstance(gen, EngineParamsGenerator):
            return gen.engine_params_list
        return list(gen)

    def run(self, ctx: WorkflowContext) -> MetricEvaluatorResult:
        if self.engine is None or self.metric is None:
            raise ValueError("evaluation must define engine and metric")
        evaluator = MetricEvaluator(
            self.metric, self.other_metrics, self.output_path
        )
        return evaluator.evaluate_base(ctx, self.engine, self.params_list())
