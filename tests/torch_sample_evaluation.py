"""A self-contained Evaluation over the port's sample engine: the port's
copy of ``tests/sample_evaluation.py``. The grid runner's process workers
rebuild it by dotted path (``tests.torch_sample_evaluation.make_evaluation``)."""

from __future__ import annotations

from predictionio_tpu_torch.controller import EmptyParams, Engine, EngineParams
from predictionio_tpu_torch.eval import AverageMetric, Evaluation
from tests.torch_sample_engine import (
    Algo0,
    AlgoParams,
    DataSource0,
    DSParams,
    Preparator0,
    Serving0,
)


class AlgoIdMetric(AverageMetric):
    """Score = the prediction's algo id (deterministic, param-sensitive)."""

    def calculate_score(self, ei, q, p, a) -> float:
        return float(p.algo_id)


def sample_params(algo_id: int, n_queries: int = 3) -> EngineParams:
    return EngineParams(
        data_source=("ds", DSParams(id=1, n_queries=n_queries)),
        preparator=("prep", DSParams(id=2)),
        algorithms=[("a", AlgoParams(id=algo_id))],
        serving=("s", EmptyParams()),
    )


def make_evaluation() -> Evaluation:
    return Evaluation(
        engine=Engine(
            {"ds": DataSource0},
            {"prep": Preparator0},
            {"a": Algo0},
            {"s": Serving0},
        ),
        metric=AlgoIdMetric(),
        engine_params_generator=[
            sample_params(3),
            sample_params(9),
            sample_params(5),
        ],
    )


class EnvProbeAlgo(Algo0):
    """Records the worker process's environment + niceness into the file
    named by $GRID_WORKER_PROBE — how the worker-class contract test sees
    inside a spawn-pool worker."""

    def train(self, ctx, pd):
        import json
        import os

        path = os.environ.get("GRID_WORKER_PROBE")
        if path:
            with open(path, "a") as fh:
                fh.write(
                    json.dumps(
                        {
                            "pid": os.getpid(),
                            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
                            "device": str(ctx.device),
                            "nice": os.nice(0),
                        }
                    )
                    + "\n"
                )
        return super().train(ctx, pd)


def make_probe_evaluation() -> Evaluation:
    return Evaluation(
        engine=Engine(
            {"ds": DataSource0},
            {"prep": Preparator0},
            {"a": EnvProbeAlgo},
            {"s": Serving0},
        ),
        metric=AlgoIdMetric(),
        engine_params_generator=[sample_params(3), sample_params(9)],
    )
