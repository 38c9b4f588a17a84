"""Fake DASE components with deterministic ids on the port's controller:
the port's copy of ``tests/sample_engine.py`` (ref SampleEngine.scala's
Engine0 family), used by the port's eval, tuning and batch-predict tests.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from predictionio_tpu_torch.controller import (
    BaseAlgorithm,
    BaseDataSource,
    BasePreparator,
    BaseServing,
    Params,
    SanityCheck,
)
from predictionio_tpu_torch.workflow.context import WorkflowContext


@dataclasses.dataclass(frozen=True)
class DSParams(Params):
    id: int = 0
    n_queries: int = 3
    fail_sanity: bool = False


@dataclasses.dataclass(frozen=True)
class AlgoParams(Params):
    id: int = 0


@dataclasses.dataclass(frozen=True)
class TrainingData(SanityCheck):
    ds_id: int
    fail_sanity: bool = False

    def sanity_check(self) -> None:
        if self.fail_sanity:
            raise AssertionError("training data failed sanity check")


@dataclasses.dataclass(frozen=True)
class PreparedData:
    ds_id: int
    prep_id: int


@dataclasses.dataclass(frozen=True)
class Query:
    qid: int


@dataclasses.dataclass(frozen=True)
class Actual:
    qid: int


@dataclasses.dataclass(frozen=True)
class Prediction:
    algo_id: int
    ds_id: int
    prep_id: int
    qid: int
    supplemented: bool = False


class DataSource0(BaseDataSource):
    params_class = DSParams

    def read_training(self, ctx: WorkflowContext) -> TrainingData:
        return TrainingData(self.params.id, self.params.fail_sanity)

    def read_eval(self, ctx: WorkflowContext):
        # two folds, n_queries each
        for fold in range(2):
            td = TrainingData(self.params.id + fold)
            qa = [
                (Query(fold * 100 + i), Actual(fold * 100 + i))
                for i in range(self.params.n_queries)
            ]
            yield td, {"fold": fold}, qa


class Preparator0(BasePreparator):
    params_class = DSParams

    def prepare(self, ctx: WorkflowContext, td: TrainingData) -> PreparedData:
        return PreparedData(td.ds_id, self.params.id)


@dataclasses.dataclass(frozen=True)
class Model0:
    algo_id: int
    ds_id: int
    prep_id: int


class Algo0(BaseAlgorithm):
    params_class = AlgoParams

    def train(self, ctx: WorkflowContext, pd: PreparedData) -> Model0:
        return Model0(self.params.id, pd.ds_id, pd.prep_id)

    def predict(self, model: Model0, query: Query) -> Prediction:
        return Prediction(model.algo_id, model.ds_id, model.prep_id, query.qid)


class Serving0(BaseServing):
    def serve(self, query: Query, predictions: Sequence[Prediction]) -> Prediction:
        return predictions[0]


class ServingSum(BaseServing):
    """Combines multi-algo predictions so tests can see the join."""

    def serve(self, query: Query, predictions: Sequence[Prediction]) -> dict:
        return {
            "qid": query.qid,
            "algo_ids": sorted(p.algo_id for p in predictions),
        }
