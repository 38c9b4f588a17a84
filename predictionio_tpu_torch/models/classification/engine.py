"""Classification engine (DASE components), port of
``predictionio_tpu/models/classification/engine.py``.

Query ``{attr0, attr1, attr2}`` -> ``{"label"}``. The DataSource aggregates
the ``$set`` properties of ``user`` entities that hold the label (``plan``)
and every attribute; algorithms ``naive`` (multinomial naive Bayes) and
``randomforest`` (the add-algorithm variant) train on the host
(``ops.classify``). A query is scored on the host in float64, as in the JAX
package; ``NaiveBayesAlgorithm.batch_predict`` scores a batch on the
model's device. The reading-custom-properties variant
(``custom_properties_engine_factory``) reads ``label`` and
``featureA``..``featureD``. Not ported yet: ``read_eval`` (the k-fold
evaluation folds), which comes with ``pio eval``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np

from predictionio_tpu_torch.controller import (
    BaseDataSource,
    BasePreparator,
    BaseServing,
    Engine,
    LocalAlgorithm,
    Params,
    SanityCheck,
    TorchAlgorithm,
)
from predictionio_tpu_torch.ops.classify import (
    NaiveBayesModel,
    RandomForestModel,
    train_naive_bayes,
    train_random_forest,
)
from predictionio_tpu_torch.workflow.context import WorkflowContext


@dataclasses.dataclass(frozen=True)
class Query:
    attr0: float
    attr1: float
    attr2: float

    @staticmethod
    def from_json_dict(d: dict[str, Any]) -> "Query":
        return Query(float(d["attr0"]), float(d["attr1"]), float(d["attr2"]))

    def to_array(self) -> np.ndarray:
        return np.array([self.attr0, self.attr1, self.attr2], np.float64)


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    label: float

    def to_json_dict(self) -> dict[str, Any]:
        return {"label": self.label}


@dataclasses.dataclass(frozen=True)
class ActualResult:
    label: float


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = ""
    eval_k: int | None = None
    entity_type: str = "user"
    label_property: str = "plan"
    attr_properties: tuple[str, ...] = ("attr0", "attr1", "attr2")


@dataclasses.dataclass
class TrainingData(SanityCheck):
    labels: np.ndarray  # [N]
    features: np.ndarray  # [N, F]

    def sanity_check(self) -> None:
        if len(self.labels) == 0:
            raise ValueError("no labeled entities found; check app data")
        if not np.all(np.isfinite(self.features)):
            raise ValueError("non-finite feature values present")


class DataSource(BaseDataSource):
    params_class = DataSourceParams
    params: DataSourceParams

    def _read_points(self, ctx: WorkflowContext) -> tuple[np.ndarray, np.ndarray]:
        props = ctx.store.aggregate_properties(
            self.params.app_name or ctx.app_name,
            entity_type=self.params.entity_type,
            required=[self.params.label_property, *self.params.attr_properties],
        )
        labels, rows = [], []
        for pm in props.values():
            labels.append(float(pm.get(self.params.label_property)))
            rows.append([float(pm.get(a)) for a in self.params.attr_properties])
        return (
            np.asarray(labels, np.float64),
            np.asarray(rows, np.float64).reshape(len(labels), -1),
        )

    def read_training(self, ctx: WorkflowContext) -> TrainingData:
        labels, features = self._read_points(ctx)
        return TrainingData(labels, features)

    def read_eval(self, ctx: WorkflowContext):
        raise NotImplementedError(
            "classification read_eval (k-fold evaluation folds) is not ported yet; "
            "it comes with pio eval (ROADMAP A9)"
        )


class Preparator(BasePreparator):
    def prepare(self, ctx: WorkflowContext, td: TrainingData) -> TrainingData:
        return td


@dataclasses.dataclass(frozen=True)
class NaiveBayesParams(Params):
    lambda_: float = 1.0


class NaiveBayesAlgorithm(TorchAlgorithm):
    params_class = NaiveBayesParams
    params: NaiveBayesParams

    def train(self, ctx: WorkflowContext, pd: TrainingData) -> NaiveBayesModel:
        model = train_naive_bayes(pd.labels, pd.features, self.params.lambda_)
        model.device = ctx.device
        return model

    def prepare_model(self, ctx: WorkflowContext, persisted: NaiveBayesModel) -> NaiveBayesModel:
        persisted.device = ctx.device
        return persisted

    def predict(self, model: NaiveBayesModel, query) -> PredictedResult:
        return PredictedResult(model.predict(query.to_array()))

    def batch_predict(self, model: NaiveBayesModel, queries):
        """Offline scoring of (index, query) pairs: one device call."""
        if not queries:
            return []
        X = np.stack([q.to_array() for _, q in queries])
        labels = model.predict_batch(X)
        return [(i, PredictedResult(float(lab))) for (i, _), lab in zip(queries, labels)]


@dataclasses.dataclass(frozen=True)
class RandomForestParams(Params):
    num_trees: int = 10
    max_depth: int = 4
    seed: int = 42


class RandomForestAlgorithm(LocalAlgorithm):
    params_class = RandomForestParams
    params: RandomForestParams

    def train(self, ctx: WorkflowContext, pd: TrainingData) -> RandomForestModel:
        return train_random_forest(
            pd.labels, pd.features, num_trees=self.params.num_trees,
            max_depth=self.params.max_depth, seed=self.params.seed,
        )

    def predict(self, model: RandomForestModel, query) -> PredictedResult:
        return PredictedResult(model.predict(query.to_array()))


class Serving(BaseServing):
    def serve(self, query, predictions: Sequence[PredictedResult]) -> PredictedResult:
        return predictions[0]


def engine_factory() -> Engine:
    return Engine(
        DataSource,
        Preparator,
        {"naive": NaiveBayesAlgorithm, "randomforest": RandomForestAlgorithm},
        Serving,
        query_class=Query,
    )


# ---------------------------------------------------------------------------
# reading-custom-properties variant (ref examples/scala-parallel-classification/
# reading-custom-properties/src/main/scala/DataSource.scala:49-66, Engine.scala)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CustomPropertiesQuery:
    """Four named features instead of attr0-2."""

    feature_a: float
    feature_b: float
    feature_c: float
    feature_d: float

    @staticmethod
    def from_json_dict(d: dict[str, Any]) -> "CustomPropertiesQuery":
        return CustomPropertiesQuery(
            float(d["featureA"]), float(d["featureB"]), float(d["featureC"]), float(d["featureD"])
        )

    def to_array(self) -> np.ndarray:
        return np.array([self.feature_a, self.feature_b, self.feature_c, self.feature_d], np.float64)


@dataclasses.dataclass(frozen=True)
class CustomPropertiesDataSourceParams(DataSourceParams):
    label_property: str = "label"
    attr_properties: tuple[str, ...] = ("featureA", "featureB", "featureC", "featureD")


class CustomPropertiesDataSource(DataSource):
    params_class = CustomPropertiesDataSourceParams


def custom_properties_engine_factory() -> Engine:
    return Engine(
        CustomPropertiesDataSource,
        Preparator,
        {"naive": NaiveBayesAlgorithm, "randomforest": RandomForestAlgorithm},
        Serving,
        query_class=CustomPropertiesQuery,
    )
