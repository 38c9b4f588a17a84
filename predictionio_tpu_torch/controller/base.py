"""DASE base classes and the component-instantiation Doer (port of
``predictionio_tpu/controller/base.py``).

Type parameters follow ``Engine[TD, EI, PD, Q, P, A]``: TD = training data,
EI = evaluation info, PD = prepared data, Q = query, P = predicted result,
A = actual result.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Generic, Sequence, TypeVar

from predictionio_tpu_torch.controller.params import EmptyParams, Params
from predictionio_tpu_torch.workflow.context import WorkflowContext

TD = TypeVar("TD")
EI = TypeVar("EI")
PD = TypeVar("PD")
Q = TypeVar("Q")
P = TypeVar("P")
A = TypeVar("A")
M = TypeVar("M")  # model


class SanityCheck:
    """Optional mixin for TD/PD/model types: ``sanity_check`` runs after
    each train stage unless skipped."""

    def sanity_check(self) -> None:
        raise NotImplementedError


class Doer:
    """Instantiate a DASE component class with its Params (ctor(params),
    or no-arg when the constructor takes none)."""

    @staticmethod
    def apply(cls: type, params: Params | None = None) -> Any:
        params = params if params is not None else EmptyParams()
        try:
            takes_params = len(inspect.signature(cls.__init__).parameters) > 1
        except (TypeError, ValueError):
            takes_params = False
        return cls(params) if takes_params else cls()


class _Component:
    params: Params

    def __init__(self, params: Params | None = None):
        self.params = params if params is not None else EmptyParams()


class BaseDataSource(_Component, Generic[TD, EI, Q, A]):
    def read_training(self, ctx: WorkflowContext) -> TD:
        raise NotImplementedError

    def read_eval(self, ctx: WorkflowContext) -> Sequence[tuple[TD, EI, Sequence[tuple[Q, A]]]]:
        """k folds of (training data, eval info, [(query, actual)])."""
        raise NotImplementedError


class BasePreparator(_Component, Generic[TD, PD]):
    def prepare(self, ctx: WorkflowContext, training_data: TD) -> PD:
        raise NotImplementedError


class IdentityPreparator(BasePreparator[TD, TD]):
    """Pass-through preparator (ref IdentityPreparator.scala:91)."""

    def prepare(self, ctx: WorkflowContext, training_data: TD) -> TD:
        return training_data


class BaseAlgorithm(_Component, Generic[PD, M, Q, P]):
    """The train/predict contract plus model-persistence hooks."""

    def train(self, ctx: WorkflowContext, prepared_data: PD) -> Any:
        raise NotImplementedError

    def predict(self, model: Any, query: Q) -> P:
        raise NotImplementedError

    def batch_predict(self, model: Any, queries: Sequence[tuple[int, Q]]) -> list[tuple[int, P]]:
        """Offline scoring of indexed queries (``Engine.eval`` and the
        finalize of ``Engine.dispatch_batch``): default maps ``predict``;
        algorithms with a vectorised path override it."""
        return [(i, self.predict(model, q)) for i, q in queries]

    def predict_batch(self, model: Any, queries: Sequence[Q]) -> list[P]:
        """Serving micro-batch: default maps ``predict``."""
        return [self.predict(model, q) for q in queries]

    def predict_batch_dispatch(
        self, model: Any, queries: Sequence[Q]
    ) -> Callable[[], list[P]] | None:
        """Launch the batch's device work without waiting and return a
        zero-arg finalize that fetches and decodes; None (the default)
        means the server calls ``predict_batch``."""
        return None

    def warmup_serving(self, model: Any, max_batch: int) -> None:
        """Deploy-time first launches of the serving path."""

    def make_persistent_model(self, ctx: WorkflowContext, model: Any) -> Any:
        return model

    def prepare_model(self, ctx: WorkflowContext, persisted: Any) -> Any:
        return persisted


class BaseServing(_Component, Generic[Q, P]):
    def supplement(self, query: Q) -> Q:
        return query

    def serve(self, query: Q, predictions: Sequence[P]) -> P:
        raise NotImplementedError
