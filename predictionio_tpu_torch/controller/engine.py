"""Engine — the DASE composition and its train, offline-dispatch and eval
dataflow (port of ``predictionio_tpu/controller/engine.py`` without the
step profiler's train phases)."""

from __future__ import annotations

import dataclasses
import json
import logging
from typing import Any, Callable, Generic, Mapping, Sequence

from predictionio_tpu_torch.controller.base import (
    A,
    EI,
    P,
    PD,
    Q,
    TD,
    BaseAlgorithm,
    BaseDataSource,
    BasePreparator,
    BaseServing,
    Doer,
    SanityCheck,
)
from predictionio_tpu_torch.controller.params import Params, params_from_dict
from predictionio_tpu_torch.workflow.context import WorkflowContext

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class EngineParams:
    data_source: tuple[str, Params] = ("", None)  # type: ignore[assignment]
    preparator: tuple[str, Params] = ("", None)  # type: ignore[assignment]
    algorithms: list[tuple[str, Params]] = dataclasses.field(default_factory=list)
    serving: tuple[str, Params] = ("", None)  # type: ignore[assignment]


@dataclasses.dataclass
class TrainOptions:
    """Sanity-check and stop-after flags (ref WorkflowParams)."""

    skip_sanity_check: bool = False
    stop_after_read: bool = False
    stop_after_prepare: bool = False


def _sanity_check(obj: Any, what: str, skip: bool = False) -> None:
    if skip:
        return
    if isinstance(obj, SanityCheck):
        logger.info("sanity check %s", what)
        obj.sanity_check()


class Engine(Generic[TD, EI, PD, Q, P, A]):
    def __init__(
        self,
        data_source_classes: Mapping[str, type] | type,
        preparator_classes: Mapping[str, type] | type,
        algorithm_classes: Mapping[str, type] | type,
        serving_classes: Mapping[str, type] | type,
        query_class: type | None = None,
    ):
        def as_map(x) -> dict[str, type]:
            return dict(x) if isinstance(x, Mapping) else {"": x}

        self.data_source_classes = as_map(data_source_classes)
        self.preparator_classes = as_map(preparator_classes)
        self.algorithm_classes = as_map(algorithm_classes)
        self.serving_classes = as_map(serving_classes)
        self.query_class = query_class  # has from_json_dict() for POST bodies

    def decode_query(self, payload: Any) -> Any:
        if self.query_class is not None and hasattr(self.query_class, "from_json_dict"):
            return self.query_class.from_json_dict(payload)
        return payload

    @staticmethod
    def encode_result(result: Any) -> Any:
        if hasattr(result, "to_json_dict"):
            return result.to_json_dict()
        if dataclasses.is_dataclass(result) and not isinstance(result, type):
            return dataclasses.asdict(result)
        return result

    def _pick(self, classes: dict[str, type], name: str, role: str) -> type:
        if name in classes:
            return classes[name]
        if name == "" and len(classes) == 1:
            return next(iter(classes.values()))
        raise KeyError(f"unknown {role} {name!r}; available: {sorted(classes)}")

    def make_components(
        self, engine_params: EngineParams
    ) -> tuple[BaseDataSource, BasePreparator, list[BaseAlgorithm], BaseServing]:
        ds_name, ds_params = engine_params.data_source
        prep_name, prep_params = engine_params.preparator
        serv_name, serv_params = engine_params.serving
        data_source = Doer.apply(
            self._pick(self.data_source_classes, ds_name, "datasource"), ds_params
        )
        preparator = Doer.apply(
            self._pick(self.preparator_classes, prep_name, "preparator"), prep_params
        )
        algorithms = [
            Doer.apply(self._pick(self.algorithm_classes, name, "algorithm"), p)
            for name, p in (engine_params.algorithms or [("", None)])
        ]
        serving = Doer.apply(
            self._pick(self.serving_classes, serv_name, "serving"), serv_params
        )
        return data_source, preparator, algorithms, serving

    def train(self, ctx: WorkflowContext, engine_params: EngineParams,
              options: TrainOptions | None = None) -> list[Any]:
        """read -> sanity -> prepare -> sanity -> train each algorithm ->
        sanity (ref Engine.train, Engine.scala:623-710). Returns one model
        per algorithm, or none after a stop that ``options`` asks for."""
        options = options or TrainOptions()
        skip = options.skip_sanity_check
        data_source, preparator, algorithms, _ = self.make_components(engine_params)
        td = data_source.read_training(ctx)
        _sanity_check(td, "training data", skip)
        if options.stop_after_read:
            logger.info("stopping after read_training")
            return []
        pd = preparator.prepare(ctx, td)
        _sanity_check(pd, "prepared data", skip)
        if options.stop_after_prepare:
            logger.info("stopping after prepare")
            return []
        models = []
        for i, algo in enumerate(algorithms):
            logger.info("training algorithm %d: %s", i, type(algo).__name__)
            model = algo.train(ctx, pd)
            _sanity_check(model, f"model {i}", skip)
            models.append(model)
        return models

    def dispatch_batch(
        self,
        algorithms: Sequence[BaseAlgorithm],
        serving: BaseServing,
        models: Sequence[Any],
        queries: Sequence[Any],
    ) -> Callable[[], list[Any]]:
        """Offline mega-batch entry (``pio batchpredict``, the eval grid):
        launch one query batch's device work through every algorithm's
        ``predict_batch_dispatch`` and return a zero-arg finalize that
        fetches, regroups per query and serves. The offline pipeline
        dispatches batch N, then drains batch N-1 while the card computes
        N. An algorithm without a pipelined path (``predict_batch_dispatch``
        returns None) runs its indexed ``batch_predict`` inside finalize."""
        supplemented = [serving.supplement(q) for q in queries]
        fins = [
            algo.predict_batch_dispatch(model, supplemented)
            for algo, model in zip(algorithms, models)
        ]

        def finalize() -> list[Any]:
            per_query: list[list[Any]] = [[] for _ in supplemented]
            for algo, model, fin in zip(algorithms, models, fins):
                if fin is not None:
                    for i, p in enumerate(fin()):
                        per_query[i].append(p)
                else:
                    for i, p in algo.batch_predict(model, list(enumerate(supplemented))):
                        per_query[i].append(p)
            return [serving.serve(q, preds) for q, preds in zip(queries, per_query)]

        return finalize

    def make_serializable_models(
        self, ctx: WorkflowContext, engine_params: EngineParams, models: list[Any]
    ) -> list[Any]:
        _, _, algorithms, _ = self.make_components(engine_params)
        return [
            algo.make_persistent_model(ctx, model)
            for algo, model in zip(algorithms, models)
        ]

    def prepare_deploy(
        self, ctx: WorkflowContext, engine_params: EngineParams, persisted: list[Any]
    ) -> list[Any]:
        _, _, algorithms, _ = self.make_components(engine_params)
        return [
            algo.prepare_model(ctx, blob) for algo, blob in zip(algorithms, persisted)
        ]

    def eval(
        self, ctx: WorkflowContext, engine_params: EngineParams
    ) -> list[tuple[EI, list[tuple[Q, P, A]]]]:
        """Per fold: train every algorithm, then supplement -> indexed
        ``batch_predict`` per algorithm -> regroup by query index -> serve."""
        data_source, preparator, algorithms, serving = self.make_components(engine_params)
        results: list[tuple[EI, list[tuple[Q, P, A]]]] = []
        for fold_idx, (td, ei, qa_pairs) in enumerate(data_source.read_eval(ctx)):
            # materialise once: a data source may yield a generator, and a
            # second pass over it would evaluate zero queries
            qa_list = list(qa_pairs)
            logger.info("eval fold %d: %d queries", fold_idx, len(qa_list))
            pd = preparator.prepare(ctx, td)
            models = [algo.train(ctx, pd) for algo in algorithms]
            supplemented = [(i, serving.supplement(q)) for i, (q, _) in enumerate(qa_list)]
            per_query: list[list[P]] = [[] for _ in qa_list]
            for algo, model in zip(algorithms, models):
                for i, p in algo.batch_predict(model, supplemented):
                    per_query[i].append(p)
            joined = [
                (qa_list[i][0], serving.serve(qa_list[i][0], preds), qa_list[i][1])
                for i, preds in enumerate(per_query)
            ]
            results.append((ei, joined))
        return results

    def engine_params_from_variant(self, variant: Mapping[str, Any]) -> EngineParams:
        """EngineParams from a parsed engine.json variant::

            {"datasource": {"params": {...}},
             "preparator": {"params": {...}},
             "algorithms": [{"name": "als", "params": {...}}, ...],
             "serving": {"params": {...}}}
        """

        def extract(cls: type, raw: dict, role: str) -> Params | None:
            params_cls = getattr(cls, "params_class", None)
            if params_cls is not None:
                return params_from_dict(params_cls, raw)
            if raw:
                raise ValueError(
                    f"{role} component {cls.__name__} declares no params_class "
                    f"but the variant supplies params {sorted(raw)}; they would "
                    "be ignored"
                )
            return None

        def one(role: str, classes: dict[str, type]) -> tuple[str, Params]:
            node = variant.get(role) or {}
            name = node.get("name", "")
            cls = self._pick(classes, name, role)
            return name, extract(cls, node.get("params") or {}, role)  # type: ignore[return-value]

        algorithms: list[tuple[str, Params]] = []
        for node in variant.get("algorithms") or []:
            name = node.get("name", "")
            cls = self._pick(self.algorithm_classes, name, "algorithm")
            algorithms.append((name, extract(cls, node.get("params") or {}, "algorithm")))  # type: ignore[arg-type]
        return EngineParams(
            data_source=one("datasource", self.data_source_classes),
            preparator=one("preparator", self.preparator_classes),
            algorithms=algorithms,
            serving=one("serving", self.serving_classes),
        )

    @staticmethod
    def engine_params_to_json(engine_params: EngineParams) -> dict[str, str]:
        def dump(p: Params | None) -> str:
            return p.to_json() if p is not None else "{}"

        return {
            "data_source_params": dump(engine_params.data_source[1]),
            "preparator_params": dump(engine_params.preparator[1]),
            "algorithms_params": json.dumps(
                [
                    {"name": name, "params": json.loads(dump(p))}
                    for name, p in (engine_params.algorithms or [("", None)])
                ]
            ),
            "serving_params": dump(engine_params.serving[1]),
        }


class EngineFactory:
    """ref EngineFactory.scala:44 — a callable returning an Engine. Engine
    templates expose a module-level ``engine_factory()`` function or subclass
    this."""

    def apply(self) -> Engine:
        raise NotImplementedError

    def __call__(self) -> Engine:
        return self.apply()
