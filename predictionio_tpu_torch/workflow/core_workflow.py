"""Train and evaluation runs recorded in the metadata and model
repositories (port of ``run_train``, ``load_models_for_instance``,
``run_evaluation`` and ``run_grid_evaluation`` in
``predictionio_tpu/workflow/core_workflow.py``, with its registry publish
and the ANN index built at publish, without the step profiler).

Across ranks (``parallel.distributed``), every rank trains (the
collectives inside ``engine.train`` need them all), but only the
coordinator, rank 0, touches the metadata and model stores; the others
log and return "" (the Spark driver was the single metadata writer). The
engine instance records every rank's kernel launches during the train
(``spark_conf["kernel_launches"]``, a JSON list in rank order).

An engine instance goes through ``get_meta_data_engine_instances()`` (INIT,
TRAINING, then COMPLETED or FAILED) and the model blob through
``get_model_data_models()``, keyed by the instance id, as in the JAX
package; ``pio deploy`` finds the latest COMPLETED instance there. With
``PIO_PROFILE_DIR`` set, the train runs inside a ``torch.profiler`` capture
on the run's device, published as a profile bundle in that directory
(``obs/profiler.maybe_profile_train``; ``pio profile train``).
"""

from __future__ import annotations

import datetime as _dt
import json
import logging
import os
import time
from typing import Any

from predictionio_tpu_torch.controller.engine import Engine, EngineParams, TrainOptions
from predictionio_tpu_torch.data.storage.base import (
    EngineInstance,
    EngineInstanceStatus,
    EvaluationInstance,
    EvaluationInstanceStatus,
    Model,
)
from predictionio_tpu_torch.obs.profiler import maybe_profile_train
from predictionio_tpu_torch.obs.torchprof import kernel_launch_counts
from predictionio_tpu_torch.parallel import distributed
from predictionio_tpu_torch.workflow import model_io
from predictionio_tpu_torch.workflow.cleanup import CleanupFunctions
from predictionio_tpu_torch.workflow.context import WorkflowContext
from predictionio_tpu_torch.workflow.engine_loader import EngineManifest

logger = logging.getLogger(__name__)
UTC = _dt.timezone.utc


def run_train(
    engine: Engine,
    manifest: EngineManifest,
    engine_params: EngineParams,
    ctx: WorkflowContext,
    batch: str = "",
    env: dict[str, str] | None = None,
    registry_dir: str | None = None,
    keep_versions: int = 5,
    options: TrainOptions | None = None,
) -> str:
    """Train, store the serialised models, and record the engine instance;
    returns its id ("" on a rank other than the coordinator, which stores
    nothing). A failed run is recorded as FAILED. After a stop that
    ``options`` asks for (read or prepare) the instance is COMPLETED with
    no model blob and nothing is published (ref core_workflow.py:170-180).

    With a registry (``registry_dir`` or ``$PIO_REGISTRY_DIR``) the blob is
    also published as a checksummed artifact with a lineage manifest; the
    first publish becomes stable, and a model with an item-vector table
    large enough gets its ANN index pinned (``ann.lifecycle``). A failed
    publish never fails the train: the metadata and model repositories,
    written first, stay authoritative. ``CleanupFunctions`` run when it
    ends, on every rank, completed or failed."""
    try:
        return _run_train(engine, manifest, engine_params, ctx, batch, env, registry_dir, keep_versions,
                          options)
    finally:
        # on every rank, whether the train completed or failed
        CleanupFunctions.run()


def _run_train(engine, manifest, engine_params, ctx, batch, env, registry_dir, keep_versions,
               options) -> str:
    rt = distributed.runtime()
    if rt is not None and not distributed.is_coordinator():
        before = kernel_launch_counts()
        with maybe_profile_train(
            context={"engine": manifest.engine_id, "engineVersion": manifest.version,
                     "processIndex": rt.rank},
            device=str(ctx.device),
            counters_fn=kernel_launch_counts if ctx.device.type == "cuda" else None,
        ):
            models = engine.train(ctx, engine_params, options)
        _launches_by_rank(before)
        if not (options and (options.stop_after_read or options.stop_after_prepare)):
            # the serialisable form may gather across ranks: every rank runs it
            engine.make_serializable_models(ctx, engine_params, models)
        logger.info("rank %d of %d finished (the coordinator persists)", rt.rank, rt.world_size)
        return ""
    storage = ctx.storage
    instances = storage.get_meta_data_engine_instances()
    params_json = Engine.engine_params_to_json(engine_params)
    instance = EngineInstance(
        id="",
        status=EngineInstanceStatus.INIT,
        start_time=_dt.datetime.now(tz=UTC),
        end_time=_dt.datetime.now(tz=UTC),
        engine_id=manifest.engine_id,
        engine_version=manifest.version,
        engine_variant=manifest.variant,
        engine_factory=manifest.engine_factory,
        batch=batch,
        env=env or {},
        **params_json,
    )
    instance_id = instances.insert(instance)
    logger.info("engine instance %s created", instance_id)
    t0 = time.perf_counter()
    before = kernel_launch_counts()
    try:
        instance.status = EngineInstanceStatus.TRAINING
        instances.update(instance)
        # the device-trace gate (PIO_PROFILE_DIR): the train runs inside a
        # torch.profiler capture published as a content-addressed bundle
        with maybe_profile_train(
            context={
                "engine": manifest.engine_id,
                "engineVersion": manifest.version,
                "batch": batch,
                "instanceId": instance_id,
            },
            device=str(ctx.device),
            counters_fn=kernel_launch_counts if ctx.device.type == "cuda" else None,
        ):
            models = engine.train(ctx, engine_params, options)
        launches = _launches_by_rank(before)
        if options and (options.stop_after_read or options.stop_after_prepare):
            instance.status = EngineInstanceStatus.COMPLETED
            instance.end_time = _dt.datetime.now(tz=UTC)
            instances.update(instance)
            return instance_id
        persistable = engine.make_serializable_models(ctx, engine_params, models)
        blob = model_io.serialize_models(persistable)
        storage.get_model_data_models().insert(Model(instance_id, blob))
    except BaseException:
        instance.status = EngineInstanceStatus.FAILED
        instance.end_time = _dt.datetime.now(tz=UTC)
        instances.update(instance)
        raise
    wall = time.perf_counter() - t0
    instance.status = EngineInstanceStatus.COMPLETED
    instance.end_time = _dt.datetime.now(tz=UTC)
    instance.spark_conf = {
        "train_wall_clock_sec": f"{wall:.3f}",
        "device": str(ctx.device),
        "kernel_launches": json.dumps(launches),
    }
    instances.update(instance)
    _publish_to_registry(
        manifest, instance_id, blob, params_json, wall, batch, registry_dir, keep_versions,
        models=persistable, device=ctx.device,
    )
    logger.info("training completed: engine instance %s, %.2fs", instance_id, wall)
    return instance_id


def _launches_by_rank(before: dict[str, int]) -> list[dict[str, int]]:
    """Each rank's kernel launches since ``before`` (its own counters),
    gathered over the job in rank order (every rank calls this once a
    train): the record says which ranks ran which kernels."""
    mine = {k: v - before[k] for k, v in kernel_launch_counts().items()}
    rt = distributed.runtime()
    if rt is None:
        return [mine]
    import torch.distributed as dist

    out: list = [None] * rt.world_size
    dist.all_gather_object(out, mine)
    return out


def _publish_to_registry(
    manifest: EngineManifest,
    instance_id: str,
    blob: bytes,
    params_json: dict[str, str],
    wall_s: float,
    batch: str,
    registry_dir: str | None,
    keep_versions: int,
    models: list[Any] | None = None,
    device: Any = "cuda",
) -> None:
    """Write the trained blob into the artifact registry with its lineage
    manifest (atomic inside the store); best-effort by contract — a broken
    registry disk must not fail a completed train.

    When ``models`` has an item-vector table and the corpus clears the ANN
    threshold (``PIO_ANN_MIN_ITEMS``), the version also gets its retrieval
    index built on ``device`` and pinned here: the end-of-train half of the
    index lifecycle."""
    registry_dir = registry_dir or os.environ.get("PIO_REGISTRY_DIR")
    if not registry_dir:
        return
    try:
        from predictionio_tpu_torch.registry import ArtifactStore, ModelManifest, params_hash_of

        store = ArtifactStore(registry_dir)
        published = store.publish(
            ModelManifest(
                version="",
                engine_id=manifest.engine_id,
                engine_version=manifest.version,
                engine_variant=manifest.variant,
                engine_factory=manifest.engine_factory,
                instance_id=instance_id,
                params_hash=params_hash_of(params_json),
                data_span={
                    "trainedAt": ModelManifest.now_iso(),
                    "batch": batch,
                    "trainWallClockSec": round(wall_s, 3),
                },
            ),
            blob,
            keep_last=keep_versions,
        )
        logger.info("registry: published %s (instance %s)", published.version, instance_id)
        if models:
            from predictionio_tpu_torch.ann import lifecycle as ann_lifecycle

            ann_lifecycle.build_for_version(
                store, manifest.engine_id, published.version, models, device=device
            )
    except Exception:
        logger.exception("registry publish failed (metadata store remains authoritative)")


def load_models_for_instance(
    engine: Engine,
    engine_params: EngineParams,
    instance_id: str,
    ctx: WorkflowContext,
) -> list[Any]:
    """Model-repository blob -> models laid out on ``ctx.device``."""
    record = ctx.storage.get_model_data_models().get(instance_id)
    if record is None:
        raise RuntimeError(f"no model blob for engine instance {instance_id}")
    persisted = model_io.deserialize_models(record.models)
    return engine.prepare_deploy(ctx, engine_params, persisted)


def _evaluation_instance(evaluation: Any, batch: str) -> EvaluationInstance:
    now = _dt.datetime.now(tz=UTC)
    return EvaluationInstance(
        id="",
        status=EvaluationInstanceStatus.INIT,
        start_time=now,
        end_time=now,
        evaluation_class=f"{type(evaluation).__module__}.{type(evaluation).__qualname__}",
        batch=batch,
    )


def run_grid_evaluation(
    evaluation_source: Any,
    ctx: WorkflowContext,
    **grid_kwargs: Any,
) -> tuple[str, Any]:
    """Run an Evaluation through the evaluation grid
    (:func:`predictionio_tpu_torch.tuning.run_grid`) with an
    EvaluationInstance in the metadata store: inserted once the grid's
    arguments and ledger validated, EVALCOMPLETED with the one-liner, JSON
    and HTML results when it finishes. Returns (instance_id, GridReport).
    ``CleanupFunctions`` run when it ends, failed or not."""
    from predictionio_tpu_torch.tuning import run_grid
    from predictionio_tpu_torch.tuning.cells import resolve_evaluation

    evaluation = grid_kwargs.pop("evaluation", None) or resolve_evaluation(evaluation_source)
    instances = ctx.storage.get_meta_data_evaluation_instances()
    instance = _evaluation_instance(evaluation, ctx.batch)
    instance_id = ""

    def record_start() -> None:
        # inserted only after run_grid validated its arguments and ledger,
        # so a flag typo leaves no row stuck in EVALUATING
        nonlocal instance_id
        instance_id = instances.insert(instance)
        instance.status = EvaluationInstanceStatus.EVALUATING
        instances.update(instance)

    # process workers rebuild the evaluation by name: hand the original
    # source through; the resolved instance serves the in-process path
    source = (
        evaluation_source
        if isinstance(evaluation_source, str) or not hasattr(evaluation_source, "run")
        else evaluation
    )
    try:
        report = run_grid(
            source, ctx=ctx, evaluation=evaluation, on_validated=record_start, **grid_kwargs
        )
    except BaseException:
        # stays EVALUATING; the ledger holds the finished cells for --resume
        if instance_id:
            instance.end_time = _dt.datetime.now(tz=UTC)
            instances.update(instance)
        CleanupFunctions.run()
        raise
    result = report.evaluator_result
    instance.status = EvaluationInstanceStatus.EVALCOMPLETED
    instance.end_time = _dt.datetime.now(tz=UTC)
    instance.evaluator_results = report.one_liner()
    if result is not None:
        instance.evaluator_results_json = json.dumps(result.to_json_dict())
        instance.evaluator_results_html = result.to_html()
    instances.update(instance)
    CleanupFunctions.run()
    return instance_id, report


def run_evaluation(evaluation: Any, ctx: WorkflowContext) -> tuple[str, Any]:
    """Run an Evaluation (engine + metric + params list, or a FakeRun)
    sequentially; records an EvaluationInstance with the one-liner, JSON and
    HTML results unless the result says ``no_save``. Returns (instance_id,
    result). ``CleanupFunctions`` run when it ends, failed or not."""
    instances = ctx.storage.get_meta_data_evaluation_instances()
    instance = _evaluation_instance(evaluation, ctx.batch)
    instance_id = instances.insert(instance)
    instance.status = EvaluationInstanceStatus.EVALUATING
    instances.update(instance)
    try:
        result = evaluation.run(ctx)
        if getattr(result, "no_save", False):
            # FakeRun results are not persisted (ref CoreWorkflow.scala:140-142)
            logger.info("evaluation result not inserted into database (no_save)")
        else:
            instance.status = EvaluationInstanceStatus.EVALCOMPLETED
            instance.end_time = _dt.datetime.now(tz=UTC)
            instance.evaluator_results = result.one_liner()
            instance.evaluator_results_json = json.dumps(result.to_json_dict())
            instance.evaluator_results_html = result.to_html()
            instances.update(instance)
    finally:
        CleanupFunctions.run()
    return instance_id, result
