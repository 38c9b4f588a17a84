"""Train runs recorded in the metadata and model repositories (port of
``run_train`` and ``load_models_for_instance`` in
``predictionio_tpu/workflow/core_workflow.py``, without the registry
publish, the step profiler and multi-host training).

An engine instance goes through ``get_meta_data_engine_instances()`` (INIT,
TRAINING, then COMPLETED or FAILED) and the model blob through
``get_model_data_models()``, keyed by the instance id, as in the JAX
package; ``pio deploy`` finds the latest COMPLETED instance there.
"""

from __future__ import annotations

import datetime as _dt
import logging
import time
from typing import Any

from predictionio_tpu_torch.controller.engine import Engine, EngineParams
from predictionio_tpu_torch.data.storage.base import (
    EngineInstance,
    EngineInstanceStatus,
    Model,
)
from predictionio_tpu_torch.workflow import model_io
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
) -> str:
    """Train, store the serialised models, and record the engine instance;
    returns its id. A failed run is recorded as FAILED."""
    storage = ctx.storage
    instances = storage.get_meta_data_engine_instances()
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
        **Engine.engine_params_to_json(engine_params),
    )
    instance_id = instances.insert(instance)
    logger.info("engine instance %s created", instance_id)
    t0 = time.perf_counter()
    try:
        instance.status = EngineInstanceStatus.TRAINING
        instances.update(instance)
        models = engine.train(ctx, engine_params)
        blob = model_io.serialize_models(
            engine.make_serializable_models(ctx, engine_params, models)
        )
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
    }
    instances.update(instance)
    logger.info("training completed: engine instance %s, %.2fs", instance_id, wall)
    return instance_id


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
