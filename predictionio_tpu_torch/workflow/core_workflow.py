"""Train runs with a local metadata and model store (port of ``run_train``
in ``predictionio_tpu/workflow/core_workflow.py``, without the registry
publish, the step profiler and multi-host training)."""

from __future__ import annotations

import datetime as _dt
import logging
import time

from predictionio_tpu_torch.controller.engine import Engine, EngineParams
from predictionio_tpu_torch.workflow import model_io
from predictionio_tpu_torch.workflow.context import WorkflowContext
from predictionio_tpu_torch.workflow.engine_loader import EngineManifest

logger = logging.getLogger(__name__)


def _now() -> str:
    return _dt.datetime.now(tz=_dt.timezone.utc).isoformat()


def run_train(
    engine: Engine,
    manifest: EngineManifest,
    engine_params: EngineParams,
    ctx: WorkflowContext,
) -> str:
    """Train, serialise the models into the store, and record the engine
    instance; returns its id. A failed run is recorded as FAILED."""
    store = ctx.store
    record = {
        "status": "INIT",
        "start_time": _now(),
        "end_time": _now(),
        "engine_id": manifest.engine_id,
        "engine_version": manifest.version,
        "engine_variant": manifest.variant,
        "engine_factory": manifest.engine_factory,
        "variant": manifest.variant_json,
        "device": str(ctx.device),
        **Engine.engine_params_to_json(engine_params),
    }
    instance_id = store.new_instance(record)
    logger.info("engine instance %s created", instance_id)
    t0 = time.perf_counter()
    try:
        record["status"] = "TRAINING"
        store.update_instance(instance_id, record)
        models = engine.train(ctx, engine_params)
        blob = model_io.serialize_models(
            engine.make_serializable_models(ctx, engine_params, models)
        )
        store.put_model(instance_id, blob)
    except BaseException:
        record.update(status="FAILED", end_time=_now())
        store.update_instance(instance_id, record)
        raise
    record.update(
        status="COMPLETED",
        end_time=_now(),
        train_wall_clock_sec=round(time.perf_counter() - t0, 3),
    )
    store.update_instance(instance_id, record)
    logger.info("training completed: engine instance %s", instance_id)
    return instance_id
