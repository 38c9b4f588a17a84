"""Storage SPI: metadata/event/model DAOs + pluggable backend registry.

Reference parity: ``data/.../storage/Storage.scala`` (env-var source
discovery, reflection instantiation, repository accessors) and the DAO traits
``LEvents.scala`` / ``PEvents.scala`` / ``Apps.scala`` / ``AccessKeys.scala``
/ ``Channels.scala`` / ``EngineInstances.scala`` / ``EvaluationInstances.scala``
/ ``Models.scala``.

The port's own copy of ``predictionio_tpu/data/storage/__init__.py``.
"""

from predictionio_tpu_torch.data.storage.base import (
    AccessKey,
    AccessKeys,
    App,
    Apps,
    Channel,
    Channels,
    EngineInstance,
    EngineInstances,
    EvaluationInstance,
    EvaluationInstances,
    LEvents,
    Model,
    Models,
    PEvents,
)
from predictionio_tpu_torch.data.storage.registry import Storage, StorageError

__all__ = [
    "AccessKey",
    "AccessKeys",
    "App",
    "Apps",
    "Channel",
    "Channels",
    "EngineInstance",
    "EngineInstances",
    "EvaluationInstance",
    "EvaluationInstances",
    "LEvents",
    "Model",
    "Models",
    "PEvents",
    "Storage",
    "StorageError",
]
