"""DASE controller API — what engine templates import."""

from predictionio_tpu_torch.controller.algorithm import (
    LocalAlgorithm,
    PersistentModel,
    PersistentModelManifest,
    TorchAlgorithm,
    model_to_host,
)
from predictionio_tpu_torch.controller.base import (
    BaseAlgorithm,
    BaseDataSource,
    BasePreparator,
    BaseServing,
    Doer,
    IdentityPreparator,
    SanityCheck,
)
from predictionio_tpu_torch.controller.engine import Engine, EngineFactory, EngineParams, TrainOptions
from predictionio_tpu_torch.controller.params import (
    EmptyParams,
    Params,
    ParamsError,
    params_from_dict,
    params_from_json,
)
from predictionio_tpu_torch.controller.serving import AverageServing, FirstServing

__all__ = [
    "AverageServing",
    "BaseAlgorithm",
    "BaseDataSource",
    "BasePreparator",
    "BaseServing",
    "Doer",
    "EmptyParams",
    "Engine",
    "EngineFactory",
    "EngineParams",
    "FirstServing",
    "IdentityPreparator",
    "LocalAlgorithm",
    "Params",
    "ParamsError",
    "PersistentModel",
    "PersistentModelManifest",
    "SanityCheck",
    "TorchAlgorithm",
    "TrainOptions",
    "model_to_host",
    "params_from_dict",
    "params_from_json",
]
