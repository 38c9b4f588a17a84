"""DASE controller API — what engine templates import."""

from predictionio_tpu_torch.controller.algorithm import (
    LocalAlgorithm,
    TorchAlgorithm,
    model_to_host,
)
from predictionio_tpu_torch.controller.base import (
    BaseAlgorithm,
    BaseDataSource,
    BasePreparator,
    BaseServing,
    Doer,
    SanityCheck,
)
from predictionio_tpu_torch.controller.engine import Engine, EngineParams, TrainOptions
from predictionio_tpu_torch.controller.params import (
    EmptyParams,
    Params,
    ParamsError,
    params_from_dict,
)
from predictionio_tpu_torch.controller.serving import FirstServing

__all__ = [
    "BaseAlgorithm",
    "BaseDataSource",
    "BasePreparator",
    "BaseServing",
    "Doer",
    "EmptyParams",
    "Engine",
    "EngineParams",
    "FirstServing",
    "LocalAlgorithm",
    "Params",
    "ParamsError",
    "SanityCheck",
    "TorchAlgorithm",
    "TrainOptions",
    "model_to_host",
    "params_from_dict",
]
