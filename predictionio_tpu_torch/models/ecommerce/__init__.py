"""E-commerce recommendation template on PyTorch (port of
``predictionio_tpu.models.ecommerce``): implicit ALS with live business
rules (seen items, unavailable items, item weights) and cold-user
fallbacks."""

from predictionio_tpu_torch.models.ecommerce.engine import (
    DataSource,
    ECommAlgorithm,
    ECommAlgorithmParams,
    ECommModel,
    ItemScore,
    PredictedResult,
    Preparator,
    Query,
    Serving,
    TrainingData,
    engine_factory,
)

__all__ = [
    "DataSource",
    "ECommAlgorithm",
    "ECommAlgorithmParams",
    "ECommModel",
    "ItemScore",
    "PredictedResult",
    "Preparator",
    "Query",
    "Serving",
    "TrainingData",
    "engine_factory",
]
