"""Recommended-user template on PyTorch (port of
``predictionio_tpu.models.recommendeduser``): similar users from follow
events through implicit ALS."""

from predictionio_tpu_torch.models.recommendeduser.engine import (
    ALSAlgorithm,
    DataSource,
    DataSourceParams,
    PredictedResult,
    Preparator,
    Query,
    Serving,
    SimilarUserModel,
    SimilarUserScore,
    TrainingData,
    engine_factory,
)

__all__ = [
    "ALSAlgorithm",
    "DataSource",
    "DataSourceParams",
    "PredictedResult",
    "Preparator",
    "Query",
    "Serving",
    "SimilarUserModel",
    "SimilarUserScore",
    "TrainingData",
    "engine_factory",
]
