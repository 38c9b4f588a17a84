"""Similar-product template on PyTorch (port of
``predictionio_tpu.models.similarproduct``): implicit-ALS item factors
scored by summed cosine to the query items, a like-event ALS, an explicit
rate-event ALS and item cooccurrence, with the business filters."""

from predictionio_tpu_torch.models.similarproduct.engine import (
    ALSAlgorithm,
    CooccurrenceAlgorithm,
    CooccurrenceModel,
    DataSource,
    ItemScore,
    LikeAlgorithm,
    PredictedResult,
    Preparator,
    Query,
    RateALSAlgorithm,
    Serving,
    SimilarModel,
    TrainingData,
    engine_factory,
)

__all__ = [
    "ALSAlgorithm",
    "CooccurrenceAlgorithm",
    "CooccurrenceModel",
    "DataSource",
    "ItemScore",
    "LikeAlgorithm",
    "PredictedResult",
    "Preparator",
    "Query",
    "RateALSAlgorithm",
    "Serving",
    "SimilarModel",
    "TrainingData",
    "engine_factory",
]
