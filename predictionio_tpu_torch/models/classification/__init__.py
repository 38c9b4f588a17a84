"""Classification template on PyTorch (port of
``predictionio_tpu.models.classification``): naive Bayes and a random
forest over entity properties."""

from predictionio_tpu_torch.models.classification.engine import (
    DataSource,
    NaiveBayesAlgorithm,
    PredictedResult,
    Preparator,
    Query,
    RandomForestAlgorithm,
    Serving,
    TrainingData,
    custom_properties_engine_factory,
    engine_factory,
)

__all__ = [
    "DataSource",
    "NaiveBayesAlgorithm",
    "PredictedResult",
    "Preparator",
    "Query",
    "RandomForestAlgorithm",
    "Serving",
    "TrainingData",
    "custom_properties_engine_factory",
    "engine_factory",
]
