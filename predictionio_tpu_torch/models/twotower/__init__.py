"""Two-tower deep retrieval template on PyTorch (port of
``predictionio_tpu.models.twotower``): ``model.py`` holds the network, its
in-batch-softmax training step and loop; ``engine.py`` the DASE template."""

from predictionio_tpu_torch.models.twotower.engine import (
    DataSource,
    ItemScore,
    PredictedResult,
    Preparator,
    Query,
    Serving,
    TrainingData,
    TwoTowerAlgorithm,
    TwoTowerAlgorithmParams,
    TwoTowerModelState,
    engine_factory,
)

__all__ = [
    "DataSource",
    "ItemScore",
    "PredictedResult",
    "Preparator",
    "Query",
    "Serving",
    "TrainingData",
    "TwoTowerAlgorithm",
    "TwoTowerAlgorithmParams",
    "TwoTowerModelState",
    "engine_factory",
]
