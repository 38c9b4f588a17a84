"""Classification models: multinomial naive Bayes and a compact random
forest (port of ``predictionio_tpu/ops/classify.py``).

These back the classification template, replacing MLlib's ``NaiveBayes.train``
and ``RandomForest.trainClassifier`` (ref
``examples/scala-parallel-classification/add-algorithm/src/main/scala/
NaiveBayesAlgorithm.scala`` / ``RandomForestAlgorithm.scala``).

Training is host float64 in both packages. A single query scores on the
host in float64; ``NaiveBayesModel.predict_batch`` scores a batch on the
model's device in float32 (one matrix product and an argmax), as the JAX
package does with x64 off. The forest is host numpy drawn from
``default_rng(seed)`` in the JAX package's order, so it grows the same trees.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from predictionio_tpu_torch.ops.als import upload
from predictionio_tpu_torch.utils.device import resolve_device

# ---------------------------------------------------------------------------
# Multinomial naive Bayes (MLlib-compatible semantics)
# ---------------------------------------------------------------------------


def _nb_scores(log_priors: torch.Tensor, log_theta: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[B, C] class scores: log prior plus the features times log theta."""
    return log_priors[None, :] + x @ log_theta.T


@dataclasses.dataclass
class NaiveBayesModel:
    labels: np.ndarray  # [C] class label values
    log_priors: np.ndarray  # [C]
    log_theta: np.ndarray  # [C, F] feature log-probabilities

    def __post_init__(self):
        self._reset()

    def _reset(self) -> None:
        self.device: torch.device | str = "cuda"  # set by train and deploy
        self._device_params: tuple[torch.device, torch.Tensor, torch.Tensor] | None = None

    def predict(self, features: np.ndarray) -> float:
        scores = self.log_priors + self.log_theta @ np.asarray(features, np.float64)
        return float(self.labels[int(np.argmax(scores))])

    def device_params(self) -> tuple[torch.Tensor, torch.Tensor]:
        """log priors and log theta as float32 on ``self.device``."""
        dev = resolve_device(self.device)
        if self._device_params is None or self._device_params[0] != dev:
            self._device_params = (
                dev,
                upload(self.log_priors, np.float32, dev),
                upload(self.log_theta, np.float32, dev),
            )
        return self._device_params[1], self._device_params[2]

    def predict_batch(self, features: np.ndarray) -> np.ndarray:
        """Labels of [B, F] features: scores and argmax on the model's device."""
        log_priors, log_theta = self.device_params()
        x = upload(features, np.float32, log_theta.device)
        best = torch.argmax(_nb_scores(log_priors, log_theta, x), dim=1)
        return self.labels[best.cpu().numpy()]

    def __getstate__(self):
        # the JAX package's NaiveBayesModel state, so blobs interchange
        return {"labels": self.labels, "log_priors": self.log_priors, "log_theta": self.log_theta}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._reset()


def train_naive_bayes(
    labels: np.ndarray, features: np.ndarray, smoothing: float = 1.0
) -> NaiveBayesModel:
    """Multinomial NB: theta_cf = (sum of f over class c + lambda) /
    (total over class c + lambda * F), matching MLlib semantics. Features
    must be non-negative."""
    labels = np.asarray(labels)
    features = np.asarray(features, np.float64)
    if np.any(features < 0):
        raise ValueError("multinomial naive Bayes requires non-negative features")
    classes = np.unique(labels)
    C, F = len(classes), features.shape[1]
    log_priors = np.zeros(C)
    log_theta = np.zeros((C, F))
    n = len(labels)
    for ci, c in enumerate(classes):
        mask = labels == c
        log_priors[ci] = np.log(mask.sum() / n)
        sums = features[mask].sum(axis=0)
        log_theta[ci] = np.log((sums + smoothing) / (sums.sum() + smoothing * F))
    return NaiveBayesModel(classes, log_priors, log_theta)


# ---------------------------------------------------------------------------
# Random forest (host-side; small tabular problems)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Node:
    feature: int = -1
    threshold: float = 0.0
    left: "_Node | None" = None
    right: "_Node | None" = None
    prediction: float = 0.0

    def predict(self, x: np.ndarray) -> float:
        node = self
        while node.feature >= 0:
            node = node.left if x[node.feature] <= node.threshold else node.right
        return node.prediction


def _gini(y: np.ndarray) -> float:
    if len(y) == 0:
        return 0.0
    _, counts = np.unique(y, return_counts=True)
    p = counts / len(y)
    return 1.0 - float(np.sum(p * p))


def _build_tree(
    X: np.ndarray,
    y: np.ndarray,
    rng: np.random.Generator,
    max_depth: int,
    n_sub_features: int,
) -> _Node:
    if max_depth == 0 or len(np.unique(y)) == 1 or len(y) < 4:
        values, counts = np.unique(y, return_counts=True)
        return _Node(prediction=float(values[np.argmax(counts)]))
    best = (None, None, np.inf)
    features = rng.choice(X.shape[1], size=min(n_sub_features, X.shape[1]), replace=False)
    for f in features:
        for t in np.unique(X[:, f])[:-1]:
            mask = X[:, f] <= t
            score = (_gini(y[mask]) * mask.sum() + _gini(y[~mask]) * (~mask).sum()) / len(y)
            if score < best[2]:
                best = (int(f), float(t), score)
    if best[0] is None:
        values, counts = np.unique(y, return_counts=True)
        return _Node(prediction=float(values[np.argmax(counts)]))
    f, t, _ = best
    mask = X[:, f] <= t
    return _Node(
        feature=f,
        threshold=t,
        left=_build_tree(X[mask], y[mask], rng, max_depth - 1, n_sub_features),
        right=_build_tree(X[~mask], y[~mask], rng, max_depth - 1, n_sub_features),
    )


@dataclasses.dataclass
class RandomForestModel:
    trees: list[_Node]

    def predict(self, x: np.ndarray) -> float:
        votes = [t.predict(np.asarray(x, np.float64)) for t in self.trees]
        values, counts = np.unique(votes, return_counts=True)
        return float(values[np.argmax(counts)])


def train_random_forest(
    labels: np.ndarray,
    features: np.ndarray,
    num_trees: int = 10,
    max_depth: int = 4,
    seed: int = 42,
) -> RandomForestModel:
    X = np.asarray(features, np.float64)
    y = np.asarray(labels)
    rng = np.random.default_rng(seed)
    n_sub = max(1, int(np.sqrt(X.shape[1])))
    trees = []
    for _ in range(num_trees):
        idx = rng.integers(0, len(y), size=len(y))  # bootstrap
        trees.append(_build_tree(X[idx], y[idx], rng, max_depth, n_sub))
    return RandomForestModel(trees)
