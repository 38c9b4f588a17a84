"""Categorical naive Bayes on string-valued features.

Reference parity: ``e2/.../engine/CategoricalNaiveBayes.scala:29-170`` —
train computes class priors and per-(feature-position, value) conditional
log-likelihoods with add-one smoothing absent (the reference scores unseen
values via a default likelihood); ``predict`` returns the argmax label,
``log_score`` exposes the raw joint log-probability with a pluggable default
for unseen feature values.

Own copy of ``predictionio_tpu/e2/naive_bayes.py`` (host Python, the same
pickled fields, so a model either package wrote loads in the other); the
streaming naive Bayes trainer rebuilds it from counts.
"""

from __future__ import annotations

import dataclasses
import math
from collections import Counter, defaultdict
from typing import Callable, Sequence


@dataclasses.dataclass(frozen=True)
class LabeledPoint:
    label: str
    features: tuple[str, ...]


@dataclasses.dataclass
class CategoricalNaiveBayesModel:
    priors: dict[str, float]  # label -> log prior
    likelihoods: dict[str, list[dict[str, float]]]  # label -> per-pos {value: log p}

    def log_score(
        self,
        point: LabeledPoint,
        default_likelihood: Callable[[Sequence[float]], float] = lambda _: float(
            "-inf"
        ),
    ) -> float | None:
        """Joint log probability of the point under its label; None when the
        label itself is unknown (ref logScore :121-138)."""
        if point.label not in self.priors:
            return None
        return self._log_score_internal(point.label, point.features, default_likelihood)

    def _log_score_internal(self, label, features, default_likelihood) -> float:
        ll = self.likelihoods[label]
        score = self.priors[label]
        for pos, value in enumerate(features):
            table = ll[pos] if pos < len(ll) else {}
            if value in table:
                score += table[value]
            else:
                score += default_likelihood(list(table.values()))
        return score

    def predict(self, features: Sequence[str]) -> str:
        """argmax over labels (ref predict :87-103)."""
        best, best_score = None, float("-inf")
        for label in self.priors:
            s = self._log_score_internal(
                label, tuple(features), lambda _: float("-inf")
            )
            if s > best_score or best is None:
                best, best_score = label, s
        return best  # type: ignore[return-value]


def train_categorical_naive_bayes(
    points: Sequence[LabeledPoint],
) -> CategoricalNaiveBayesModel:
    if not points:
        raise ValueError("cannot train on an empty dataset")
    label_counts: Counter[str] = Counter(p.label for p in points)
    n = len(points)
    n_features = max(len(p.features) for p in points)
    # per label, per position, value counts
    value_counts: dict[str, list[Counter]] = defaultdict(
        lambda: [Counter() for _ in range(n_features)]
    )
    for p in points:
        vc = value_counts[p.label]
        for pos, v in enumerate(p.features):
            vc[pos][v] += 1
    priors = {label: math.log(c / n) for label, c in label_counts.items()}
    likelihoods: dict[str, list[dict[str, float]]] = {}
    for label, per_pos in value_counts.items():
        total = label_counts[label]
        likelihoods[label] = [
            {v: math.log(c / total) for v, c in counter.items()}
            for counter in per_pos
        ]
    return CategoricalNaiveBayesModel(priors, likelihoods)
