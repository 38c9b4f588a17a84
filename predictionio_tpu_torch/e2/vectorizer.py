"""Binary one-hot vectorizer over (property, value) pairs.

Reference parity: ``e2/.../engine/BinaryVectorizer.scala:26-60`` — build a
(property, value) -> column index from observed maps, then encode a map into
a dense 0/1 vector. The port's own copy of
``predictionio_tpu/e2/vectorizer.py``.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np


class BinaryVectorizer:
    def __init__(self, index: dict[tuple[str, str], int]):
        self.index = dict(index)

    @property
    def n_features(self) -> int:
        return len(self.index)

    @staticmethod
    def fit(
        maps: Iterable[Mapping[str, str]], properties: Iterable[str] | None = None
    ) -> "BinaryVectorizer":
        props = set(properties) if properties is not None else None
        seen: dict[tuple[str, str], int] = {}
        for m in maps:
            for k, v in m.items():
                if props is not None and k not in props:
                    continue
                seen.setdefault((k, str(v)), len(seen))
        return BinaryVectorizer(seen)

    def transform(self, m: Mapping[str, str]) -> np.ndarray:
        out = np.zeros(len(self.index), dtype=np.float32)
        for k, v in m.items():
            idx = self.index.get((k, str(v)))
            if idx is not None:
                out[idx] = 1.0
        return out
