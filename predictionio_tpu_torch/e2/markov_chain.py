"""First-order Markov chain over item transitions (own copy of
``predictionio_tpu/e2/markov_chain.py``).

Build a row-normalised transition model from coordinate (i, j, count)
data, keeping only the top-N outgoing probabilities per state, ranked by
probability and then by state (tie order ``(-p, j)``).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Sequence


@dataclasses.dataclass
class MarkovChainModel:
    n_states: int
    top_n: int
    # state -> [(next_state, probability)] sorted desc, length <= top_n
    transitions: dict[int, list[tuple[int, float]]]

    def transition_probs(self, state: int) -> list[tuple[int, float]]:
        return self.transitions.get(state, [])

    def predict(self, state: int) -> int | None:
        probs = self.transition_probs(state)
        return probs[0][0] if probs else None


def train_markov_chain(
    coordinates: Sequence[tuple[int, int, float]],
    n_states: int,
    top_n: int,
) -> MarkovChainModel:
    """coordinates = (from_state, to_state, count) triples (duplicates
    summed)."""
    rows: dict[int, dict[int, float]] = defaultdict(lambda: defaultdict(float))
    for i, j, c in coordinates:
        rows[i][j] += c
    transitions: dict[int, list[tuple[int, float]]] = {}
    for i, counts in rows.items():
        total = sum(counts.values())
        if total <= 0:
            continue
        ranked = sorted(
            ((j, c / total) for j, c in counts.items()),
            key=lambda t: (-t[1], t[0]),
        )
        transitions[i] = ranked[:top_n]
    return MarkovChainModel(n_states, top_n, transitions)
