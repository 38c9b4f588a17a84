"""Serving flavours (port of ``predictionio_tpu/controller/serving.py``)."""

from __future__ import annotations

from typing import Sequence

from predictionio_tpu_torch.controller.base import P, Q, BaseServing


class FirstServing(BaseServing[Q, P]):
    """Serve the first algorithm's prediction."""

    def serve(self, query: Q, predictions: Sequence[P]) -> P:
        return predictions[0]


class AverageServing(BaseServing[Q, P]):
    """Average numeric predictions across algorithms (ref LAverageServing)."""

    def serve(self, query: Q, predictions: Sequence[P]) -> P:
        return sum(predictions) / len(predictions)  # type: ignore[return-value]
