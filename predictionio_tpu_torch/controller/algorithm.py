"""Algorithm flavours (port of ``predictionio_tpu/controller/algorithm.py``).

``TorchAlgorithm`` takes the place of ``JaxAlgorithm``: train builds a
model of tensors on the context's device; the persisted form is host numpy,
device-agnostic, and deploy lays it out on the serving device again.
``LocalAlgorithm`` covers host-only algorithms (the reference's LAlgorithm).
"""

from __future__ import annotations

from typing import Any, Generic

import torch

from predictionio_tpu_torch.controller.base import M, PD, Q, P, BaseAlgorithm
from predictionio_tpu_torch.workflow.context import WorkflowContext


def model_to_host(model: Any) -> Any:
    """Pull every tensor of a model (through lists, tuples and dicts) to
    host numpy, the checkpoint form. Other objects pass through, as leaves
    of a pytree do."""
    if isinstance(model, torch.Tensor):
        return model.detach().cpu().numpy()
    if isinstance(model, (list, tuple)):
        return type(model)(model_to_host(x) for x in model)
    if isinstance(model, dict):
        return {k: model_to_host(v) for k, v in model.items()}
    return model


class TorchAlgorithm(BaseAlgorithm[PD, M, Q, P], Generic[PD, M, Q, P]):
    def make_persistent_model(self, ctx: WorkflowContext, model: M) -> Any:
        return model_to_host(model)


class LocalAlgorithm(BaseAlgorithm[PD, M, Q, P], Generic[PD, M, Q, P]):
    """Host-only algorithm (ref LAlgorithm): pure Python/NumPy train and
    predict, no device interaction."""


class PersistentModel:
    """Models managing their own storage (ref PersistentModel.scala:115).

    A model class implementing ``save``/``load`` is persisted by calling
    ``save`` and recording a manifest; at deploy, ``load`` rebuilds it.
    """

    def save(self, instance_id: str, params: Any, base_dir: str) -> bool:
        """Persist; return False to fall back to the default host-numpy
        persistence."""
        raise NotImplementedError

    @classmethod
    def load(cls, instance_id: str, params: Any, base_dir: str) -> "PersistentModel":
        raise NotImplementedError


class PersistentModelManifest:
    """Marker stored in the model repository instead of bytes
    (ref workflow/PersistentModelManifest.scala)."""

    def __init__(self, class_path: str):
        self.class_path = class_path

    def to_json_dict(self) -> dict[str, str]:
        return {"class_path": self.class_path}
