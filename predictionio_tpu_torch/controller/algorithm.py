"""Algorithm flavours (port of ``predictionio_tpu/controller/algorithm.py``).

``TorchAlgorithm`` takes the place of ``JaxAlgorithm``: train builds a
model of tensors on the context's device; the persisted form is host numpy,
device-agnostic, and deploy lays it out on the serving device again.
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
