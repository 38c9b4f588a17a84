"""WorkflowContext — what DASE components receive (port of
``predictionio_tpu/workflow/context.py``): the run's mode, app addressing,
the store, and a ``torch.device`` in place of the JAX mesh."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from predictionio_tpu_torch.data.store import LocalStore
from predictionio_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class WorkflowContext:
    mode: str = "training"  # training | serving
    app_name: str | None = None
    device: str | torch.device = "cuda"
    store: LocalStore | None = None
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.store is None:
            self.store = LocalStore()
