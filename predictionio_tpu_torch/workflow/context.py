"""WorkflowContext — what DASE components receive (port of
``predictionio_tpu/workflow/context.py``): the run's mode, app addressing,
the storage locator, the run's ``torch.device`` and the rank mesh a
distributed train spreads over (``parallel.mesh``; by default every rank
of the job on one ``data`` axis, one rank without a job).
Templates read events through :meth:`p_event_store` and
:meth:`l_event_store`, exactly where the JAX templates do."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.data.store.event_store import LEventStore, PEventStore
from predictionio_tpu_torch.parallel.mesh import Mesh, local_mesh
from predictionio_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class WorkflowContext:
    mode: str = "training"  # training | serving | evaluation
    app_name: str | None = None
    channel_name: str | None = None
    device: str | torch.device = "cuda"
    _storage: Storage | None = None
    batch: str = ""  # the batch label an evaluation run records
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)
    _mesh: Mesh | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @property
    def storage(self) -> Storage:
        if self._storage is None:
            self._storage = Storage.instance()
        return self._storage

    @property
    def mesh(self) -> Mesh:
        if self._mesh is None:
            self._mesh = local_mesh(self.device)
        return self._mesh

    def p_event_store(self) -> PEventStore:
        return PEventStore(self.storage)

    def l_event_store(self) -> LEventStore:
        return LEventStore(self.storage)
