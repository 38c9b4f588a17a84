"""Local-filesystem model blob store.

Reference parity: ``storage/localfs/.../LocalFSModels.scala`` (files named
``pio_model_<id>`` under a base dir) — also subsumes the hdfs and s3 drivers'
role (model blobs only) for single-host deployments.

The port's own copy of ``predictionio_tpu/data/storage/localfs.py``, with a
plain retry loop in place of the JAX package's ``resilience.RetryPolicy``.
"""

from __future__ import annotations

import os
import time
from typing import Callable, TypeVar

from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import Model
from predictionio_tpu_torch.data.storage.registry import default_basedir

T = TypeVar("T")


def _retryable_os_error(exc: BaseException) -> bool:
    """Worth replaying on a network filesystem (NFS/FUSE mounts drop I/O
    under load); a missing file is a result, not a fault."""
    return isinstance(exc, OSError) and not isinstance(exc, FileNotFoundError)


def _with_retries(fn: Callable[[], T], attempts: int, backoff_s: float = 0.05) -> T:
    """Call ``fn``; replay a retryable OSError up to ``attempts`` times in
    all, with exponential backoff between tries."""
    for attempt in range(attempts):
        try:
            return fn()
        except OSError as exc:
            if attempt == attempts - 1 or not _retryable_os_error(exc):
                raise
            time.sleep(backoff_s * (2**attempt))
    raise AssertionError("unreachable")


class LocalFSModels(base.Models):
    def __init__(self, basedir: str, retries: int = 3):
        self._basedir = basedir
        self._attempts = max(1, retries)
        os.makedirs(basedir, exist_ok=True)

    def _path(self, model_id: str) -> str:
        safe = model_id.replace(os.sep, "_")
        return os.path.join(self._basedir, f"pio_model_{safe}")

    def insert(self, model: Model) -> None:
        def once() -> None:
            tmp = self._path(model.id) + ".tmp"
            with open(tmp, "wb") as f:
                f.write(model.models)
            os.replace(tmp, self._path(model.id))

        _with_retries(once, self._attempts)

    def get(self, model_id: str) -> Model | None:
        def once() -> Model | None:
            path = self._path(model_id)
            if not os.path.exists(path):
                return None
            try:
                with open(path, "rb") as f:
                    return Model(model_id, f.read())
            except FileNotFoundError:  # deleted between exists() and open()
                return None

        return _with_retries(once, self._attempts)

    def delete(self, model_id: str) -> None:
        def once() -> None:
            try:
                os.remove(self._path(model_id))
            except FileNotFoundError:
                pass

        _with_retries(once, self._attempts)


class LocalFSStorageClient:
    """Backend entry point (type name: ``localfs``). Config key ``PATH``
    selects the directory."""

    def __init__(self, config: dict | None = None):
        self.config = config or {}
        path = self.config.get("PATH") or self.config.get("path")
        if not path:
            path = os.path.join(default_basedir(), "models")
        retries = int(self.config.get("RETRIES") or self.config.get("retries") or 3)
        self._models = LocalFSModels(path, retries=retries)

    def models(self) -> LocalFSModels:
        return self._models
