"""Host columns to each rank's rows (port of ``predictionio_tpu/parallel/ingest.py``).

The host reads a columnar block once and pads it (static shapes). In the
JAX package a multi-process job hands each process's LOCAL rows to
``make_array_from_process_local_data`` after agreeing on one per-process
padded length; here a rank is a process, so each keeps its own rows,
padded at the tail to the length every rank on the axis agrees on (an
all-gather of the local counts: uneven counts would otherwise give the
ranks different shapes and corrupt the first collective).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from predictionio_tpu_torch.parallel.collectives import all_gather
from predictionio_tpu_torch.parallel.mesh import Mesh


def pad_to_multiple(
    x: np.ndarray, multiple: int, pad_value: Any = 0
) -> tuple[np.ndarray, int]:
    """Pad axis 0 to a multiple; returns (padded, original_length)."""
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad_width = [(0, rem)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad_width, constant_values=pad_value), n


def shard_columns(
    mesh: Mesh,
    columns: dict[str, np.ndarray],
    *,
    axis: str = "data",
    pad_values: dict[str, Any] | None = None,
    mask_name: str | None = None,
) -> tuple[dict[str, torch.Tensor], int]:
    """This rank's equal-length host columns as tensors on its device, each
    padded at the tail to the longest rank's count on ``axis`` (at least
    one row). ``mask_name`` adds a boolean validity column under that key.
    Returns ``(tensors, local_row_count)``."""
    pad_values = pad_values or {}
    lengths = {col.shape[0] for col in columns.values()}
    if len(lengths) > 1:
        raise ValueError("all columns must have the same length")
    n_local = lengths.pop() if lengths else 0
    counts = all_gather(torch.tensor([n_local], dtype=torch.int64, device=mesh.device), mesh, axis)
    per_len = max(int(counts.max()), 1)
    out: dict[str, torch.Tensor] = {}
    for name, col in columns.items():
        pad_width = [(0, per_len - col.shape[0])] + [(0, 0)] * (col.ndim - 1)
        padded = np.pad(col, pad_width, constant_values=pad_values.get(name, 0))
        out[name] = torch.tensor(padded, device=mesh.device)
    if mask_name is not None:
        mask = np.zeros((per_len,), bool)
        mask[:n_local] = True
        out[mask_name] = torch.tensor(mask, device=mesh.device)
    return out, int(n_local)
