"""Serving endings shared by engines: the packed [B,2,k] int32 wire and
thread-local staging buffers (port of the parts of
``predictionio_tpu/ops/topk.py`` the ALS path uses).

A result comes back in ONE device-to-host fetch: row 0 carries the float32
score bits, row 1 the indices. Staging buffers are reused per thread, which
is sound only because every upload of a staging buffer copies
(``ops.als.upload``).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from predictionio_tpu_torch.ops.als import ServingIndex, next_pow2, upload

__all__ = ["fetch_topk", "pack_batch", "scratch", "upload", "ScratchBuffers", "next_pow2"]


def pack_batch(scores: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[B,k] scores + [B,k] indices -> packed [B,2,k] int32 (score bits in
    row 0)."""
    return torch.stack(
        [scores.contiguous().view(torch.int32), idx.to(torch.int32)], dim=1
    )


def fetch_topk(handle: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """The one device-to-host fetch of the serving path: a packed [B,2,k]
    (or [2,k]) int32 result. Returns ([B,k] float32 scores, [B,k] int32
    indices)."""
    packed = handle.cpu().numpy()
    if packed.ndim == 2:  # single-query [2,k]
        packed = packed[None]
    return ServingIndex.unpack_batch(packed)


class ScratchBuffers:
    """Reusable host staging buffers for batch assembly.

    ``get(name, shape, dtype)`` returns a preallocated array, growing a
    named slot geometrically (pow2 per axis); the caller owns the buffer
    until its next ``get`` of the same name. Not thread-safe by design: use
    :func:`scratch` for the thread-local pool.
    """

    def __init__(self):
        self._bufs: dict[str, np.ndarray] = {}

    def get(self, name: str, shape: tuple[int, ...], dtype) -> np.ndarray:
        dtype = np.dtype(dtype)
        buf = self._bufs.get(name)
        if buf is None or buf.dtype != dtype or any(
            have < want for have, want in zip(buf.shape, shape)
        ) or buf.ndim != len(shape):
            alloc = tuple(max(1, next_pow2(s)) for s in shape)
            if buf is not None and buf.dtype == dtype and buf.ndim == len(shape):
                alloc = tuple(max(a, have) for a, have in zip(alloc, buf.shape))
            buf = np.empty(alloc, dtype)
            self._bufs[name] = buf
        return buf[tuple(slice(0, s) for s in shape)]

    def zeros(self, name: str, shape: tuple[int, ...], dtype) -> np.ndarray:
        view = self.get(name, shape, dtype)
        view[...] = 0
        return view


_SCRATCH = threading.local()


def scratch() -> ScratchBuffers:
    """The calling thread's scratch pool."""
    pool = getattr(_SCRATCH, "pool", None)
    if pool is None:
        pool = _SCRATCH.pool = ScratchBuffers()
    return pool
