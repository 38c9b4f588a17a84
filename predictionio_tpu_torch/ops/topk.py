"""Serving endings shared by engines: the fused score -> mask -> top-k
ending, the packed [B,2,k] int32 wire, the host ending for host-born
scores and thread-local staging buffers (port of
``predictionio_tpu/ops/topk.py``'s endings: the dot ending, with the
per-item weights of e-commerce's adjust-score variant, and the
gather-sum ending of similar-product and recommended-user).

A result comes back in ONE device-to-host fetch: row 0 carries the float32
score bits, row 1 the indices. The score product is a plain matrix product
(``torch.matmul``), as the JAX package leaves it to XLA outside any Pallas
kernel. Staging buffers are reused per thread, which is sound only because
every upload of a staging buffer copies (``ops.als.upload``).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from predictionio_tpu_torch.ops.als import ServingIndex, next_pow2, upload

__all__ = [
    "dot_top_k_async",
    "gather_sum_top_k_async",
    "fetch_topk",
    "host_top_k",
    "warmup_pow2_buckets",
    "pack_batch",
    "scratch",
    "upload",
    "ScratchBuffers",
    "next_pow2",
]


def pack_batch(scores: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[B,k] scores + [B,k] indices -> packed [B,2,k] int32 (score bits in
    row 0)."""
    return torch.stack(
        [scores.contiguous().view(torch.int32), idx.to(torch.int32)], dim=1
    )


def _mask_weigh_select(scores: torch.Tensor, mask, weights, k: int) -> torch.Tensor:
    """scores [B,n] times ``weights`` [n] (None: unweighted), -inf where
    ``mask`` [B,n] is False (None: nowhere), then top-k, packed."""
    dev = scores.device
    if weights is not None:
        scores = scores * upload(weights, np.float32, dev).to(device=dev, dtype=torch.float32)[None, :]
    if mask is not None:
        scores = torch.where(upload(mask, np.bool_, dev).to(dev), scores, float("-inf"))
    s, i = torch.topk(scores, k, dim=1)
    return pack_batch(s, i)


def dot_top_k_async(table: torch.Tensor, vecs, mask, k: int, weights=None) -> torch.Tensor:
    """Launch (no fetch) scores = vecs @ table.T, times ``weights`` [n] when
    given (the adjust-score variant), masked to -inf where ``mask`` is
    False, then top-k: ``table`` [n,f] resident on its device, ``vecs``
    [B,f] (a device tensor or a host array), ``mask`` [B,n] bool or None.
    Host arrays are uploaded by copy. Returns the packed [B,2,k] device
    tensor; decode with :func:`fetch_topk`."""
    dev = table.device
    scores = upload(vecs, np.float32, dev).to(device=dev, dtype=torch.float32) @ table.T
    return _mask_weigh_select(scores, mask, weights, k)


def gather_sum_top_k_async(table: torch.Tensor, qidx, qweight, mask, k: int,
                           weights=None) -> torch.Tensor:
    """The summed-similarity ending (similar-product, recommended-user):
    gather the query rows ``table[qidx]`` [B,Q,f], weigh them by
    ``qweight`` [B,Q], score every row of ``table`` [n,f] against each and
    sum over Q, times ``weights`` [n] when given, mask [B,n], top-k. Pad
    slots of ``qidx`` point at row 0 with weight 0 (a torch gather raises
    on an out-of-range index where JAX clips). Returns the packed handle."""
    dev = table.device
    qi = upload(qidx, np.int64, dev).to(device=dev, dtype=torch.int64)
    qw = upload(qweight, np.float32, dev).to(device=dev, dtype=torch.float32)
    q = table[qi] * qw[..., None]  # [B, Q, f]
    scores = torch.einsum("nf,bqf->bn", table, q)
    return _mask_weigh_select(scores, mask, weights, k)


def fetch_topk(handle: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """The one device-to-host fetch of the serving path: a packed [B,2,k]
    (or [2,k]) int32 result. Returns ([B,k] float32 scores, [B,k] int32
    indices)."""
    packed = handle.cpu().numpy()
    if packed.ndim == 2:  # single-query [2,k]
        packed = packed[None]
    return ServingIndex.unpack_batch(packed)


def warmup_pow2_buckets(max_batch: int, dispatch) -> None:
    """Shared engine warmup: call ``dispatch(b)`` for b = 1, 2, ...,
    next_pow2(max_batch), then synchronise every card a returned tensor
    lives on, so the first burst after deploy finds each shape launched
    once. ``dispatch`` is the engine's per-bucket serving call."""
    handles = []
    b = 1
    top = next_pow2(max_batch)
    while b <= top:
        handles.append(dispatch(b))
        b *= 2
    for dev in {h.device for h in handles if isinstance(h, torch.Tensor) and h.is_cuda}:
        torch.cuda.synchronize(dev)


def host_top_k(scores: np.ndarray, mask: np.ndarray | None, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Host ending for host-born score vectors (transition probabilities,
    counts: nothing on the device to fuse with). Masked entries and -inf
    scores never surface. Returns (scores_k, idx_k) sorted descending; may
    return fewer than k when the finite pool is smaller."""
    scores = np.asarray(scores, np.float64)
    if mask is not None:
        scores = np.where(mask, scores, -np.inf)
    k = min(int(k), scores.shape[0])
    if k <= 0:
        return np.empty(0), np.empty(0, np.int64)
    idx = np.argpartition(-scores, k - 1)[:k]
    idx = idx[np.argsort(-scores[idx])]
    idx = idx[np.isfinite(scores[idx])]
    return scores[idx], idx


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

    def full(self, name: str, shape: tuple[int, ...], dtype, value) -> np.ndarray:
        view = self.get(name, shape, dtype)
        view[...] = value
        return view


_SCRATCH = threading.local()


def scratch() -> ScratchBuffers:
    """The calling thread's scratch pool."""
    pool = getattr(_SCRATCH, "pool", None)
    if pool is None:
        pool = _SCRATCH.pool = ScratchBuffers()
    return pool
