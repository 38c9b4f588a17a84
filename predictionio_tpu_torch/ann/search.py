"""Two-stage IVF-MIPS search on the index's device (port of
``predictionio_tpu/ann/search.py``).

Stage 1: ``q @ centroidsᵀ`` -> top-``nprobe`` clusters (one [B, C]
product; C is hundreds, not the corpus). Stage 2: gather each probed
bucket as one contiguous ``cap·f`` slab of the flattened [C, cap·f] table,
score the [B, P·cap, f] candidates with one batched product, mask pads
(and exclusions or filters) to ``-inf`` and end in ``torch.topk``, packed
in the shared serving wire (``ops.topk.pack_batch``: [B, 2, k] int32,
score bits in row 0). The fetch stays O(batch·k).

The JAX package compiles these four searches with XLA (``_kernels``,
jnp code, no Pallas); here they are plain torch ops (``index_select``,
``bmm``, ``torch.topk``). The index tables are resident on the card and
never written; every host upload copies (``ops.als.upload``), since the
engines stage queries in reused buffers. The [B, P·cap, f] slab is the
largest transient tensor: the engines pad B to a power of two, so its
size takes one value per batch bucket, as the reference's programs do.

Each search returns two device tensors, the packed top-k and a [B] int32
count of real (non-pad) candidates scored, fetched together by
:meth:`AnnSearcher.fetch`; the count feeds ``pio_ann_candidates_*``.
"""

from __future__ import annotations

import numpy as np
import torch

from predictionio_tpu_torch.ann.index import AnnIndex
from predictionio_tpu_torch.ops import topk
from predictionio_tpu_torch.ops.als import ServingIndex, upload
from predictionio_tpu_torch.utils.device import resolve_device

__all__ = ["AnnSearcher"]

NEG_INF = float("-inf")


def _stage1(centroids: torch.Tensor, q: torch.Tensor, nprobe: int) -> torch.Tensor:
    """[B, nprobe] ids of the clusters nearest each query by inner product."""
    return torch.topk(q @ centroids.T, nprobe, dim=1).indices


def _gather(flat: torch.Tensor, probe: torch.Tensor, b: int) -> torch.Tensor:
    """Rows ``probe`` [B, P] of a [C, W] table as [B, P·W]: one slab per
    probed bucket."""
    return flat.index_select(0, probe.reshape(-1)).reshape(b, -1)


def _flat_candidates(bucket_flat, bucket_ids, q, probe):
    b, f = q.shape
    vecs = _gather(bucket_flat, probe, b).reshape(b, -1, f)  # [B, P·cap, f]
    ids = _gather(bucket_ids, probe, b)  # [B, P·cap]
    scores = torch.bmm(vecs, q[:, :, None])[:, :, 0]
    return scores, ids


def _counts(ids: torch.Tensor) -> torch.Tensor:
    return (ids >= 0).sum(dim=1).to(torch.int32)


def _excluded(ids: torch.Tensor, excl: torch.Tensor) -> torch.Tensor:
    """[B, P·cap] True where a candidate's id is in its row of ``excl``
    [B, E] (-1 pads match no candidate that is kept)."""
    return (ids[:, :, None] == excl[:, None, :]).any(dim=2)


def _select(flat_s, flat_i, k: int):
    s, pos = torch.topk(flat_s, k, dim=1)
    return topk.pack_batch(s, torch.gather(flat_i, 1, pos)), _counts(flat_i)


def search(centroids, bucket_flat, bucket_ids, q, nprobe: int, k: int):
    probe = _stage1(centroids, q, nprobe)
    flat_s, flat_i = _flat_candidates(bucket_flat, bucket_ids, q, probe)
    return _select(torch.where(flat_i >= 0, flat_s, NEG_INF), flat_i, k)


def search_excl(centroids, bucket_flat, bucket_ids, q, excl, nprobe: int, k: int):
    """``excl`` [B, E] int32 item ids never returned (a query's own items),
    padded with -1."""
    probe = _stage1(centroids, q, nprobe)
    flat_s, flat_i = _flat_candidates(bucket_flat, bucket_ids, q, probe)
    keep = (flat_i >= 0) & ~_excluded(flat_i, excl)
    return _select(torch.where(keep, flat_s, NEG_INF), flat_i, k)


def search_masked(centroids, bucket_flat, bucket_ids, q, mask, nprobe: int, k: int):
    """``mask`` [B, n] bool over the whole corpus (the engines' candidate
    masks); each candidate reads its own bit. Pad ids gather row 0's bit
    and are masked anyway: a torch gather raises on -1 where JAX clips."""
    probe = _stage1(centroids, q, nprobe)
    flat_s, flat_i = _flat_candidates(bucket_flat, bucket_ids, q, probe)
    ok = torch.gather(mask, 1, flat_i.clamp(min=0).long())
    return _select(torch.where((flat_i >= 0) & ok, flat_s, NEG_INF), flat_i, k)


def search_q8(centroids, bucket_q8_flat, bucket_scale, bucket_ids, exact_table, q, excl,
              nprobe: int, k: int, pool: int):
    """int8 score pass, then the exact f32 rescore of the ``pool``
    survivors gathered from ``exact_table`` [n, f], the engine's resident
    table. The per-item scale multiplies the score, not the vectors;
    ``excl`` works as in :func:`search_excl`."""
    probe = _stage1(centroids, q, nprobe)
    b, f = q.shape
    vq = _gather(bucket_q8_flat, probe, b).reshape(b, -1, f).to(torch.float32)
    flat_i = _gather(bucket_ids, probe, b)
    scale = _gather(bucket_scale, probe, b)
    flat_s = torch.bmm(vq, q[:, :, None])[:, :, 0] * scale
    flat_s = torch.where((flat_i >= 0) & ~_excluded(flat_i, excl), flat_s, NEG_INF)
    ps, pos = torch.topk(flat_s, pool, dim=1)
    cand = torch.gather(flat_i, 1, pos)  # [B, pool]
    cvec = exact_table[cand.clamp(min=0).long()]  # [B, pool, f]
    es = torch.bmm(cvec, q[:, :, None])[:, :, 0]
    es = torch.where((cand >= 0) & torch.isfinite(ps), es, NEG_INF)
    s, p2 = torch.topk(es, k, dim=1)
    return topk.pack_batch(s, torch.gather(cand, 1, p2)), _counts(flat_i)


class AnnSearcher:
    """The index tables resident on ``device`` and the two-stage search.

    ``exact_table`` (the engine's resident [n, f] table) is needed by the
    int8 rescore and ignored otherwise."""

    def __init__(self, index: AnnIndex, exact_table: torch.Tensor | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        dev = self.device
        self.index = index
        self._centroids = torch.tensor(index.centroids, dtype=torch.float32, device=dev)
        self._bucket_ids = torch.tensor(index.bucket_ids, dtype=torch.int32, device=dev)
        # flattened [C, cap·f]: stage 2 gathers one contiguous slab per
        # probed cluster
        self._bucket_flat = torch.tensor(index.bucket_vecs.reshape(index.clusters, -1), device=dev)
        self._bucket_scale = (
            torch.tensor(index.bucket_scale, dtype=torch.float32, device=dev)
            if index.bucket_scale is not None else None
        )
        if index.bucket_scale is not None and exact_table is None:
            raise ValueError(
                "an int8-quantized index needs the engine's exact f32 table for survivor rescoring"
            )
        self._exact_table = exact_table.to(dev) if exact_table is not None else None

    @property
    def n_items(self) -> int:
        return self.index.n_items

    @property
    def nprobe(self) -> int:
        return self.index.nprobe

    def candidate_pool(self, nprobe: int | None = None) -> int:
        """Upper bound of candidates one query scores (pads included)."""
        return (nprobe or self.nprobe) * self.index.bucket_cap

    def supports(self, k: int, nprobe: int | None = None) -> bool:
        """Can this index answer top-``k``? The pool must be at least k
        wide; callers fall back to exact scoring when it is not."""
        return 0 < k <= self.candidate_pool(nprobe)

    def search_async(self, qvecs, k: int, *, mask=None, exclude=None, nprobe: int | None = None):
        """Launch (no fetch). ``qvecs`` [B, f], a host array (copied up) or
        a device tensor (the two-tower user embedding, composed without a
        host round-trip). At most one of ``mask`` ([B, n] bool) and
        ``exclude`` ([B, E] int32, -1 padded). Returns the (packed
        [B, 2, k], counts [B]) pair of device tensors."""
        dev = self.device
        nprobe = min(nprobe or self.nprobe, self.index.clusters)
        q = upload(qvecs, np.float32, dev).to(device=dev, dtype=torch.float32)
        if self._bucket_scale is not None:
            if mask is not None:
                raise ValueError(
                    "mask filtering is unsupported on the int8 path; route filtered "
                    "queries to the exact fallback (AnnServing.supports(filtered=True) says so)"
                )
            pool = min(max(k, self.index.config.rescore * k), self.candidate_pool(nprobe))
            excl = (
                upload(exclude, np.int32, dev).to(dev)
                if exclude is not None
                else torch.full((q.shape[0], 1), -1, dtype=torch.int32, device=dev)
            )
            return search_q8(self._centroids, self._bucket_flat, self._bucket_scale,
                             self._bucket_ids, self._exact_table, q, excl, nprobe, k, pool)
        if mask is not None:
            return search_masked(self._centroids, self._bucket_flat, self._bucket_ids, q,
                                 upload(mask, np.bool_, dev).to(dev), nprobe, k)
        if exclude is not None:
            return search_excl(self._centroids, self._bucket_flat, self._bucket_ids, q,
                               upload(exclude, np.int32, dev).to(dev), nprobe, k)
        return search(self._centroids, self._bucket_flat, self._bucket_ids, q, nprobe, k)

    @staticmethod
    def fetch(handle) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The one fetch of an ANN search: the packed [B, 2, k] top-k and
        the [B] candidate counts. Returns (scores, item indices, counts)."""
        packed, counts = handle
        # pio-lint: disable=serving-host-roundtrip -- k-only packed fetch + [B] counts, the ANN wire contract
        scores, idx = ServingIndex.unpack_batch(packed.cpu().numpy())
        return scores, idx, counts.cpu().numpy()  # pio-lint: disable=serving-host-roundtrip -- the [B] counts of the same wire contract

    def warmup(self, max_batch: int, k: int) -> None:
        """One search per power-of-two batch bucket, so the first burst
        after deploy finds every shape launched once."""
        kk = min(topk.next_pow2(k), self.candidate_pool())
        dim = self.index.dim
        topk.warmup_pow2_buckets(
            max_batch, lambda b: self.search_async(np.zeros((b, dim), np.float32), kk)[0]
        )
