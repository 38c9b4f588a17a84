"""ANN index lifecycle: registry artifact <-> serving attachment (port of
``predictionio_tpu/ann/lifecycle.py``).

The index is a content-addressed registry artifact with lineage: its blob
lives in the engine's blob store beside the model blobs, and the model
version's manifest records it under ``ann_index`` (sha256 and layout).
Three producers, one consumer:

  - ``pio train`` (``workflow/core_workflow.py``) calls
    :func:`build_for_version` after the registry publish, when a trained
    model has an item-vector table of at least ``min_items`` rows;
  - the stream layer (``stream/pipeline.py``) calls
    :func:`refresh_for_publish` on every candidate publish: the new item
    vectors are assigned to the parent index's centroids, or k-means runs
    again when the drift guard trips. The index rides the candidate
    version, so it bakes with its model;
  - serving (``workflow/create_server.py``) calls
    :func:`attach_from_registry` when it loads a lane from the registry.
    When the manifest pins an index, an :class:`AnnServing` lands on the
    model under ``ann_serving`` and the engines' dispatch consults it. No
    index pinned: the attribute stays unset and scoring stays exact.

Models are recognised by their item-vector table: two-tower
(``item_embeddings``), similar-product's ``SimilarModel``, the sequential
model (its scoring table as ``item_factors``) and the recommendation
template's ``ALSModel`` (``item_factors``), the last so the fold-in
stream trainer refreshes an index end to end.

``PIO_ANN*`` are the JAX package's own variables; the port adds none.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Any

import numpy as np
import torch

from predictionio_tpu_torch.ann.index import (
    AnnConfig,
    AnnFormatError,
    AnnIndex,
    build_index,
    deserialize_index,
    refresh_index,
    serialize_index,
)
from predictionio_tpu_torch.ann.metrics import AnnInstruments
from predictionio_tpu_torch.ann.search import AnnSearcher
from predictionio_tpu_torch.registry.store import ArtifactIntegrityError

logger = logging.getLogger(__name__)

#: the attribute engines consult on their model object
ATTR = "ann_serving"

_RECALL_EWMA = 0.2


def config_from_env() -> AnnConfig:
    """Build knobs from the environment: ``PIO_ANN_MIN_ITEMS`` (corpus
    threshold, default 50000), ``PIO_ANN_CLUSTERS`` / ``PIO_ANN_NPROBE``
    (0 = auto), ``PIO_ANN_INT8`` (quantized score pass). ``PIO_ANN=0``
    turns the build off (:func:`ann_enabled`)."""
    return AnnConfig(
        clusters=int(os.environ.get("PIO_ANN_CLUSTERS", "0") or 0),
        nprobe=int(os.environ.get("PIO_ANN_NPROBE", "0") or 0),
        min_items=int(os.environ.get("PIO_ANN_MIN_ITEMS", "50000")),
        quantize_int8=os.environ.get("PIO_ANN_INT8", "0").lower() in ("1", "true", "yes"),
    )


def ann_enabled() -> bool:
    return os.environ.get("PIO_ANN", "1").lower() not in ("0", "false", "off")


# ---------------------------------------------------------------------------
# model types
# ---------------------------------------------------------------------------


def item_vectors_of(model: Any) -> np.ndarray | None:
    """The model's item-vector table, or None for model types ANN does not
    apply to (cooccurrence, naive Bayes, a Markov-only sequential model)."""
    if hasattr(model, "item_embeddings"):  # two-tower
        table = model.item_embeddings
    elif hasattr(model, "item_factors"):  # SimilarModel, ALSModel, SequentialModel
        table = model.item_factors
    else:
        return None
    return None if table is None else np.asarray(table, np.float32)


def _exact_device_table(model: Any) -> torch.Tensor | None:
    """The engine's resident full-precision table (the int8 rescore gathers
    survivor rows from it)."""
    if hasattr(model, "device_items"):
        return model.device_items()
    if hasattr(model, "device_factors"):
        return model.device_factors()
    if hasattr(model, "serving_index"):
        return model.serving_index().item_factors
    return None


def find_indexable_model(models: list[Any]) -> Any | None:
    for m in models:
        if item_vectors_of(m) is not None:
            return m
    return None


# ---------------------------------------------------------------------------
# serving wrapper
# ---------------------------------------------------------------------------


class AnnServing:
    """One pinned index wired for the dispatch path: the searcher on
    ``device``, the ``pio_ann_*`` instruments and the shadow-exact recall
    sampler. Dispatch threads share one instance; the metrics' own locks
    keep the counters right, and the sampler has its own lock."""

    def __init__(self, index: AnnIndex, model: Any, instruments: AnnInstruments | None = None,
                 recall_sample_every: int | None = None, device: str | torch.device = "cuda"):
        self.index = index
        self.searcher = AnnSearcher(
            index, exact_table=_exact_device_table(model) if index.quantized else None,
            device=device,
        )
        self.instruments = instruments
        # 0 turns the recall shadow off; None = the environment's default
        self._sample_every = (
            recall_sample_every if recall_sample_every is not None
            else int(os.environ.get("PIO_ANN_RECALL_EVERY", "64"))
        )
        self._sample_lock = threading.Lock()
        self._batches = 0
        self._recall_ewma: float | None = None
        if instruments is not None:
            self.bind(instruments)

    def bind(self, instruments: AnnInstruments) -> None:
        self.instruments = instruments
        instruments.set_index(self.index.model_version or "?", self.index.n_items, self.index.clusters)

    # ------------------------------------------------------------- dispatch
    def supports(self, k: int, *, filtered: bool = False) -> bool:
        """False routes the batch to the exact path: a k wider than the
        probe pool, or filters on an int8 index. Pure; a dispatch that
        falls back calls :meth:`count_fallback`, so warmup stays silent."""
        return self.searcher.supports(k) and not (filtered and self.index.quantized)

    def count_fallback(self, rows: int = 1) -> None:
        if self.instruments is not None and rows > 0:
            self.instruments.fallbacks.inc(rows)

    def search_async(self, qvecs, k: int, *, mask=None, exclude=None):
        return self.searcher.search_async(qvecs, k, mask=mask, exclude=exclude)

    def take_recall_sample(self) -> bool:
        """True on every Nth dispatched batch: the caller then also runs its
        exact path and hands both results to :meth:`record_recall`."""
        with self._sample_lock:
            self._batches += 1
            return self._sample_every > 0 and (self._batches - 1) % self._sample_every == 0

    # --------------------------------------------------------------- fetch
    def fetch(self, handle, rows: int):
        """Fetch and account one batch: (scores, idx) shaped like
        ``ops.topk.fetch_topk``. ``rows``: the real (non-pad) batch rows."""
        scores, idx, counts = AnnSearcher.fetch(handle)
        ins = self.instruments
        if ins is not None and rows > 0:
            ins.queries.inc(rows)
            ins.probes.inc(rows * self.searcher.nprobe)
            real = counts[:rows]
            ins.candidates.inc(float(real.sum()))
            if self.index.n_items:
                ins.candidates_frac.set(float(real.mean()) / float(self.index.n_items))
        return scores, idx

    def record_recall(self, ann_idx: np.ndarray, exact_idx: np.ndarray, rows: int) -> float | None:
        """Overlap@k of the ANN and shadow-exact indices over the batch's
        real rows, folded into the EWMA gauge. Returns the batch's recall."""
        rows = min(rows, len(ann_idx), len(exact_idx))
        if rows <= 0:
            return None
        k = min(ann_idx.shape[1], exact_idx.shape[1])
        if k <= 0:
            return None
        hits = sum(
            len(set(map(int, ann_idx[r, :k])) & set(map(int, exact_idx[r, :k]))) for r in range(rows)
        )
        recall = hits / float(rows * k)
        with self._sample_lock:
            if self._recall_ewma is None:
                self._recall_ewma = recall
            else:
                self._recall_ewma += _RECALL_EWMA * (recall - self._recall_ewma)
            value = self._recall_ewma
        if self.instruments is not None:
            self.instruments.recall_samples.inc()
            self.instruments.recall_sampled.set(value)
        return recall

    def warmup(self, max_batch: int, k: int = 10) -> None:
        self.searcher.warmup(max_batch, k)


# ---------------------------------------------------------------------------
# registry lifecycle
# ---------------------------------------------------------------------------


def build_for_version(store: Any, engine_id: str, version: str, models: list[Any],
                      config: AnnConfig | None = None, *, force: bool = False,
                      device: str | torch.device = "cuda") -> dict[str, Any] | None:
    """End-of-train build: when a model in ``models`` has an item table of
    at least ``config.min_items`` rows (or ``force``), build the index
    (assignments on ``device``), write it content-addressed and pin it on
    ``version``'s manifest. Returns the manifest's ``ann_index`` entry, or
    None when no index applies."""
    if not ann_enabled():
        return None
    config = config or config_from_env()
    model = find_indexable_model(models)
    if model is None:
        return None
    vecs = item_vectors_of(model)
    if vecs is None or len(vecs) == 0:
        return None
    if len(vecs) < config.min_items and not force:
        logger.debug("ann: corpus %d below min_items %d; exact serving stays default",
                     len(vecs), config.min_items)
        return None
    index = build_index(vecs, config, model_version=version, built_from="train", device=device)
    manifest = store.attach_ann_index(engine_id, version, serialize_index(index), index.manifest_meta())
    logger.info("ann: built index for %s (%d items, %d clusters, nprobe %d)",
                version, index.n_items, index.clusters, index.nprobe)
    return manifest.ann_index


def refresh_for_publish(store: Any, engine_id: str, parent_version: str, version: str,
                        models: list[Any], instruments: AnnInstruments | None = None,
                        device: str | torch.device = "cuda") -> dict[str, Any] | None:
    """Stream-layer refresh: when the parent (stable) version pins an index
    and the candidate's models carry item vectors, derive the candidate's
    index from the parent's centroids (or rebuild on drift) and pin it on
    the candidate's manifest. Returns the report (``path``, ``drift``), or
    None when the parent pins no index."""
    if not ann_enabled() or not parent_version:
        return None
    loaded = load_index(store, engine_id, parent_version)
    if loaded is None:
        return None
    model = find_indexable_model(models)
    vecs = item_vectors_of(model) if model is not None else None
    if vecs is None or len(vecs) == 0:
        return None
    refreshed, report = refresh_index(loaded, vecs, model_version=version, device=device)
    store.attach_ann_index(engine_id, version, serialize_index(refreshed), refreshed.manifest_meta())
    if instruments is not None:
        (instruments.rebuilds if report["path"] == "rebuild" else instruments.refreshes).inc()
    logger.info("ann: %s index for candidate %s (drift %.3f)",
                report["path"], version, report.get("drift", 0.0))
    return report


def load_index(store: Any, engine_id: str, version: str) -> AnnIndex | None:
    """The verified index artifact pinned on ``version``, or None."""
    loaded = store.load_ann_blob(engine_id, version)
    if loaded is None:
        return None
    blob, _meta = loaded
    return deserialize_index(blob)


def attach_from_registry(store: Any, engine_id: str, version: str, models: list[Any],
                         instruments: AnnInstruments | None = None,
                         device: str | torch.device = "cuda") -> AnnServing | None:
    """Serving-side attach: when ``version``'s manifest pins an index, put
    an :class:`AnnServing` on ``device`` onto the matching model (attribute
    ``ann_serving``). An artifact that fails verification, or covers
    another item count than the model, is logged and rejected: the lane
    serves exact, as in the reference."""
    try:
        index = load_index(store, engine_id, version)
    except (ArtifactIntegrityError, AnnFormatError):
        logger.exception("ann: index artifact for %s unusable; serving exact", version)
        return None
    if index is None:
        return None
    model = find_indexable_model(models)
    if model is None:
        return None
    vecs = item_vectors_of(model)
    if vecs is None or len(vecs) != index.n_items:
        logger.warning("ann: index for %s covers %d items but the model has %d; serving exact",
                       version, index.n_items, 0 if vecs is None else len(vecs))
        return None
    serving = AnnServing(index, model, instruments=instruments, device=device)
    setattr(model, ATTR, serving)
    return serving


def bind_instruments(models: list[Any], instruments: AnnInstruments) -> None:
    """Bind the server's instruments onto any attached AnnServing (the
    attach runs in the lane loader)."""
    for m in models:
        serving = getattr(m, ATTR, None)
        if isinstance(serving, AnnServing):
            serving.bind(instruments)


def pinned_indexes(model_lists: list[list[Any]]) -> dict[str, tuple[float, float]]:
    """version -> (items, clusters) of every index attached to the given
    lanes' models: what the query server feeds
    :meth:`AnnInstruments.sync_indexes` at scrape time."""
    out: dict[str, tuple[float, float]] = {}
    for models in model_lists:
        for m in models or ():
            serving = getattr(m, ATTR, None)
            if isinstance(serving, AnnServing):
                out[serving.index.model_version or "?"] = (
                    float(serving.index.n_items), float(serving.index.clusters),
                )
    return out
