"""Dictionary-encoded columnar events, the training feed.

Own copy of ``ColumnarEvents``, ``_remap_vocab`` and ``canonical_order``
from ``predictionio_tpu/data/storage/base.py``. The canonical form sorts
every vocabulary lexicographically and the rows by (timestamp, event id),
so two stores holding the same events give the same integer codes. The
recommendation template's item indices, and so top-k parity with the JAX
package, depend on exactly this encoding.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

from predictionio_tpu_torch.data.event import Event


@dataclasses.dataclass
class ColumnarEvents:
    event_ids: list[str]
    event_names: list[str]  # per-row event name
    entity_ids: np.ndarray  # int32 index into entity_vocab
    target_ids: np.ndarray  # int32 index into target_vocab, -1 when absent
    event_codes: np.ndarray  # int32 index into event_vocab
    timestamps: np.ndarray  # float64 epoch seconds
    ratings: np.ndarray  # float32, properties[rating_key] or nan
    entity_vocab: list[str]
    target_vocab: list[str]
    event_vocab: list[str]

    def __len__(self) -> int:
        return len(self.event_ids)


def _remap_vocab(vocab: list[str], codes: np.ndarray) -> tuple[list[str], np.ndarray]:
    """Sort ``vocab`` lexicographically and rewrite ``codes`` into the sorted
    index space; codes < 0 (absent target) pass through."""
    if not vocab:
        return vocab, codes
    order = np.argsort(np.asarray(vocab, dtype=object))
    inv = np.empty(len(vocab), np.int32)
    inv[order] = np.arange(len(vocab), dtype=np.int32)
    sorted_vocab = [vocab[int(i)] for i in order]
    new_codes = codes.copy()
    present = codes >= 0
    new_codes[present] = inv[codes[present]]
    return sorted_vocab, new_codes


def canonical_order(cols: ColumnarEvents) -> ColumnarEvents:
    """Sorted vocabularies with remapped codes, rows in (timestamp, event
    id) order."""
    ent_vocab, ent_ids = _remap_vocab(cols.entity_vocab, cols.entity_ids)
    tgt_vocab, tgt_ids = _remap_vocab(cols.target_vocab, cols.target_ids)
    ev_vocab, ev_codes = _remap_vocab(cols.event_vocab, cols.event_codes)
    order = np.lexsort((np.asarray(cols.event_ids), cols.timestamps))
    take = order.tolist()
    return ColumnarEvents(
        event_ids=[cols.event_ids[i] for i in take],
        event_names=[cols.event_names[i] for i in take],
        entity_ids=ent_ids[order],
        target_ids=tgt_ids[order],
        event_codes=ev_codes[order],
        timestamps=cols.timestamps[order],
        ratings=cols.ratings[order],
        entity_vocab=ent_vocab,
        target_vocab=tgt_vocab,
        event_vocab=ev_vocab,
    )


def encode(
    events: Iterable[Event],
    event_names: Sequence[str] | None = None,
    entity_type: str | None = None,
    target_entity_type: str | None = None,
    rating_key: str = "rating",
) -> ColumnarEvents:
    """Filter and dictionary-encode events in scan order, then
    canonicalise. A filter left as None keeps every value."""
    names_ok = set(event_names) if event_names is not None else None
    ent_index: dict[str, int] = {}
    tgt_index: dict[str, int] = {}
    ev_index: dict[str, int] = {}
    event_ids: list[str] = []
    names: list[str] = []
    ent_col: list[int] = []
    tgt_col: list[int] = []
    ev_col: list[int] = []
    ts_col: list[float] = []
    rating_col: list[float] = []
    for e in events:
        if names_ok is not None and e.event not in names_ok:
            continue
        if entity_type is not None and e.entity_type != entity_type:
            continue
        if target_entity_type is not None and e.target_entity_type != target_entity_type:
            continue
        event_ids.append(e.event_id or "")
        names.append(e.event)
        ent_col.append(ent_index.setdefault(e.entity_id, len(ent_index)))
        if e.target_entity_id is None:
            tgt_col.append(-1)
        else:
            tgt_col.append(tgt_index.setdefault(e.target_entity_id, len(tgt_index)))
        ev_col.append(ev_index.setdefault(e.event, len(ev_index)))
        ts_col.append(e.event_time.timestamp())
        r = e.properties.get(rating_key)
        rating_col.append(float(r) if isinstance(r, (int, float)) else float("nan"))
    return canonical_order(
        ColumnarEvents(
            event_ids=event_ids,
            event_names=names,
            entity_ids=np.asarray(ent_col, dtype=np.int32),
            target_ids=np.asarray(tgt_col, dtype=np.int32),
            event_codes=np.asarray(ev_col, dtype=np.int32),
            timestamps=np.asarray(ts_col, dtype=np.float64),
            ratings=np.asarray(rating_col, dtype=np.float32),
            entity_vocab=list(ent_index),
            target_vocab=list(tgt_index),
            event_vocab=list(ev_index),
        )
    )
