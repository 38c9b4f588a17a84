"""Property-replay aggregation: fold $set/$unset/$delete event streams into
per-entity PropertyMaps (own copy of ``predictionio_tpu/data/aggregator.py``).

Reference parity: ``data/.../storage/LEventAggregator.scala:41-147`` —
sort by eventTime ascending; ``$set`` merges new keys over old, ``$unset``
removes listed keys, ``$delete`` resets the accumulator; entities whose final
accumulator is empty/None are dropped; firstUpdated/lastUpdated = min/max
eventTime over the three special events only (other events are ignored
entirely). The port's events carry plain-dict properties; they are wrapped
in a ``DataMap`` here.
"""

from __future__ import annotations

import datetime as _dt
from typing import Iterable

from predictionio_tpu_torch.data.datamap import DataMap, PropertyMap
from predictionio_tpu_torch.data.event import SPECIAL_EVENTS, Event


class _Acc:
    __slots__ = ("dm", "first", "last")

    def __init__(self):
        self.dm: DataMap | None = None
        self.first: _dt.datetime | None = None
        self.last: _dt.datetime | None = None

    def fold(self, e: Event) -> None:
        if e.event == "$set":
            props = DataMap(e.properties)
            self.dm = props if self.dm is None else self.dm.union(props)
        elif e.event == "$unset":
            if self.dm is not None:
                self.dm = self.dm.diff(e.properties.keys())
        elif e.event == "$delete":
            self.dm = None
        else:
            return  # non-special events do not touch properties or timestamps
        self.first = e.event_time if self.first is None else min(self.first, e.event_time)
        self.last = e.event_time if self.last is None else max(self.last, e.event_time)

    def result(self) -> PropertyMap | None:
        if self.dm is None:
            return None
        assert self.first is not None and self.last is not None
        return PropertyMap(self.dm.fields, self.first, self.last)


def aggregate_properties(events: Iterable[Event]) -> dict[str, PropertyMap]:
    """Group by entityId, replay in eventTime order, drop deleted entities.
    Entities come out in the order of their first event in ``events``."""
    by_entity: dict[str, list[Event]] = {}
    for e in events:
        if e.event in SPECIAL_EVENTS:
            by_entity.setdefault(e.entity_id, []).append(e)
    out: dict[str, PropertyMap] = {}
    for entity_id, es in by_entity.items():
        acc = _Acc()
        for e in sorted(es, key=lambda e: e.event_time):
            acc.fold(e)
        pm = acc.result()
        if pm is not None:
            out[entity_id] = pm
    return out
