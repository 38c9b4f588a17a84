"""Batch views over the event store (deprecated API surface kept for parity).

Reference parity: ``data/src/main/scala/org/apache/predictionio/data/view/``
— ``DataView.scala`` (cached DataFrame of converted events), ``LBatchView.scala``
(``EventSeq`` filter/aggregate helpers, deprecated since 0.9.2 in favour of
``LEvents``/``LEventStore``) and ``PBatchView.scala`` (RDD flavour of the
same).

The columnar rendering of ``DataView.create`` is a *columnar* cache: the
conversion function maps each ``Event`` to a flat record (tuple/dataclass/
dict); the records are transposed into dense numpy columns and cached as an
``.npz`` under ``$PIO_FS_BASEDIR/view`` keyed by a content hash of
(time window, version, schema) — the same invalidation contract as the
reference's MurmurHash-named parquet file (``DataView.scala:83-104``). A
cache hit never touches the row store; columns feed ``torch.from_numpy``
directly.

The port's own copy of ``predictionio_tpu/data/view.py``, on the port's
``Event`` (whose properties are a plain dict) and ``DataMap``. The cache
lives under the port's own home (``registry.default_basedir``).
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import hashlib
import json
import os
import re
import warnings
from typing import Any, Callable, Iterable, Mapping, Sequence

import numpy as np

from predictionio_tpu_torch.data.datamap import DataMap

# cache filename tails: <marker><sha1-16>.npz — anchored so one view's
# prune can never touch another view whose name extends this one's prefix
_VIEW_STAMPED_RE = re.compile(r"stamp-[0-9a-f]{16}\.npz")
_VIEW_LEGACY_RE = re.compile(r"[0-9a-f]{16}\.npz")
from predictionio_tpu_torch.data.event import Event

UTC = _dt.timezone.utc

_DEPRECATION = (
    "the batch-view API is deprecated (ref LBatchView.scala @deprecated "
    "0.9.2); use LEventStore / PEventStore instead"
)


# ---------------------------------------------------------------------------
# EventSeq — LBatchView.scala:25-180 (filter + ordered aggregation helpers)
# ---------------------------------------------------------------------------


class EventSeq:
    """A list of events with the deprecated filter/aggregate helpers
    (ref ``LBatchView.scala`` ``EventSeq`` / ``ViewPredicates`` /
    ``ViewAggregators``)."""

    def __init__(self, events: Iterable[Event]):
        warnings.warn(_DEPRECATION, DeprecationWarning, stacklevel=2)
        self.events: list[Event] = list(events)

    def __iter__(self):
        return iter(self.events)

    def __len__(self) -> int:
        return len(self.events)

    def filter(
        self,
        event: str | None = None,
        entity_type: str | None = None,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
    ) -> "EventSeq":
        """Predicate filter; note the reference's start-time predicate is
        *strictly after* start (``LBatchView.scala`` ``getStartTimePredicate``
        excludes equality), unlike LEvents' inclusive ``startTime``."""
        out = self.events
        if event is not None:
            out = [e for e in out if e.event == event]
        if entity_type is not None:
            out = [e for e in out if e.entity_type == entity_type]
        if start_time is not None:
            out = [e for e in out if e.event_time > start_time]
        if until_time is not None:
            out = [e for e in out if e.event_time < until_time]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            return EventSeq(out)

    def aggregate_by_entity_ordered(
        self,
        init: Any,
        op: Callable[[Any, Event], Any],
        predicate: Callable[[Event], bool] | None = None,
    ) -> dict[str, Any]:
        """Group by entity_id, sort each group by event_time ascending, fold
        ``op`` from ``init`` (ref ``LBatchView.scala``
        ``aggregateByEntityOrdered``)."""
        groups: dict[str, list[Event]] = {}
        for e in self.events:
            if predicate is None or predicate(e):
                groups.setdefault(e.entity_id, []).append(e)
        return {
            eid: _fold(sorted(es, key=lambda e: e.event_time), init, op)
            for eid, es in groups.items()
        }


def _fold(events: Sequence[Event], init: Any, op: Callable[[Any, Event], Any]):
    acc = init
    for e in events:
        acc = op(acc, e)
    return acc


def datamap_aggregator() -> Callable[[DataMap | None, Event], DataMap | None]:
    """The $set/$unset/$delete fold used by the deprecated views
    (ref ``ViewAggregators.getDataMapAggregator``). Prefer
    ``data.aggregator`` for the full PropertyMap replay."""

    def agg(acc: DataMap | None, e: Event) -> DataMap | None:
        if e.event == "$set":
            props = DataMap(e.properties)
            return props if acc is None else acc.union(props)
        if e.event == "$unset":
            return None if acc is None else acc.diff(e.properties.keys())
        if e.event == "$delete":
            return None
        return acc

    return agg


# ---------------------------------------------------------------------------
# DataView — DataView.scala:41-113 (cached converted-event table)
# ---------------------------------------------------------------------------


def _record_to_dict(rec: Any) -> Mapping[str, Any]:
    if dataclasses.is_dataclass(rec) and not isinstance(rec, type):
        return dataclasses.asdict(rec)
    if isinstance(rec, Mapping):
        return rec
    if hasattr(rec, "_asdict"):  # namedtuple
        return rec._asdict()
    if isinstance(rec, (tuple, list)):
        return {f"c{i}": v for i, v in enumerate(rec)}
    raise TypeError(
        f"conversion function must return a dataclass/dict/namedtuple/tuple, got {type(rec)!r}"
    )


def _columnarise(dicts: list[Mapping[str, Any]]) -> dict[str, np.ndarray]:
    if not dicts:
        return {}
    cols: dict[str, list[Any]] = {k: [] for k in dicts[0]}
    for d in dicts:
        if d.keys() != cols.keys():
            raise ValueError("conversion function returned inconsistent fields")
        for k, v in d.items():
            cols[k].append(v)
    out: dict[str, np.ndarray] = {}
    for k, vs in cols.items():
        arr = np.asarray(vs)
        if arr.dtype == object:  # mixed / string-ish -> unicode
            arr = np.asarray([str(v) for v in vs])
        out[k] = arr
    return out


def create(
    app_name: str,
    conversion_function: Callable[[Event], Any | None],
    channel_name: str | None = None,
    start_time: _dt.datetime | None = None,
    until_time: _dt.datetime | None = None,
    name: str = "",
    version: str = "",
    base_dir: str | None = None,
    storage=None,
) -> dict[str, np.ndarray]:
    """Columnar view of ``conversion_function`` applied to an app's events,
    cached under ``<base_dir>/view`` (ref ``DataView.create``,
    ``DataView.scala:41-113``). Events mapped to ``None`` are dropped.

    Cache key: (window, version, conversion-function qualname) — the
    reference keys on (window, version, case-class serialVersionUID), i.e. an
    identity of the conversion output that does not require scanning. Bump
    ``version`` whenever the conversion function's *logic* changes.
    """
    from predictionio_tpu_torch.data.storage.registry import default_basedir
    from predictionio_tpu_torch.data.store.event_store import PEventStore, resolve_app

    base = base_dir or default_basedir()
    begin = start_time or _dt.datetime(1970, 1, 1, tzinfo=UTC)

    store = PEventStore(storage)
    stamp_keyed = until_time is None
    cacheable = True
    if stamp_keyed:
        # "everything so far": key on the store's VERSION STAMP, not
        # wall-clock "now" — a now-keyed digest can never hit, so every
        # call rescanned the row store and left another npz behind
        app_id, channel_id = resolve_app(
            store._storage, app_name, channel_name
        )
        stamp = store._storage.get_p_events().version_stamp(app_id, channel_id)
        # a backend that cannot stamp cheaply returns None (base-class
        # default); keying on the constant 'stamp:None' would serve the
        # first npz forever while events accumulate — mirror snapshot.py
        # and bypass the cache instead
        cacheable = stamp is not None
        end_key = f"stamp:{stamp}"
    else:
        end_key = str(until_time)

    fn_uid = getattr(conversion_function, "__module__", "") + "." + getattr(
        conversion_function, "__qualname__", repr(conversion_function)
    )
    key_blob = json.dumps(
        [str(begin), end_key, version, fn_uid, channel_name], sort_keys=True
    ).encode()
    digest = hashlib.sha1(key_blob).hexdigest()[:16]
    view_dir = os.path.join(base, "view")
    os.makedirs(view_dir, exist_ok=True)
    prefix = f"{name or 'view'}-{app_name}-"
    # stamp-keyed entries carry a marker so the prune below can tell them
    # apart from explicit-until_time entries ("t-"), which are immutable
    # and valid forever (pruning those thrashed workloads alternating >4
    # windows); marking BOTH kinds lets pre-marker legacy files — which
    # can never be hit again under this naming — be swept instead of
    # orphaned
    marker = "stamp-" if stamp_keyed else "t-"
    path = os.path.join(view_dir, f"{prefix}{marker}{digest}.npz")

    if cacheable and os.path.exists(path):
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}

    converted = []
    for e in store.find(
        app_name,
        channel_name=channel_name,
        start_time=start_time,
        until_time=until_time,
    ):
        rec = conversion_function(e)
        if rec is not None:
            converted.append(_record_to_dict(rec))

    cols = _columnarise(converted)
    if not cacheable:
        return cols
    tmp = path + ".tmp.npz"
    np.savez(tmp[:-4], **cols)
    os.replace(tmp, path)
    # bound the cache: only STAMP-keyed digests go stale as events arrive;
    # keep the newest few per (name, app) and drop the rest.
    # Explicit-until_time entries (no marker) are immutable and stay. Stat
    # per-file under try: a concurrent create() (multi-host workers share
    # the dir) may unlink an entry between listdir and the stat — that must
    # not fail a build whose own output was already written successfully.
    # Only files whose tail is EXACTLY <marker><16-hex digest>.npz belong
    # to this (name, app): plain startswith(prefix) also matched other
    # views whose name/app merely extends this prefix ('als-prod-' is a
    # string prefix of 'als-prod-eu-...'), and the legacy sweep would have
    # deleted their valid files.
    aged: list[tuple[float, str]] = []
    for f in os.listdir(view_dir):
        if not (f.startswith(prefix) and f.endswith(".npz")):
            continue
        rest = f[len(prefix):]
        p = os.path.join(view_dir, f)
        if _VIEW_STAMPED_RE.fullmatch(rest):
            try:
                aged.append((os.path.getmtime(p), p))
            except OSError:
                continue  # already gone
        elif _VIEW_LEGACY_RE.fullmatch(rest):
            # pre-marker legacy entry: unreachable under the marker naming
            # (never hit again), so delete rather than orphan
            try:
                os.unlink(p)
            except OSError:
                pass
        # anything else (incl. explicit-window "t-" entries and other
        # views' files) is left untouched
    for _, old in sorted(aged, reverse=True)[4:]:
        try:
            os.unlink(old)
        except OSError:
            pass
    return cols
