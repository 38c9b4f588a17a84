"""Metadata records and abstract DAO interfaces (the port's own copy of
``predictionio_tpu/data/storage/base.py``).

Reference parity (record shapes verified in SURVEY.md Appendix A):
  - ``App(id, name, description)``                    Apps.scala:31-34
  - ``AccessKey(key, appid, events)``                 AccessKeys.scala:34-49
  - ``Channel(id, name, appid)``                      Channels.scala:31-57
  - ``EngineInstance(...)``                           EngineInstances.scala:44-61
  - ``EvaluationInstance(...)``                       EvaluationInstances.scala:41-54
  - ``Model(id, models)``                             Models.scala:32-80
  - ``LEvents`` row CRUD + filtered find + aggregate  LEvents.scala:40-513
  - ``PEvents`` bulk find/write/delete                PEvents.scala:38-189

The reference's L (local, row-at-a-time, async futures) vs P (parallel,
RDD-valued) DAO split maps here to: ``LEvents`` = synchronous row API (the
event server wraps calls in a thread executor), ``PEvents`` = bulk scan API
returning event iterators plus a columnar export for the device ingest
path. The port's ``Event.properties`` is a plain dict, so the columnar
encoder reads a rating with ``dict.get``.
"""

from __future__ import annotations

import abc
import base64
import dataclasses
import datetime as _dt
import re
import secrets
from typing import Any, Iterable, Iterator, Sequence

import numpy as np

from predictionio_tpu_torch.data.aggregator import (
    aggregate_properties,
    aggregate_properties_single,
)
from predictionio_tpu_torch.data.datamap import PropertyMap
from predictionio_tpu_torch.data.event import SPECIAL_EVENTS, Event

# ---------------------------------------------------------------------------
# Metadata records
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class App:
    id: int
    name: str
    description: str | None = None


@dataclasses.dataclass(frozen=True)
class AccessKey:
    key: str
    appid: int
    events: tuple[str, ...] = ()  # empty = all events allowed


@dataclasses.dataclass(frozen=True)
class Channel:
    id: int
    name: str
    appid: int

    NAME_RE = re.compile(r"^[a-zA-Z0-9-]{1,16}$")

    @staticmethod
    def is_valid_name(name: str) -> bool:
        return bool(Channel.NAME_RE.match(name))


class EngineInstanceStatus:
    INIT = "INIT"
    TRAINING = "TRAINING"
    COMPLETED = "COMPLETED"
    FAILED = "FAILED"


@dataclasses.dataclass
class EngineInstance:
    """One training run (ref EngineInstances.scala:44-61)."""

    id: str
    status: str
    start_time: _dt.datetime
    end_time: _dt.datetime
    engine_id: str
    engine_version: str
    engine_variant: str
    engine_factory: str
    batch: str = ""
    env: dict[str, str] = dataclasses.field(default_factory=dict)
    spark_conf: dict[str, str] = dataclasses.field(default_factory=dict)
    data_source_params: str = "{}"
    preparator_params: str = "{}"
    algorithms_params: str = "[]"
    serving_params: str = "{}"


class EvaluationInstanceStatus:
    INIT = "INIT"
    EVALUATING = "EVALUATING"
    EVALCOMPLETED = "EVALCOMPLETED"


@dataclasses.dataclass
class EvaluationInstance:
    """One evaluation run (ref EvaluationInstances.scala:41-54)."""

    id: str
    status: str
    start_time: _dt.datetime
    end_time: _dt.datetime
    evaluation_class: str = ""
    engine_params_generator_class: str = ""
    batch: str = ""
    env: dict[str, str] = dataclasses.field(default_factory=dict)
    spark_conf: dict[str, str] = dataclasses.field(default_factory=dict)
    evaluator_results: str = ""
    evaluator_results_html: str = ""
    evaluator_results_json: str = ""


@dataclasses.dataclass
class Model:
    """Serialized model blob keyed by engine-instance id (ref Models.scala:32)."""

    id: str
    models: bytes

    def to_json_dict(self) -> dict[str, Any]:
        return {"id": self.id, "models": base64.b64encode(self.models).decode()}


def generate_access_key() -> str:
    """48 random bytes, base64 url-safe, no padding (ref AccessKeys.scala:44-49).

    A key must never START with ``-``: every CLI that takes a key as a
    positional (``pio accesskey delete <key>``) would parse it as a flag.
    The url-safe alphabet includes ``-`` (~1.6% of keys would hit it), so
    regenerate until the first character is safe — a uniformity loss of one
    character class on one position, not a security-relevant bias.
    """
    while True:
        key = base64.urlsafe_b64encode(secrets.token_bytes(48)).decode().rstrip("=")
        if not key.startswith("-"):
            return key


# ---------------------------------------------------------------------------
# Metadata DAO interfaces
# ---------------------------------------------------------------------------


class Apps(abc.ABC):
    @abc.abstractmethod
    def insert(self, app: App) -> int | None:
        """Insert; auto-generate id when app.id == 0. Returns the id, or
        None when the id or name is already taken (names are unique,
        ref Apps.scala)."""

    @abc.abstractmethod
    def get(self, app_id: int) -> App | None: ...

    @abc.abstractmethod
    def get_by_name(self, name: str) -> App | None: ...

    @abc.abstractmethod
    def get_all(self) -> list[App]: ...

    @abc.abstractmethod
    def update(self, app: App) -> None:
        """Update in place. Renaming to a name held by a different app is a
        contract violation: drivers raise (name uniqueness must hold)."""

    @abc.abstractmethod
    def delete(self, app_id: int) -> None: ...


class AccessKeys(abc.ABC):
    @abc.abstractmethod
    def insert(self, k: AccessKey) -> str | None:
        """Insert; auto-generate key when blank. Returns the key."""

    @abc.abstractmethod
    def get(self, key: str) -> AccessKey | None: ...

    @abc.abstractmethod
    def get_all(self) -> list[AccessKey]: ...

    @abc.abstractmethod
    def get_by_app_id(self, app_id: int) -> list[AccessKey]: ...

    @abc.abstractmethod
    def update(self, k: AccessKey) -> None: ...

    @abc.abstractmethod
    def delete(self, key: str) -> None: ...


class Channels(abc.ABC):
    @abc.abstractmethod
    def insert(self, channel: Channel) -> int | None:
        """Insert; auto-generate id when 0; reject invalid names."""

    @abc.abstractmethod
    def get(self, channel_id: int) -> Channel | None: ...

    @abc.abstractmethod
    def get_by_app_id(self, app_id: int) -> list[Channel]: ...

    @abc.abstractmethod
    def delete(self, channel_id: int) -> None: ...


class EngineInstances(abc.ABC):
    @abc.abstractmethod
    def insert(self, instance: EngineInstance) -> str:
        """Insert; auto-generate id when blank. Returns the id."""

    @abc.abstractmethod
    def get(self, instance_id: str) -> EngineInstance | None: ...

    @abc.abstractmethod
    def get_all(self) -> list[EngineInstance]: ...

    @abc.abstractmethod
    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> EngineInstance | None:
        """Most recent COMPLETED instance for the tuple — drives deploy
        (ref EngineInstances.scala getLatestCompleted)."""

    @abc.abstractmethod
    def get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> list[EngineInstance]: ...

    @abc.abstractmethod
    def update(self, instance: EngineInstance) -> None: ...

    @abc.abstractmethod
    def delete(self, instance_id: str) -> None: ...


class EvaluationInstances(abc.ABC):
    @abc.abstractmethod
    def insert(self, instance: EvaluationInstance) -> str: ...

    @abc.abstractmethod
    def get(self, instance_id: str) -> EvaluationInstance | None: ...

    @abc.abstractmethod
    def get_all(self) -> list[EvaluationInstance]: ...

    @abc.abstractmethod
    def get_completed(self) -> list[EvaluationInstance]:
        """EVALCOMPLETED instances, newest first (drives the dashboard)."""

    @abc.abstractmethod
    def update(self, instance: EvaluationInstance) -> None: ...

    @abc.abstractmethod
    def delete(self, instance_id: str) -> None: ...


class Models(abc.ABC):
    @abc.abstractmethod
    def insert(self, model: Model) -> None: ...

    @abc.abstractmethod
    def get(self, model_id: str) -> Model | None: ...

    @abc.abstractmethod
    def delete(self, model_id: str) -> None: ...


# ---------------------------------------------------------------------------
# Event DAOs
# ---------------------------------------------------------------------------


def event_seq_key(e: Event) -> tuple[int, str]:
    """The event store's total ORDERING CONTRACT for tailing reads.

    Events order by ``(creation_time micros, event_id)`` — creation time
    (when the store accepted the row, not the client-supplied event time)
    with the event id as the tiebreak. Two events accepted in the same
    microsecond therefore still have ONE total order on every backend, so
    a resumed tail (``find_after``) can neither skip nor double-read
    either of them. Backends with a native sequence (SQL creationTime
    column + id) implement the same order server-side.
    """
    return (int(e.creation_time.timestamp() * 1_000_000), e.event_id or "")


def check_tail_limit(limit: int) -> int:
    """``find_after`` requires an explicit non-negative bound on EVERY
    backend — ``find``'s "negative = no cap" convention must not leak in,
    or the same call would return everything on the scan backends and
    ``LIMIT 0`` (nothing, forever) on SQL."""
    if limit is None or int(limit) < 0:
        raise ValueError(f"find_after requires a non-negative limit, got {limit!r}")
    return int(limit)


def scan_find_after(
    events: "Iterable[Event]",
    cursor: tuple[int, str] | None,
    limit: int,
) -> list[Event]:
    """Shared scan-based ``find_after``: filter strictly past the cursor,
    sort by :func:`event_seq_key`, cap at ``limit``. O(table) — backends
    with an index override ``find_after`` instead of calling this."""
    limit = check_tail_limit(limit)
    keyed = [
        (key, e)
        for e in events
        for key in (event_seq_key(e),)
        if cursor is None or key > (int(cursor[0]), str(cursor[1]))
    ]
    keyed.sort(key=lambda p: p[0])
    return [e for _, e in keyed[:limit]]


class LEvents(abc.ABC):
    """Row-level event CRUD with the reference's filter surface
    (ref LEvents.scala futureFind :188-200 — 9 filter dimensions + limit +
    reversed)."""

    @abc.abstractmethod
    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        """Initialize storage for an app/channel (ref init)."""

    @abc.abstractmethod
    def remove(self, app_id: int, channel_id: int | None = None) -> bool:
        """Drop all events for an app/channel (ref remove)."""

    @abc.abstractmethod
    def close(self) -> None: ...

    @abc.abstractmethod
    def insert(self, event: Event, app_id: int, channel_id: int | None = None) -> str:
        """Insert one event, returning its id."""

    def insert_batch(
        self, events: Sequence[Event], app_id: int, channel_id: int | None = None
    ) -> list[str]:
        return [self.insert(e, app_id, channel_id) for e in events]

    @abc.abstractmethod
    def get(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> Event | None: ...

    @abc.abstractmethod
    def delete(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> bool: ...

    @abc.abstractmethod
    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        entity_type: str | None = None,
        entity_id: str | None = None,
        event_names: Sequence[str] | None = None,
        target_entity_type: str | None | type(...) = ...,
        target_entity_id: str | None | type(...) = ...,
        limit: int | None = None,
        reversed: bool = False,
    ) -> Iterator[Event]:
        """Filtered scan ordered by eventTime asc (desc when reversed).

        ``target_entity_type``/``target_entity_id`` are tri-state like the
        reference's Option[Option[String]]: ``...`` (ellipsis) = no filter,
        ``None`` = must be absent, a string = must equal. ``limit=None`` means
        no cap; the reference treats limit=-1 the same way.
        """

    def find_after(
        self,
        app_id: int,
        channel_id: int | None = None,
        cursor: tuple[int, str] | None = None,
        limit: int = 100,
    ) -> list[Event]:
        """Ordered tail read for the speed layer: up to ``limit`` events
        strictly after ``cursor`` in :func:`event_seq_key` order
        (``(creation_time micros, event_id)`` — the documented tiebreak).

        The cursor is EXCLUSIVE (the event at the cursor position is
        already consumed); ``None`` starts from the beginning. ``limit``
        must be non-negative on every backend (``find``'s negative
        no-cap convention does not apply — see :func:`check_tail_limit`).
        This generic implementation is an O(table) scan + sort; the
        sql/sqlite drivers override it with an indexed range read.
        Callers on the stream path must always pass an explicit ``limit``.
        """
        return scan_find_after(
            self.find(app_id=app_id, channel_id=channel_id), cursor, limit
        )

    def seq_head(
        self, app_id: int, channel_id: int | None = None
    ) -> tuple[int, str] | None:
        """The store's current tail-order head — max :func:`event_seq_key`
        over the app's events, ``None`` when empty. Seeds a fresh stream
        cursor ("start from now"). One O(table) scan here; the sql/sqlite
        drivers answer from the ``(creationTime, id)`` index."""
        return max(
            (event_seq_key(e) for e in self.find(app_id=app_id, channel_id=channel_id)),
            default=None,
        )

    def aggregate_properties(
        self,
        app_id: int,
        channel_id: int | None = None,
        entity_type: str = "",
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        required: Sequence[str] | None = None,
    ) -> dict[str, PropertyMap]:
        """Replay $set/$unset/$delete into per-entity PropertyMaps
        (ref futureAggregateProperties, LEvents.scala:393-428)."""
        events = self.find(
            app_id=app_id,
            channel_id=channel_id,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            event_names=sorted(SPECIAL_EVENTS),
        )
        result = aggregate_properties(events)
        if required:
            req = set(required)
            result = {
                k: v for k, v in result.items() if req.issubset(v.keyset())
            }
        return result

    def aggregate_properties_of_entity(
        self,
        app_id: int,
        entity_type: str,
        entity_id: str,
        channel_id: int | None = None,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
    ) -> PropertyMap | None:
        events = self.find(
            app_id=app_id,
            channel_id=channel_id,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            entity_id=entity_id,
            event_names=sorted(SPECIAL_EVENTS),
        )
        return aggregate_properties_single(events)


@dataclasses.dataclass
class ColumnarEvents:
    """Dictionary-encoded column block for device ingest.

    Replaces the reference's RDD partition feed (JdbcRDD / TableInputFormat /
    EsInputFormat in the L3 drivers): entity/target/event strings are
    dictionary-encoded to dense int32 ids so the training path can go straight
    to device gathers, and ratings/weights ride in a float32 column.
    """

    event_ids: list[str]
    event_names: list[str]  # per-row event name (small vocab)
    entity_ids: np.ndarray  # int32 index into entity_vocab
    target_ids: np.ndarray  # int32 index into target_vocab, -1 when absent
    event_codes: np.ndarray  # int32 index into event_vocab
    timestamps: np.ndarray  # float64 epoch seconds
    ratings: np.ndarray  # float32, value of properties[rating_key] or nan
    entity_vocab: list[str]
    target_vocab: list[str]
    event_vocab: list[str]

    def __len__(self) -> int:
        return len(self.event_ids)


def _remap_vocab(
    vocab: list[str], codes: np.ndarray
) -> tuple[list[str], np.ndarray]:
    """Sort ``vocab`` lexicographically and rewrite integer ``codes`` into the
    sorted index space. Codes < 0 (absent target) pass through unchanged."""
    if not vocab:
        return vocab, codes
    order = np.argsort(np.asarray(vocab, dtype=object))
    inv = np.empty(len(vocab), np.int32)
    inv[order] = np.arange(len(vocab), dtype=np.int32)
    sorted_vocab = [vocab[int(i)] for i in order]
    if np.array_equal(inv, np.arange(len(vocab), dtype=np.int32)):
        return sorted_vocab, codes
    new_codes = codes.copy()
    present = codes >= 0
    new_codes[present] = inv[codes[present]]
    return sorted_vocab, new_codes


def _rows_canonical(event_ids: list[str], timestamps: np.ndarray) -> bool:
    """True iff rows are already in (timestamp, event_id) lexsort order.

    O(n) timestamp diff; event-id string comparisons only at timestamp
    ties (vectorized when bulk imports make ties pervasive)."""
    if len(timestamps) < 2:
        return True
    d = np.diff(timestamps)
    if np.any(d < 0):
        return False
    ties = np.flatnonzero(d == 0)
    if len(ties) == 0:
        return True
    if len(ties) > 1024:  # one object-array build beats a python loop
        ev = np.asarray(event_ids, dtype=object)
        return bool(np.all(ev[ties] <= ev[ties + 1]))
    return all(event_ids[int(i)] <= event_ids[int(i) + 1] for i in ties)


def canonical_order(
    cols: "ColumnarEvents",
    frozen_entity_vocab: bool = False,
    frozen_target_vocab: bool = False,
) -> "ColumnarEvents":
    """Reorder rows to the canonical (timestamp, event_id) order AND
    canonicalize the dictionary encoding (sorted vocabs, remapped codes).

    Drivers with parallel bulk scans (ES sliced scroll, SQL time-range
    partitions) merge their streams in nondeterministic order, which
    affects two things consumers depend on: the ROW order (the multi-host
    block partition must be disjoint and jointly complete across hosts,
    and exports must be reproducible run-to-run) and the VOCAB order
    (``to_columnar`` dictionary-encodes in scan-encounter order, so two
    hosts that each build the columnar independently would otherwise
    assign different integer codes to the same entity and silently mix
    entities when their blocks are combined). Canonicalizing both makes
    the result scan-order-independent. Each frozen flag skips the remap
    for THAT vocab only — a caller-supplied vocab is already a canonical
    index space (eval splits encoded with the training split's space must
    keep it), but the other, scan-encounter-ordered vocabs still need the
    remap; the event vocab can never be frozen and is always
    canonicalized."""
    n = len(cols)
    ent_vocab, ent_ids = cols.entity_vocab, cols.entity_ids
    tgt_vocab, tgt_ids = cols.target_vocab, cols.target_ids
    if not frozen_entity_vocab:
        ent_vocab, ent_ids = _remap_vocab(ent_vocab, ent_ids)
    if not frozen_target_vocab:
        tgt_vocab, tgt_ids = _remap_vocab(tgt_vocab, tgt_ids)
    ev_vocab, ev_codes = _remap_vocab(cols.event_vocab, cols.event_codes)
    # O(n) already-sorted precheck before the O(n log n) lexsort: the
    # common consumer chain canonicalizes twice (driver to_columnar, then
    # the snapshot cache on the same result), and the second pass must be
    # cheap. Rows are canonical iff timestamps are nondecreasing and
    # event_ids are nondecreasing within equal timestamps.
    if _rows_canonical(cols.event_ids, cols.timestamps):
        if ent_ids is cols.entity_ids and tgt_ids is cols.target_ids and (
            ev_codes is cols.event_codes
        ):
            return cols
        return dataclasses.replace(
            cols,
            entity_ids=ent_ids,
            target_ids=tgt_ids,
            event_codes=ev_codes,
            entity_vocab=ent_vocab,
            target_vocab=tgt_vocab,
            event_vocab=ev_vocab,
        )
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


def merge_parallel_scans(iterators: Sequence[Iterator[Event]]) -> Iterator[Event]:
    """Merge N scan iterators through a bounded queue, one thread per
    iterator. Yields in nondeterministic order (bulk consumers — columnar
    encode, aggregation — are order-free; the snapshot cache canonicalizes
    row order AND dictionary encoding afterward). Shared by the drivers with
    a parallel bulk path: ES sliced scroll, SQL time-range partitions.

    Failure/early-exit contract: a worker exception is re-raised to the
    consumer; when the consumer goes away every pump thread is unblocked and
    each source iterator's ``close()`` runs (releasing scroll contexts /
    database connections)."""
    import queue as _q
    import threading

    if len(iterators) == 1:
        yield from iterators[0]
        return
    out: _q.Queue = _q.Queue(maxsize=10_000)
    stop = threading.Event()  # set when the consumer goes away
    _DONE = object()

    def put_until_stopped(item) -> bool:
        while not stop.is_set():
            try:
                out.put(item, timeout=0.2)
                return True
            except _q.Full:
                continue
        return False

    def pump(it):
        try:
            try:
                for e in it:
                    if not put_until_stopped(e):
                        break
            except BaseException as exc:  # surface worker failures to consumer
                put_until_stopped(exc)
            # closing the source generator runs its finally blocks, releasing
            # per-scan resources (scroll context, connection). A close()
            # failure — or a plain iterator without close() — must neither
            # kill the thread nor swallow the _DONE handoff below, or the
            # consumer blocks forever on out.get().
            try:
                close = getattr(it, "close", None)
                if close is not None:
                    close()
            except BaseException as exc:
                put_until_stopped(exc)
        finally:
            put_until_stopped(_DONE)

    threads = [
        threading.Thread(target=pump, args=(s,), daemon=True) for s in iterators
    ]
    for t in threads:
        t.start()
    live = len(threads)
    try:
        while live:
            item = out.get()
            if item is _DONE:
                live -= 1
            elif isinstance(item, BaseException):
                raise item
            else:
                yield item
    finally:
        # consumer finished, broke out early, or a scan failed: unblock
        # every pump (they exit without putting once stop is set) so no
        # thread is left parked on a full queue holding Events
        stop.set()
        for t in threads:
            t.join(timeout=5.0)


class PEvents(abc.ABC):
    """Bulk scan API (ref PEvents.scala:38-189). ``find`` streams events;
    ``to_columnar`` is the training feed."""

    @abc.abstractmethod
    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        entity_type: str | None = None,
        entity_id: str | None = None,
        event_names: Sequence[str] | None = None,
        target_entity_type: str | None | type(...) = ...,
        target_entity_id: str | None | type(...) = ...,
    ) -> Iterator[Event]: ...

    @abc.abstractmethod
    def write(
        self, events: Iterable[Event], app_id: int, channel_id: int | None = None
    ) -> None: ...

    @abc.abstractmethod
    def delete(
        self, event_ids: Iterable[str], app_id: int, channel_id: int | None = None
    ) -> None: ...

    def version_stamp(self, app_id: int, channel_id: int | None = None) -> str | None:
        """Cheap content stamp of this app/channel's events, used by the
        columnar snapshot cache (``data/store/snapshot.py``) for invalidation.
        Any write must change the stamp. ``None`` (the default) means the
        backend cannot stamp cheaply and snapshots will not be persisted.
        """
        return None

    def store_identity(self) -> str | None:
        """Stable identifier of the underlying store (db path, connection,
        instance nonce) — part of the snapshot signature so two stores
        sharing one snapshot root never garbage-collect or alias each
        other's snapshots. Stable across writes; distinct across stores."""
        return None

    def aggregate_properties(
        self,
        app_id: int,
        channel_id: int | None = None,
        entity_type: str = "",
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        required: Sequence[str] | None = None,
    ) -> dict[str, PropertyMap]:
        events = self.find(
            app_id=app_id,
            channel_id=channel_id,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            event_names=sorted(SPECIAL_EVENTS),
        )
        result = aggregate_properties(events)
        if required:
            req = set(required)
            result = {k: v for k, v in result.items() if req.issubset(v.keyset())}
        return result

    def extract_entity_map(
        self,
        app_id: int,
        entity_type: str,
        channel_id: int | None = None,
    ) -> dict[str, PropertyMap]:
        """ref PEvents.extractEntityMap — properties per entity of a type."""
        return self.aggregate_properties(
            app_id=app_id, channel_id=channel_id, entity_type=entity_type
        )

    def to_columnar(
        self,
        app_id: int,
        channel_id: int | None = None,
        event_names: Sequence[str] | None = None,
        rating_key: str = "rating",
        entity_vocab: Sequence[str] | None = None,
        target_vocab: Sequence[str] | None = None,
        events: "Iterable[Event] | None" = None,
        **find_kwargs: Any,
    ) -> ColumnarEvents:
        """Scan once and dictionary-encode into dense arrays.

        Pass pre-built ``entity_vocab``/``target_vocab`` to encode an eval
        split with the training split's index space (unknown ids get -1).
        ``events`` overrides the scan source — drivers with a parallel bulk
        path (ES sliced scroll) feed their merged stream through here so
        the encoder stays shared.
        """
        ent_index: dict[str, int] = (
            {v: i for i, v in enumerate(entity_vocab)} if entity_vocab else {}
        )
        tgt_index: dict[str, int] = (
            {v: i for i, v in enumerate(target_vocab)} if target_vocab else {}
        )
        frozen_ent = entity_vocab is not None
        frozen_tgt = target_vocab is not None
        ev_index: dict[str, int] = {}
        event_ids: list[str] = []
        names: list[str] = []
        ent_col: list[int] = []
        tgt_col: list[int] = []
        ev_col: list[int] = []
        ts_col: list[float] = []
        rating_col: list[float] = []
        if events is None:
            events = self.find(
                app_id=app_id,
                channel_id=channel_id,
                event_names=event_names,
                **find_kwargs,
            )
        for e in events:
            event_ids.append(e.event_id or "")
            names.append(e.event)
            if frozen_ent:
                ent_col.append(ent_index.get(e.entity_id, -1))
            else:
                ent_col.append(ent_index.setdefault(e.entity_id, len(ent_index)))
            if e.target_entity_id is None:
                tgt_col.append(-1)
            elif frozen_tgt:
                tgt_col.append(tgt_index.get(e.target_entity_id, -1))
            else:
                tgt_col.append(tgt_index.setdefault(e.target_entity_id, len(tgt_index)))
            ev_col.append(ev_index.setdefault(e.event, len(ev_index)))
            ts_col.append(e.event_time.timestamp())
            r = e.properties.get(rating_key)
            rating_col.append(float(r) if isinstance(r, (int, float)) else float("nan"))
        return ColumnarEvents(
            event_ids=event_ids,
            event_names=names,
            entity_ids=np.asarray(ent_col, dtype=np.int32),
            target_ids=np.asarray(tgt_col, dtype=np.int32),
            event_codes=np.asarray(ev_col, dtype=np.int32),
            timestamps=np.asarray(ts_col, dtype=np.float64),
            ratings=np.asarray(rating_col, dtype=np.float32),
            entity_vocab=list(entity_vocab) if frozen_ent else list(ent_index),
            target_vocab=list(target_vocab) if frozen_tgt else list(tgt_index),
            event_vocab=list(ev_index),
        )
